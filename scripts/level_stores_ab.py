"""Kernels 4 and 5's stores on the card: streaming (the default build of
``csrc/levels.cu``) against write-back (a second build with
``-DPLLMOD_LEVEL_STREAM_STORES=0``), each kernel over every level of the
flagship and protein cells of ``chip_smoke.py``, in turns (default,
write-back, write-back, default), every run held bit for bit against the
default build's buffers. Prints device ms a launch (the least of two
``chip_smoke.device_ms``, mean over a cell's levels) and the card's name
and power limit.

    python3 scripts/level_stores_ab.py
"""
from __future__ import annotations

import contextlib
import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from pllmod_tpu_torch import flagship  # noqa: E402
from pllmod_tpu_torch.ops import _build, engine, fused, levels  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("level_stores_ab: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    print(cs.gpu_line())
    writeback = _build.entry_points(_build.build(
        ("levels",), ("PLLMOD_LEVEL_STREAM_STORES=0",)))
    _build.load()
    out = {}
    for label, spec in (("flagship DNA", cs.FLAGSHIP),
                        ("protein", cs.PROTEIN)):
        part, tree = flagship.example(**spec, device="cuda")
        part = part.cache_eigen()
        lvls, offsets, _, ns = engine.compile_schedule(part, tree)
        idx, e1, e2 = levels.level_tables(part, lvls)
        P = part.prob_matrices(torch.as_tensor(
            tree.lengths, dtype=torch.float32, device="cuda"))
        P1, P2 = P[e1], P[e2]
        tc, tab = part.tip_states, fused.code_table(part)
        sl = [slice(o, o + len(lv)) for lv, o in zip(lvls, offsets)]
        clvs, sc = levels.update_partials_pallas(part, P, lvls, offsets, ns)
        want = (clvs.clone(), sc.clone())
        lefts = [levels.child_pass(idx[s], 0, clvs, sc, tc, tab, P1[s])
                 for s in sl]

        def k4():
            for s, (left, s1) in zip(sl, lefts):
                levels.child2_pass(idx[s], clvs, sc, tc, tab, P2[s], left,
                                   s1, s.start)

        def k5():
            for s in sl:
                levels.level_update_combined(clvs, sc, idx[s], tc, tab,
                                             P1[s], P2[s], s.start)
        out[label] = {}
        for name, fn in (("child2_pass", k4), ("level_combined", k5)):
            got = {"streaming": [], "write-back": []}
            for wb in (False, True, True, False):
                with (_build.using(writeback) if wb
                      else contextlib.nullcontext()):
                    clvs.fill_(float("nan"))
                    sc.fill_(-999)
                    fn()
                    if not (torch.equal(clvs, want[0])
                            and torch.equal(sc, want[1])):
                        raise AssertionError(f"{name} ({label}) differs "
                                             "from the default build")
                    got["write-back" if wb else "streaming"].append(
                        cs.least_device_ms(fn, 10) / len(sl))
            out[label][name] = got
            print(f"{name} ({label}): streaming {got['streaming']}, "
                  f"write-back {got['write-back']} ms a launch")
    print(json.dumps({"level_stores": out}))
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
