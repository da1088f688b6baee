"""The readings that the limits of a cell are set from: the program's
numbers over many seeds and the control's (the reference in TF32, put in
the program's place) over some of them, in one process on the card.

    python3 phylobench/calibrate.py --workload <name> --seeds 1,2,3 \
        --control-seeds 3 --control-requests 3 --seconds 3 --out <file>

Each seed sets the cell up, runs a short window at the cell's own load,
judges a sample of its requests as a run does, then puts the control's
answers to the same requests through the same judge. One JSON line a
seed goes to standard output and to ``--out``. With ``--problems N``, a
mix whose problems are a fixed set (``problem_seeds``) draws N problems
of its own from each seed instead, so that the seeds read different
data.
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control-requests", type=int, default=3)
    ap.add_argument("--problems", type=int, default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path.insert(0, ROOT)
    import torch

    from phylobench import harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(args.device)
    bench = harness.Bench(args.root)
    out = open(args.out, "a") if args.out else None
    for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        traffic = bench.traffic(bench.workload(args.workload)["traffic"])
        if args.problems:
            traffic["problem_seeds"] = [seed * 1000 + j
                                        for j in range(args.problems)]
        c = harness.setup(bench, args.workload, seed, dev, traffic)
        row = {"workload": args.workload, "seed": seed,
               "setup_s": time.perf_counter() - t}
        records, row["window_s"], _ = harness.window(c, args.seconds, False,
                                                     dev)
        row["attempted"] = len(records)
        row["failed"] = sum("failed" in r for r in records)
        harness.release(c, dev)
        t = time.perf_counter()
        row["program"] = harness.judge(c, records, seed)
        row["judge_s"] = time.perf_counter() - t
        if n < args.control_seeds:
            ok = [r for r in records if "failed" not in r]
            picked = [ok[j] for j in harness.sample(
                len(ok), int(c.checks["check_requests"]), seed)][
                    :args.control_requests]
            t = time.perf_counter()
            ctl = [dict(r, answer=c.kind.control(c.traffic, c.driver,
                                                 r)) for r in picked]
            row["control_s"] = time.perf_counter() - t
            row["control"] = c.kind.judge(c.traffic, c.driver, ctl)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        del c, records
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
