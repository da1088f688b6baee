"""The benchmark's ``aa144`` configuration (the 1KITE insect amino-acid
supermatrix, 144 taxa × 413,459 sites under LG+Γ4) on the CPU: its model
is the port's LG, a cut of it built through the benchmark's text loader
agrees with the benchmark's float64 reference and the TF32 control does
not, ``auto`` takes at its full shape the walk that the card measured
faster, and a 20-state evaluation records its spans.

Imports ``phylobench`` from the repository root and nothing of the JAX
package."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from phylobench.loaders import text
from phylobench.model import random_binary_tree
from phylobench.reference import Reference, rel_gap
from pllmod_tpu_torch import profile
from pllmod_tpu_torch.ops import _build, charmap, engine, resident
from pllmod_tpu_torch.tree.topology import Tree
from pllmod_tpu_torch.utils import aa_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "phylobench", "configs", "aa144.json")) as f:
    CONFIG = json.load(f)
# the cut: the configuration's model on 12 taxa × 300 sites
CUT = dict(CONFIG, n_taxa=12, n_sites=300)
SEEDS = (1, 2, 3)
# float32 rounding at the cut's size: the logL (about −5,000) is a float32
# number, half an ulp of it 5e-8 of its size, and each of its ~250
# pattern terms and 10 rescaled CLV rows adds its own rounding; the
# program read 0.8e-8 to 4.7e-8 on these seeds, the TF32 control 7.6e-7
# to 5.8e-6
LNL_RTOL = 2e-7
# the walk that both walks forced at the supermatrix's shape, in turns,
# measured faster on the H100 (chip_smoke.py supermatrix_turns; PERF.md)
SUPERMATRIX_FASTER = "resident"
# the text loader's codes at 20 states: the gap and the 20 amino acids
AA_CODES = 21


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut_cells():
    """The cut built through the text loader, one cell a seed."""
    return {seed: text.build(CUT, seed, "cpu") for seed in SEEDS}


def _lengths(cell):
    return torch.as_tensor(cell.lengths, dtype=torch.float32)


def test_config_rates_are_lg():
    want = np.asarray(aa_data.LG_RATES, np.float64)
    got = np.asarray(CONFIG["model"]["subst_rates"], np.float64)
    assert got.shape == (190,)
    np.testing.assert_array_equal(got, want)


def test_config_freqs_are_lg():
    np.testing.assert_array_equal(
        np.asarray(CONFIG["model"]["freqs"], np.float64), aa_data.LG_FREQS)


def test_config_alphabet_is_the_port_order():
    assert CONFIG["alphabet"] == charmap.AA_ORDER
    assert CONFIG["states"] == 20 == len(charmap.AA_ORDER)
    assert (CONFIG["n_taxa"], CONFIG["n_sites"]) == (144, 413_459)


@pytest.mark.parametrize("seed", SEEDS)
def test_cut_matches_the_reference(cut_cells, seed):
    """``compile_fast_eval(..., "auto")`` on the loader's partition
    against the benchmark's float64 reference on the same tree, tips and
    lengths."""
    cell = cut_cells[seed]
    assert cell.part.states == 20 and cell.part.n_cats == 4
    assert cell.part.code_clv.shape[0] == AA_CODES
    ev = engine.compile_fast_eval(cell.part, cell.tree, schedule="auto")
    got = float(ev(cell.part, _lengths(cell)))
    want = Reference(cell.rooted, cell.model, cell.tips).loglik(
        _lengths(cell))
    assert rel_gap(got, want) <= LNL_RTOL, (got, want)


def test_tf32_control_exceeds_the_tolerance(cut_cells):
    """The reference in TF32, the precision below the configuration's
    float32, misses LNL_RTOL on at least one seed of the cut."""
    gaps = []
    for seed in SEEDS:
        cell = cut_cells[seed]
        brl = _lengths(cell)
        want = Reference(cell.rooted, cell.model, cell.tips).loglik(brl)
        ctl = Reference(cell.rooted, cell.model, cell.tips,
                        dtype=torch.float32, tf32=True).loglik(brl)
        gaps.append(rel_gap(ctl, want))
    assert max(gaps) > LNL_RTOL, gaps


@pytest.mark.parametrize("seed", [1, 2, 3, 7, 2**31 + 11])
def test_auto_at_the_supermatrix_shape(seed):
    """``fast_eval_schedule`` at 144 × 413,459 (413,568 padded patterns),
    20 states +Γ4, on the configuration's tree drawn from ``seed`` (its
    own live slots), computed from ``_build`` without a card: the walk
    measured faster there, of the split kind."""
    n = CONFIG["n_taxa"]
    edges, lengths = random_binary_tree(
        np.random.default_rng(seed), n, CONFIG["tree"]["min_len"],
        CONFIG["tree"]["max_len"])
    tree = Tree(n, [f"t{i}" for i in range(n)], edges, lengths,
                n_nodes=2 * n - 2)
    part = SimpleNamespace(
        n_tips=n, device="cpu", n_cats=CONFIG["model"]["rate_cats"],
        states=CONFIG["states"], code_clv=torch.zeros(AA_CODES, 20),
        dtype=torch.float32,
        n_patterns_padded=-(-CONFIG["n_sites"] // 128) * 128)
    n_slots = resident.compile_resident(part, tree)[3]
    T = _build.resident_tile(4, 20, AA_CODES, n_slots,
                             part.n_patterns_padded)
    assert _build.resident_config(4, 20, AA_CODES, n_slots, T)["kind"] \
        == "split"
    assert engine.fast_eval_schedule(part, n_slots) == SUPERMATRIX_FASTER
    assert engine.auto_schedule(part, n_slots) == SUPERMATRIX_FASTER


def test_protein_evaluation_records_its_spans(cut_cells, tmp_path):
    """At 20 states, under ``profile.trace``, one CPU evaluation records
    ``pllmod.eval`` with its ``.walk`` child, and launches nothing."""
    cell = cut_cells[SEEDS[0]]
    ev = engine.compile_fast_eval(cell.part, cell.tree)
    profile.reset()
    try:
        with profile.trace(str(tmp_path)):
            float(ev(cell.part, _lengths(cell)))
        spans = profile.SPANS
        names = [s.name for s in spans]
        assert names.count("pllmod.eval") == 1
        walk = [s for s in spans if s.name == "pllmod.eval.walk"]
        assert len(walk) == 1
        assert spans[walk[0].parent].name == "pllmod.eval"
        got = profile.summary()
        assert got["pllmod.eval"]["count"] == 1
        assert all(row["launches"] == 0 for row in got.values())
    finally:
        profile.reset()


@pytest.mark.parametrize("schedule", ["resident", "fused"])
def test_both_walks_agree_on_the_cut(cut_cells, schedule):
    """The two walks that ``auto`` chooses between, forced, give the cut's
    logL within LNL_RTOL of the float64 reference at 20 states."""
    cell = cut_cells[SEEDS[1]]
    ev = engine.compile_fast_eval(cell.part, cell.tree, schedule=schedule)
    got = float(ev(cell.part, _lengths(cell)))
    want = Reference(cell.rooted, cell.model, cell.tips).loglik(
        _lengths(cell))
    assert rel_gap(got, want) <= LNL_RTOL, (schedule, got, want)
