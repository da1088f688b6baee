"""The benchmark's arithmetic against hand counts and brute force."""

import itertools

import numpy as np
import pytest
import torch

from phylobench import devtrace, roofline
from phylobench.model import Rooted, build_q, gamma_rates, random_binary_tree
from phylobench.reference import Reference, edge_colors, round_tf32


def test_union_of_overlapping_intervals():
    iv = [(5, 6), (0, 2), (1, 3), (2.5, 2.7), (3, 4), (7, 8), (7.5, 7.6)]
    assert devtrace.union(iv) == [(0, 4), (5, 6), (7, 8)]
    busy = devtrace.union(devtrace.clip(iv, 1, 7.5))
    assert busy == [(1, 4), (5, 6), (7, 7.5)]
    assert devtrace.gaps(busy, 0.5, 9) == [(0.5, 1), (4, 5), (6, 7), (7.5, 9)]
    s = devtrace.reduce([("k", a, b) for a, b in iv], [], 0, 10, 2)
    assert s["busy_s"] == pytest.approx(4 + 1 + 1)
    assert s["window_s"] == 10
    # each operation's own time, overlaps and all
    assert s["breakdown"]["device_ops"] == [["k", pytest.approx(7.3)]]
    assert s["breakdown"]["idle_gaps"][0][1] == pytest.approx(4)


def test_gaps_named_by_host_activity():
    cpu = [("phylobench.eval.call", 0, 3), ("aten::mm", 0.5, 1.5),
           ("cudaLaunchKernel", 1.0, 1.2), ("phylobench.eval.readback", 3, 9),
           ("cudaMemcpyAsync", 3.1, 8.9)]
    names = devtrace.host_activity(cpu, [1.1, 2.0, 5.0, 9.5])
    assert names == ["phylobench.eval.call / cudaLaunchKernel",
                     "phylobench.eval.call",
                     "phylobench.eval.readback / cudaMemcpyAsync",
                     "host outside any traced operation"]


def five_taxon_shape():
    return dict(n_tips=5, n_patterns=100, C=4, S=4, n_codes=5)


def test_roofline_counts_by_hand():
    # ((t0,t1),t2,(t3,t4)): 3 inner CLVs; rooted at the middle node both
    # other inner nodes have two tips (a lookup each), the root has one
    # tip and two inner children: 2 = n − 3 inner P·x products
    C, S, P = 4, 4, 100
    per_pattern = 2 * (2 * C * S * S)           # the inner children
    per_pattern += 4 * 3 * C * S                # 3 CLVs + the root row
    per_pattern += C * S                        # π at the root
    tables = 5 * 5 * 2 * C * S * S              # 5 tip edges × 5 codes
    assert roofline.eval_flops(5, P, C, S, 5) == P * per_pattern + tables
    # bytes: characters, weights, P matrices of 7 edges, the logL
    assert roofline.eval_bytes(5, P, C, S) == 5 * P + 4 * P + 4 * 7 * 64 + 4
    assert roofline.clv_updates(five_taxon_shape()) == 3 * P


def test_roofline_bound_at_the_capacity_cell():
    shape = dict(n_tips=10_000, n_patterns=100_000, C=4, S=4, n_codes=5)
    least, by = roofline.eval_least_s(shape)
    assert by == "operations"
    # PERF.md's bound of kernel 1 at capacity: 2.629 ms (padded patterns)
    assert least * 1e3 == pytest.approx(2.629 * 100_000 / 100_096, rel=2e-3)


def test_clv_updates_metric_counts_completed_evaluations():
    from phylobench.harness import Run, load_module
    import os
    mod = load_module(os.path.join(os.path.dirname(roofline.__file__),
                                   "metrics", "clv_updates_per_s.py"))
    recs = [{"latency_s": 0.01}] * 7 + [{"failed": "x"}]
    run = Run("eval", five_taxon_shape(), 1.0, 2.0, recs)
    assert mod.read(run) == 3 * 100 * 7 / 2.0
    assert mod.read(Run("blo", five_taxon_shape(), 1.0, 2.0, recs)) is None


def brute_force_lnl(edges, lengths, states, model):
    """Σ_sites log Σ_c w_c Σ over every inner assignment of π_root Π_edges
    P(parent → child), rooted at node n_tips."""
    n = states.shape[0]
    r = Rooted(edges, n)
    Q = build_q(model["subst_rates"], model["freqs"]).numpy()
    pi = model["freqs"]
    S = len(pi)
    inner = list(range(n, r.n_nodes))
    total = 0.0
    for site in range(states.shape[1]):
        like = 0.0
        for rate, w in zip(model["rate_cats"], model["rate_weights"]):
            P = [torch.linalg.matrix_exp(torch.as_tensor(Q * t * rate))
                 .numpy() for t in lengths]
            for assign in itertools.product(range(S), repeat=len(inner)):
                x = dict(zip(inner, assign))
                x.update({i: int(states[i, site]) for i in range(n)})
                p = pi[x[r.root]]
                for v in range(r.n_nodes):
                    if v != r.root:
                        p *= P[r.pedge[v]][x[r.parent[v]], x[v]]
                like += w * p
        total += np.log(like)
    return total


def small_case(n_tips, n_sites, seed, S=4):
    rng = np.random.default_rng(seed)
    edges, lengths = random_binary_tree(rng, n_tips, 0.05, 0.5)
    m = dict(subst_rates=rng.uniform(0.5, 2.0, S * (S - 1) // 2),
             freqs=rng.dirichlet([5] * S), rate_cats=gamma_rates(0.7, 4),
             rate_weights=np.full(4, 0.25), alpha=0.7)
    states = rng.integers(0, S, (n_tips, n_sites)).astype(np.uint8)
    return edges, lengths, m, states


def test_reference_against_brute_force_on_four_taxa():
    edges, lengths, m, states = small_case(4, 7, 3)
    ref = Reference(Rooted(edges, 4), m, torch.as_tensor(states))
    assert ref.loglik(lengths) == pytest.approx(
        brute_force_lnl(edges, lengths, states, m), rel=1e-12)


def test_gamma_rates_mean_one_and_scipy():
    from scipy.special import gammainc, gammaincinv
    r = gamma_rates(0.9, 4)
    b = gammaincinv(0.9, np.arange(1, 4) / 4)
    want = 4 * np.diff(np.concatenate([[0], gammainc(1.9, b), [1]]))
    np.testing.assert_allclose(r, want, rtol=1e-12)
    assert r.mean() == pytest.approx(1.0, rel=1e-14)


def test_edge_sums_give_the_logl_and_the_optimum_is_flat():
    edges, lengths, m, states = small_case(9, 60, 4, S=20)
    rooted = Rooted(edges, 9)
    ref = Reference(rooted, m, torch.as_tensor(states))
    want = ref.loglik(lengths)
    t = torch.as_tensor(lengths)
    for cls in edge_colors(rooted, len(lengths)):
        T, ls = ref._edge_sums(ref.pmats(t), cls)
        f, _, _ = ref._edge_fn(T, ls, t[torch.as_tensor(cls)])
        np.testing.assert_allclose(f.numpy(), want, rtol=1e-12)
    opt, best, sweeps = ref.optimize(lengths, 1e-4, 100.0, 1e-9)
    assert best > want and sweeps > 1
    t = torch.as_tensor(opt)
    for cls in edge_colors(rooted, len(lengths)):
        T, ls = ref._edge_sums(ref.pmats(t), cls)
        _, d1, _ = ref._edge_fn(T, ls, t[torch.as_tensor(cls)])
        inside = (t[torch.as_tensor(cls)] > 1.01e-4).numpy()
        assert np.abs(d1.numpy()[inside]).max() < 1e-3


def test_edge_colors_share_no_node():
    edges, _ = random_binary_tree(np.random.default_rng(1), 40, 0.1, 0.2)
    cls = edge_colors(Rooted(edges, 40), len(edges))
    assert sorted(np.concatenate(cls).tolist()) == list(range(len(edges)))
    for c in cls:
        nodes = edges[c].ravel()
        assert len(set(nodes.tolist())) == len(nodes)


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1 + 2**-12,
                      -3.14159], dtype=torch.float32)
    y = round_tf32(x)
    # 10 mantissa bits: steps of 2**-10 at 1, ties to even
    assert y.tolist()[:4] == [1.0, 1.0, 1.0 + 4 * 2**-11, 1.0]
    assert abs(y[4].item() + 3.14159) <= 2 * 2**-11 * 3.14159
