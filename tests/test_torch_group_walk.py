"""The host side of the group-window walk (kernels 6 and 7,
``csrc/group_walk.cuh``), on the CPU:

- ``_build.group_walk_config`` and ``group_walk_tile``, the launch
  configuration and the rule that picks the pattern tile and row lanes,
  as pure Python: the cells' choices and every configuration's limits;
- ``packed.window_offsets``, the greedy cut of a walk into windows, and
  the packed schedule's windows against a brute-force check of what each
  row reads and against its levels;
- ``grouped.walk_order``, the grouped walk's member order and windows,
  against a brute-force dependency check over ``side_meta`` and
  ``dst_meta`` on random and caterpillar trees, with a root on a tip
  edge and with ``group=`` given.

Small trees only (at most 48 taxa): the schedules are host numpy."""

import numpy as np
import pytest
import torch

from pllmod_tpu_torch.ops import _build, grouped, packed
from pllmod_tpu_torch.tree.topology import Tree as TorchTree
from tests import reference_impl as ref
from tests.torch_cases import caterpillar_newick, tip_edge, to_torch_tree
from tests.torch_cases import one_torch_thread  # noqa: F401 (autouse)


class Shape:
    """What a schedule reads of a partition: tips, categories, states and
    device."""

    def __init__(self, n_tips, states=4, cats=4):
        self.n_tips, self.n_cats, self.states = n_tips, cats, states
        self.device = torch.device("cpu")


def _tree(kind, n_taxa, seed):
    if kind == "caterpillar":
        return TorchTree.from_newick(caterpillar_newick(n_taxa))
    return to_torch_tree(ref.random_binary_tree(np.random.default_rng(seed),
                                                n_taxa))


# (C, S, n_codes, Ppad) -> (T, R, kind) of the rule: the flagship DNA and
# protein cells, the 64-state cell, C = 1, a short alignment and a table
# of many categories
@pytest.mark.parametrize("C,S,n_codes,Ppad,want", [
    (4, 4, 5, 16384, (64, 4, "thread")),
    (4, 20, 21, 4096, (32, 2, "tile")),
    (4, 64, 65, 4096, (32, 1, "tile")),
    (1, 4, 5, 16384, (128, 4, "thread")),
    (4, 5, 6, 512, (4, 4, "thread")),
    (4, 20, 21, 512, (4, 4, "tile")),
    (64, 64, 65, 4096, (1, 1, "wide")),
])
def test_group_walk_tile_rule(C, S, n_codes, Ppad, want):
    """The rule's tile, lanes and kind at each shape: a grid that fills
    the card (≥ 95 % of 132 CTAs), then the fewest waves, the most lanes
    and the widest tile, and the wide kind only where no register tile
    fits."""
    T, R = _build.group_walk_tile(C, S, n_codes, Ppad)
    assert (T, R, _build.group_walk_config(C, S, n_codes, T, R)["kind"]) \
        == want
    if want[2] != "wide":
        assert -(-Ppad // T) >= 0.95 * _build.SMS


@pytest.mark.parametrize("S", [1, 4, 5, 8, 16, 20, 32, 64])
@pytest.mark.parametrize("C", [1, 4, 8, 32])
def test_group_walk_config_limits(S, C):
    """Every configuration at every tile and lane count fits a block
    (threads, shared memory), holds S states in SP (a multiple of 4),
    sizes Q for the larger of S and the code count, and takes the design
    of its state count; within a kind, lanes only multiply threads."""
    for n_codes in (S, 21):
        for T in _build.TILES:
            one = _build.group_walk_config(C, S, n_codes, T, 1)
            for R in (1, 2, 3, 4, 8):
                cf = _build.group_walk_config(C, S, n_codes, T, R)
                if cf is None:
                    continue
                assert cf["threads"] <= 512
                assert cf["smem"] <= _build.SMEM_PER_BLOCK
                assert cf["SP"] % 4 == 0 and cf["SP"] >= S
                assert cf["staged"] in ((0,) if S <= 8 else (0, 1))
                assert cf["Q"] == C * max(S, n_codes) * cf["SP"]
                assert cf["kind"] == ("thread" if S <= 8 else cf["kind"])
                assert cf["kind"] != "thread" or cf["RP"] == (
                    2 if S <= 4 else 1)
                if cf["kind"] == one["kind"]:
                    assert cf["threads"] == R * one["threads"]
                if cf["kind"] != "wide":
                    assert cf["SP"] == cf["IG"] * cf["RI"]
    assert _build.group_walk_config(C, 65, 66, 4, 1) is None
    assert _build.group_walk_config(C, S, 5, 4, 0) is None
    assert _build.group_walk_config(C, S, 5, 4, 9) is None   # 8 lanes


def test_group_walk_tile_raises():
    with pytest.raises(ValueError, match="no tile"):
        _build.group_walk_tile(256, 64, 65, 4096)


def test_window_offsets_greedy_cut():
    """Windows are maximal runs: a row starts one exactly where it reads
    a row of the run open before it; a forward read raises."""
    reads = np.array([[-1, -1], [-1, -1], [0, -1], [-1, 1], [-1, -1],
                      [2, 4], [-1, -1], [3, 5]])
    np.testing.assert_array_equal(packed.window_offsets(reads),
                                  [0, 2, 5, 7, 8])
    np.testing.assert_array_equal(packed.window_offsets(
        np.full((3, 2), -1)), [0, 3])
    with pytest.raises(ValueError, match="not an earlier one"):
        packed.window_offsets(np.array([[-1, -1], [1, -1]]))


def _check_windows(windows, reads):
    """Brute force: the windows tile the rows in order, no row reads a
    row of its own window or a later one, and each window but the first
    opens with a row that reads the window before (greedy, maximal)."""
    w = np.asarray(windows)
    assert w[0] == 0 and w[-1] == len(reads) and (np.diff(w) > 0).all()
    win = np.repeat(np.arange(len(w) - 1), np.diff(w))
    for r, row in enumerate(reads):
        for x in row:
            if x >= 0:
                assert win[x] < win[r]
    for k in range(1, len(w) - 1):
        assert any(x >= w[k - 1] for x in reads[w[k]])


@pytest.mark.parametrize("kind,n_taxa,root,group", [
    ("random", 24, None, 0), ("random", 48, None, 0),
    ("caterpillar", 13, None, 0), ("random", 17, "tip", 0),
    ("random", 30, None, 3)])
def test_packed_windows_brute_force(kind, n_taxa, root, group):
    """The packed schedule's windows against the rows' reads (the slot
    of each inner child, which is its producing row) and its levels: at
    most one window a level, every window inside the padded rows."""
    tree = _tree(kind, n_taxa, 700 + n_taxa)
    root_edge = tip_edge(tree) if root == "tip" else None
    s = packed.PackedSchedule(Shape(n_taxa), tree, root_edge, group)
    m = s.idxm.numpy()
    reads = np.where(m[:, [1, 3]] != 0, -1, m[:, [0, 2]])
    np.testing.assert_array_equal(packed.packed_reads(m), reads)
    _check_windows(s.windows.numpy(), reads)
    levels = int(s.idxg.numpy()[:, 1].sum()) + 1
    assert len(s.windows) - 1 <= levels
    if kind == "caterpillar":
        assert len(s.windows) - 1 == levels == n_taxa - 2


@pytest.mark.parametrize("kind,n_taxa,states,cats,root,group", [
    ("random", 24, 4, 4, None, 0),      # G = 4
    ("random", 48, 20, 4, None, 0),     # G = 1
    ("random", 40, 4, 1, None, 0),      # G = 16
    ("caterpillar", 13, 4, 4, None, 0),
    ("random", 17, 4, 4, "tip", 0),     # one landing position a tip
    ("random", 30, 4, 4, None, 3)])     # G given
def test_grouped_walk_order_brute_force(kind, n_taxa, states, cats, root,
                                        group):
    """The grouped walk's member order and windows against a brute-force
    dependency check: every member once; each inner child position has
    exactly one writer (dst_meta), in an earlier window of the walk; the
    landing and trash positions of buffer nG are read by no member."""
    tree = _tree(kind, n_taxa, 720 + n_taxa)
    root_edge = tip_edge(tree) if root == "tip" else None
    s = grouped.GroupedSchedule(Shape(n_taxa, states, cats), tree,
                                root_edge, group)
    side, dst = s.side_meta.numpy(), s.dst_meta.numpy()
    order, windows = s.order.numpy(), s.windows.numpy()
    G, nG = s.G, s.nG
    assert sorted(order.tolist()) == list(range(nG * G))
    o2, w2 = grouped.walk_order(side, dst)
    np.testing.assert_array_equal(o2, order)
    np.testing.assert_array_equal(w2, windows)
    walk_row = np.empty(nG * G, np.int64)
    walk_row[order] = np.arange(nG * G)
    writers = {}
    for g in range(nG):
        for m in range(G):
            writers.setdefault(tuple(dst[g, m]), []).append(g * G + m)
    reads = np.full((nG * G, 2), -1, np.int64)
    for i, mid in enumerate(order):
        g, m = divmod(int(mid), G)
        for k in range(2):
            q = k * G + m
            if side[g, q, 0] == 0:
                (w,) = writers[(g, q)]            # one writer, a member
                reads[i, k] = walk_row[w]
    _check_windows(windows, reads)
    for (dg, dq), ws in writers.items():
        assert dg < nG or len(ws) == 1 or dq >= 2
    if kind == "caterpillar":
        assert len(windows) - 1 == n_taxa - 2
