"""MSA container, statistics and empirical model parameters.

Counterpart of ``src/msa/pll_msa.c`` (1,324 LoC):

- empirical base frequencies, ambiguity-aware: an ambiguous character
  contributes ``weight / popcount(state)`` to each compatible state
  (pll_msa.c:45-147),
- empirical GTR exchangeabilities from per-column pairwise co-occurrence
  counts, clamped to [0.01, 50] with the last rate fixed to 1
  (pll_msa.c:149-285),
- empirical proportion of invariant sites (pll_msa.c:287-313),
- validity check returning up to 100 offending (seq, pos, char) triples
  (pll_msa.c:482-546),
- bitmask-selected statistics: duplicate taxa / duplicate sequences, gap
  proportion, all-gap rows/columns, invariant columns (AND of per-column
  state masks), state freqs, subst rates (pll_msa.c:581-945),
- row/column filtering and per-site partition splitting
  (pll_msa.c:984-1283).

Everything is vectorized numpy over the ``[taxa, sites]`` code matrix —
the host-side analog of the reference's C loops.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pllmod_tpu_torch.common import MsaError, ERROR_INVALID_PARAM
from pllmod_tpu_torch.ops import charmap as charmap_mod

# stats bitmask (pll_msa.h:29-39)
STATS_DUP_TAXA = 1 << 0
STATS_DUP_SEQS = 1 << 1
STATS_GAP_PROP = 1 << 2
STATS_GAP_SEQS = 1 << 3
STATS_GAP_COLS = 1 << 4
STATS_INV_PROP = 1 << 5
STATS_INV_COLS = 1 << 6
STATS_FREQS = 1 << 7
STATS_SUBST_RATES = 1 << 8
STATS_ALL = (1 << 16) - 1

_MAX_ERRORS = 100  # pll_msa.h:68-75


@dataclasses.dataclass
class MSA:
    """Multiple sequence alignment (pll_msa_t analog)."""
    labels: list[str]
    sequences: list[str]

    def __post_init__(self):
        if len({len(s) for s in self.sequences}) > 1:
            raise MsaError(ERROR_INVALID_PARAM, "ragged alignment")
        if len(self.labels) != len(self.sequences):
            raise MsaError(ERROR_INVALID_PARAM, "labels != sequences")

    @property
    def n_taxa(self) -> int:
        return len(self.sequences)

    @property
    def n_sites(self) -> int:
        return len(self.sequences[0]) if self.sequences else 0

    def char_matrix(self) -> np.ndarray:
        return np.frombuffer("".join(self.sequences).encode(),
                             np.uint8).reshape(self.n_taxa, -1)

    def masks(self, charmap) -> np.ndarray:
        """uint64 [taxa, sites] state bitmasks (0 = invalid char)."""
        return charmap.table[self.char_matrix()]

    # -- filtering (pll_msa.c:984-1162) --------------------------------
    def filter(self, drop_rows=None, drop_cols=None) -> "MSA":
        keep_r = np.ones(self.n_taxa, bool)
        if drop_rows is not None:
            keep_r[np.asarray(drop_rows, int)] = False
        keep_c = np.ones(self.n_sites, bool)
        if drop_cols is not None:
            keep_c[np.asarray(drop_cols, int)] = False
        chars = self.char_matrix()[keep_r][:, keep_c]
        return MSA([l for l, k in zip(self.labels, keep_r) if k],
                   [bytes(row).decode() for row in chars])

    # -- split by per-site partition index (pll_msa.c:1185-1283) -------
    def split(self, site_part: np.ndarray, n_parts: int) -> list["MSA"]:
        """1-based per-site partition indices; 0 drops the site."""
        site_part = np.asarray(site_part, int)
        if site_part.shape != (self.n_sites,):
            raise MsaError(ERROR_INVALID_PARAM, "bad site_part length")
        chars = self.char_matrix()
        out = []
        for p in range(1, n_parts + 1):
            sel = site_part == p
            out.append(MSA(list(self.labels),
                           [bytes(row).decode() for row in chars[:, sel]]))
        return out


# ---------------------------------------------------------------------------
# empirical parameters
# ---------------------------------------------------------------------------
def _state_probs(masks: np.ndarray, states: int) -> np.ndarray:
    """[taxa, sites, states] probability-split of ambiguity codes:
    1/popcount per compatible state; all-states (gap) rows excluded."""
    bits = np.arange(states, dtype=np.uint64)
    onehot = ((masks[..., None] >> bits) & np.uint64(1)).astype(np.float64)
    pc = onehot.sum(-1, keepdims=True)
    gap = pc[..., 0] >= states
    probs = np.where(pc > 0, onehot / np.maximum(pc, 1), 0.0)
    probs[gap] = 0.0
    return probs


def empirical_frequencies(msa: MSA, charmap, pattern_weights=None,
                          smooth: bool = True) -> np.ndarray:
    """Ambiguity-aware empirical base frequencies (pll_msa.c:45-147)."""
    masks = msa.masks(charmap)
    _validate_masks(msa, masks, charmap)
    probs = _state_probs(masks, charmap.states)
    w = (np.ones(msa.n_sites) if pattern_weights is None
         else np.asarray(pattern_weights, float))
    counts = np.einsum("tsk,s->k", probs, w)
    if smooth and (counts == 0).any():
        counts = counts + 0.001 * counts.sum() / charmap.states
    return counts / counts.sum()


def empirical_subst_rates(msa: MSA, charmap, pattern_weights=None,
                          min_rate: float = 0.01,
                          max_rate: float = 50.0) -> np.ndarray:
    """Empirical GTR exchangeabilities from pairwise co-occurrence per
    column (pll_msa.c:149-285): for every column and every pair of taxa
    with single-state characters, count unordered state pairs; rates are
    pair counts normalized by the last rate, clamped to [0.01, 50]."""
    states = charmap.states
    masks = msa.masks(charmap)
    _validate_masks(msa, masks, charmap)
    probs = _state_probs(masks, states)          # [T, S, K]
    w = (np.ones(msa.n_sites) if pattern_weights is None
         else np.asarray(pattern_weights, float))
    # per-column state totals, then unordered pair co-occurrence:
    # pairs[k,l] = sum_cols w * (tot_k * tot_l) for k != l
    tot = probs.sum(axis=0)                      # [S, K]
    pair = np.einsum("sk,sl,s->kl", tot, tot, w)
    # remove self-pairing of the same sequence's character
    self_pair = np.einsum("tsk,tsl,s->kl", probs, probs, w)
    pair = pair - self_pair
    iu = np.triu_indices(states, 1)
    rates = pair[iu]
    last = rates[-1] if rates[-1] > 0 else 1.0
    rates = rates / last
    rates = np.clip(rates, min_rate, max_rate)
    rates[-1] = 1.0
    return rates


def invariant_column_mask(msa: MSA, charmap) -> np.ndarray:
    """Columns whose tip-state masks share a common state (AND over taxa,
    pll_msa.c invariant columns)."""
    masks = msa.masks(charmap)
    _validate_masks(msa, masks, charmap)
    acc = masks[0].copy()
    for i in range(1, msa.n_taxa):
        acc &= masks[i]
    return acc != 0


def empirical_invariant_sites(msa: MSA, charmap,
                              pattern_weights=None) -> float:
    """Empirical proportion of invariant sites (pll_msa.c:287-313)."""
    inv = invariant_column_mask(msa, charmap)
    w = (np.ones(msa.n_sites) if pattern_weights is None
         else np.asarray(pattern_weights, float))
    return float((w * inv).sum() / w.sum())


# ---------------------------------------------------------------------------
# validity + statistics
# ---------------------------------------------------------------------------
def _validate_masks(msa, masks, charmap):
    if (masks == 0).any():
        errs = check_msa(msa, charmap)
        raise MsaError(ERROR_INVALID_PARAM,
                       f"invalid characters in MSA: {errs[:3]} ...")


def check_msa(msa: MSA, charmap):
    """Validity check -> list of (seq_index, position, char), up to 100
    entries (pllmod_msa_errors_t, pll_msa.c:482-546)."""
    masks = msa.masks(charmap)
    bad = np.argwhere(masks == 0)
    out = []
    chars = msa.char_matrix()
    for t, s in bad[:_MAX_ERRORS]:
        out.append((int(t), int(s), chr(chars[t, s])))
    return out


def compute_stats(msa: MSA, charmap, mask: int = STATS_ALL,
                  pattern_weights=None) -> dict:
    """Bitmask-selected statistics (pllmod_msa_compute_stats,
    pll_msa.c:581-945)."""
    out = {}
    masks = msa.masks(charmap)
    states = charmap.states
    gap_mask = np.uint64((1 << states) - 1) if states < 64 \
        else np.uint64(2**64 - 1)
    is_gap = masks == gap_mask

    if mask & STATS_DUP_TAXA:
        seen = {}
        dups = []
        for i, lb in enumerate(msa.labels):
            if lb in seen:
                dups.append((seen[lb], i))
            else:
                seen[lb] = i
        out["dup_taxa"] = dups
    if mask & STATS_DUP_SEQS:
        seen = {}
        dups = []
        for i, s in enumerate(msa.sequences):
            if s in seen:
                dups.append((seen[s], i))
            else:
                seen[s] = i
        out["dup_seqs"] = dups
    if mask & STATS_GAP_PROP:
        out["gap_prop"] = float(is_gap.mean())
    if mask & STATS_GAP_SEQS:
        out["gap_seqs"] = np.nonzero(is_gap.all(axis=1))[0].tolist()
    if mask & STATS_GAP_COLS:
        out["gap_cols"] = np.nonzero(is_gap.all(axis=0))[0].tolist()
    if mask & (STATS_INV_PROP | STATS_INV_COLS):
        inv = invariant_column_mask(msa, charmap)
        if mask & STATS_INV_COLS:
            out["inv_cols"] = np.nonzero(inv)[0].tolist()
        if mask & STATS_INV_PROP:
            out["inv_prop"] = empirical_invariant_sites(
                msa, charmap, pattern_weights)
    if mask & STATS_FREQS:
        out["freqs"] = empirical_frequencies(msa, charmap, pattern_weights)
    if mask & STATS_SUBST_RATES:
        out["subst_rates"] = empirical_subst_rates(msa, charmap,
                                                   pattern_weights)
    return out
