"""Character-state maps (charmaps).

TPU-native equivalent of libpll's ``pll_map_nt`` / ``pll_map_aa`` /
``pll_map_gt10`` / ``pll_map_gt16`` lookup tables plus the custom charmap
machinery of the reference (``src/util/models.c:346-423``).

A charmap maps each of the 256 byte values to a *state bitmask* over the
model's states (bit ``s`` set = character compatible with state ``s``).
Ambiguity codes set multiple bits; gaps/unknowns set all bits.

Encoding pipeline used by the compute core:

1. raw sequence bytes -> ``code`` via ``encode()`` (a dense index into the
   distinct observed bitmasks), producing ``tip_states: uint8/uint16``
2. the per-code *tip CLV lookup table* ``code_clv[n_codes, states]``
   (0/1 rows from the bitmask) is what the CLV kernels gather from —
   this is the TPU analog of libpll's PLL_ATTRIB_PATTERN_TIP tipchars +
   ttlookup machinery (SURVEY.md §2.9).
"""

from __future__ import annotations

import numpy as np

from pllmod_tpu_torch.common import UtilError, UTIL_ERROR_MODEL_INVALID_MAPSTRING


class Charmap:
    """A 256-entry byte -> state-bitmask map for a model with ``states`` states."""

    def __init__(self, states: int, table: np.ndarray, name: str = "custom"):
        assert table.shape == (256,)
        self.states = states
        self.name = name
        # uint64 bitmasks support up to 64 states (multistate models cap,
        # reference models_mult.c:39-127)
        self.table = table.astype(np.uint64)

    # -- encoding ----------------------------------------------------------
    def encode(self, seqs: list[bytes | str]) -> tuple[np.ndarray, np.ndarray]:
        """Encode sequences into dense tip-state codes.

        Returns ``(tip_states[n_seqs, sites], code_masks[n_codes])`` where
        ``code_masks[tip_states[i, j]]`` is the state bitmask of character
        ``j`` of sequence ``i``. Code 0 is always the all-states (gap) mask.
        """
        # two passes over 256-entry CHARACTER space, never over the
        # [tips, sites] mask matrix: the old per-element dict lookup
        # (np.vectorize) cost 882 s at 10k taxa × 100k sites and the
        # uint64 mask intermediate held 8 GB
        arrs = []
        length = None
        hist = np.zeros(256, np.int64)
        for s in seqs:
            if isinstance(s, str):
                s = s.encode()
            arr = np.frombuffer(s, dtype=np.uint8)
            if length is None:
                length = len(arr)
            elif len(arr) != length:
                raise UtilError(
                    UTIL_ERROR_MODEL_INVALID_MAPSTRING,
                    f"sequence length mismatch: {len(arr)} != {length}")
            hist += np.bincount(arr, minlength=256)
            arrs.append(arr)
        observed = np.nonzero(hist)[0]
        bad = observed[self.table[observed] == 0]
        if len(bad):
            raise UtilError(
                UTIL_ERROR_MODEL_INVALID_MAPSTRING,
                f"invalid character(s) {bytes(bad[:5].astype(np.uint8))!r}"
                f" for charmap {self.name}",
            )
        gap_mask = (np.uint64((1 << self.states) - 1) if self.states < 64
                    else np.uint64(2**64 - 1))
        masks_obs = self.table[observed]
        uniq = np.unique(masks_obs)
        # put the gap mask first (code 0) for padding-friendliness
        uniq = np.concatenate([[gap_mask], uniq[uniq != gap_mask]])
        code_of = {np.uint64(m): i for i, m in enumerate(uniq)}
        char_code = np.zeros(256, np.int32)
        char_code[observed] = [code_of[np.uint64(m)] for m in masks_obs]
        codes = np.stack([char_code[a] for a in arrs])
        return codes.astype(np.int32), uniq

    def mask_to_clv_rows(self, code_masks: np.ndarray) -> np.ndarray:
        """Bitmask codes -> 0/1 tip-CLV rows ``[n_codes, states]`` (float64)."""
        bits = np.arange(self.states, dtype=np.uint64)
        return ((code_masks[:, None] >> bits[None, :]) & np.uint64(1)).astype(np.float64)

    def valid_chars(self) -> np.ndarray:
        return np.nonzero(self.table != 0)[0].astype(np.uint8)


def _build(states: int, pairs: dict[str, int], name: str, case_insensitive=True) -> Charmap:
    t = np.zeros(256, dtype=np.uint64)
    for ch, mask in pairs.items():
        t[ord(ch)] = mask
        if case_insensitive and ch.isalpha():
            t[ord(ch.swapcase())] = mask
    return Charmap(states, t, name)


# ---------------------------------------------------------------------------
# DNA (4 states, order A C G T) — IUPAC ambiguity codes, libpll pll_map_nt
# ---------------------------------------------------------------------------
_A, _C, _G, _T = 1, 2, 4, 8
DNA = _build(4, {
    "A": _A, "C": _C, "G": _G, "T": _T, "U": _T,
    "R": _A | _G, "Y": _C | _T, "S": _C | _G, "W": _A | _T,
    "K": _G | _T, "M": _A | _C,
    "B": _C | _G | _T, "D": _A | _G | _T, "H": _A | _C | _T, "V": _A | _C | _G,
    "N": 15, "X": 15, "-": 15, "?": 15, "O": 15, ".": 15,
}, "nt")

# ---------------------------------------------------------------------------
# Amino acids (20 states, PAML order A R N D C Q E G H I L K M F P S T W Y V)
# ---------------------------------------------------------------------------
AA_ORDER = "ARNDCQEGHILKMFPSTWYV"
_aa_bit = {c: 1 << i for i, c in enumerate(AA_ORDER)}
_ALL20 = (1 << 20) - 1
AA = _build(20, {
    **_aa_bit,
    "B": _aa_bit["N"] | _aa_bit["D"],
    "Z": _aa_bit["Q"] | _aa_bit["E"],
    "J": _aa_bit["I"] | _aa_bit["L"],
    "X": _ALL20, "-": _ALL20, "?": _ALL20, "*": _ALL20, ".": _ALL20,
}, "aa")

# ---------------------------------------------------------------------------
# Unphased genotypes, 10 states (order AA CC GG TT AC AG AT CG CT GT —
# reference models_gt.c:36 comment row). Characters use IUPAC het codes.
# ---------------------------------------------------------------------------
GT10_ORDER = ["AA", "CC", "GG", "TT", "AC", "AG", "AT", "CG", "CT", "GT"]
_gt10 = {g: 1 << i for i, g in enumerate(GT10_ORDER)}
_ALL10 = (1 << 10) - 1
GT10 = _build(10, {
    "A": _gt10["AA"], "C": _gt10["CC"], "G": _gt10["GG"], "T": _gt10["TT"],
    "U": _gt10["TT"],
    "M": _gt10["AC"], "R": _gt10["AG"], "W": _gt10["AT"],
    "S": _gt10["CG"], "Y": _gt10["CT"], "K": _gt10["GT"],
    "N": _ALL10, "X": _ALL10, "-": _ALL10, "?": _ALL10, ".": _ALL10,
}, "gt10")

# ---------------------------------------------------------------------------
# Phased genotypes, 16 states (order AA CC GG TT AC AG AT CG CT GT CA GA TA
# GC TC TG — reference models_gt.c:59 comment row). Heterozygote IUPAC codes
# are ambiguous over both phases.
# ---------------------------------------------------------------------------
GT16_ORDER = ["AA", "CC", "GG", "TT", "AC", "AG", "AT", "CG", "CT", "GT",
              "CA", "GA", "TA", "GC", "TC", "TG"]
_gt16 = {g: 1 << i for i, g in enumerate(GT16_ORDER)}
_ALL16 = (1 << 16) - 1
GT16 = _build(16, {
    "A": _gt16["AA"], "C": _gt16["CC"], "G": _gt16["GG"], "T": _gt16["TT"],
    "U": _gt16["TT"],
    "M": _gt16["AC"] | _gt16["CA"], "R": _gt16["AG"] | _gt16["GA"],
    "W": _gt16["AT"] | _gt16["TA"], "S": _gt16["CG"] | _gt16["GC"],
    "Y": _gt16["CT"] | _gt16["TC"], "K": _gt16["GT"] | _gt16["TG"],
    "N": _ALL16, "X": _ALL16, "-": _ALL16, "?": _ALL16, ".": _ALL16,
}, "gt16")

# ---------------------------------------------------------------------------
# Multistate (up to 64 states; symbols 0-9 A-Z a-z + ! @, mirroring the
# reference's on-the-fly MULTIx charmaps, models_mult.c:39-127)
# ---------------------------------------------------------------------------
MULTI_SYMBOLS = "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!@"


def multistate(states: int) -> Charmap:
    if not (2 <= states <= 64):
        raise UtilError(UTIL_ERROR_MODEL_INVALID_MAPSTRING,
                        f"multistate models support 2..64 states, got {states}")
    all_mask = (1 << states) - 1 if states < 64 else 2**64 - 1
    pairs = {MULTI_SYMBOLS[i]: 1 << i for i in range(states)}
    pairs.update({"-": all_mask, "?": all_mask, ".": all_mask})
    t = np.zeros(256, dtype=np.uint64)
    for ch, mask in pairs.items():
        t[ord(ch)] = np.uint64(mask)  # case-SENSITIVE: lowercase are distinct states
    return Charmap(states, t, f"multi{states}")


def custom(states: int, mapping: dict[str, int], name: str = "custom",
           case_insensitive: bool = True) -> Charmap:
    """Custom charmap from {char: bitmask} (reference models.c:346-423)."""
    return _build(states, mapping, name, case_insensitive)


def parse_charmap_string(states: int, s: str, name="custom") -> Charmap:
    """Parse a charmap spec of lines ``CHARS = state_index`` or where each
    line's chars all map to consecutive states (reference file-based custom
    charmaps, models.c:423+). Simplified grammar: whitespace-separated
    groups; group i maps each of its characters to state i."""
    groups = s.split()
    if len(groups) != states:
        raise UtilError(UTIL_ERROR_MODEL_INVALID_MAPSTRING,
                        f"expected {states} symbol groups, got {len(groups)}")
    pairs = {}
    all_mask = (1 << states) - 1 if states < 64 else 2**64 - 1
    for i, g in enumerate(groups):
        for ch in g:
            pairs[ch] = pairs.get(ch, 0) | (1 << i)
    pairs.setdefault("-", all_mask)
    pairs.setdefault("?", all_mask)
    return _build(states, pairs, name, case_insensitive=False)


BY_NAME = {"nt": DNA, "dna": DNA, "aa": AA, "protein": AA,
           "gt10": GT10, "gt16": GT16}


def for_states(states: int) -> Charmap:
    """Default charmap for a state count (4=DNA, 20=AA, 10/16=GT, else multi)."""
    return {4: DNA, 20: AA, 10: GT10, 16: GT16}.get(states) or multistate(states)
