"""The Partition — PyTorch counterpart of ``pllmod_tpu.ops.partition``
(libpll's ``pll_partition_t``).

A frozen dataclass of tensors on one device holding

- the *data*: encoded tip states + the per-code tip-CLV lookup table
  (the PATTERN_TIP analog — tips are never materialized as full CLVs),
  compressed site-pattern weights, and the invariant-site indicator,
- the *model*: exchangeability rates, frequencies, rate categories/weights,
  proportion of invariant sites, alpha.

CLVs are not stored here: the pruning engines compute and return them.
The pattern axis is padded to a multiple of ``pattern_pad`` (default 128,
so every shape equals the JAX package's); padding sites use the all-gap
code 0 and weight 0, so they contribute exactly zero to the logL.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from pllmod_tpu_torch.common import (GAMMA_RATES_MEAN, ERROR_UNSUPPORTED,
                                     PllModError, resolve_device)
from pllmod_tpu_torch.ops import charmap as charmap_mod
from pllmod_tpu_torch.ops import eigen as eigen_mod
from pllmod_tpu_torch.ops import gamma as gamma_mod


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True, eq=False)
class Partition:
    # --- data ---------------------------------------------------------------
    tip_states: torch.Tensor       # int32 [tips, patterns_padded]
    code_clv: torch.Tensor         # [n_codes, states] 0/1 tip-CLV rows
    pattern_weights: torch.Tensor  # [patterns_padded] (0 on padding)
    inv_indicator: torch.Tensor    # [patterns_padded, states] 0/1
    # --- model parameters ---------------------------------------------------
    subst_rates: torch.Tensor      # [n_matrices, states*(states-1)/2]
    freqs: torch.Tensor            # [n_matrices, states]
    rate_cats: torch.Tensor        # [cats] category rates (mean 1)
    rate_weights: torch.Tensor     # [cats] category weights (sum 1)
    prop_invar: torch.Tensor       # [n_matrices]
    alpha: torch.Tensor            # scalar (Gamma shape; NaN = free rates)
    param_indices: torch.Tensor    # int64 [cats] rate-matrix index per cat
    # --- static metadata ----------------------------------------------------
    n_tips: int
    states: int
    n_patterns: int                # unpadded count
    gamma_mode: int = GAMMA_RATES_MEAN
    # reversible=False switches P-matrices to the matrix-exponential path
    reversible: bool = True
    # --- cached eigendecomposition (libpll eigen_decomp_valid analog) -------
    eigen_lam: torch.Tensor | None = None    # [M, S]
    eigen_V: torch.Tensor | None = None      # [M, S, S]
    eigen_Vinv: torch.Tensor | None = None   # [M, S, S]
    # host copy of "any category has p-inv > 0": the likelihood epilogue
    # branches on it without reading a device tensor (recomputed by every
    # construction, replace() included)
    has_pinv: bool = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        # a p-inv that an optimizer differentiates counts as present (the
        # mixture then has its gradient even at 0, and the same value)
        pinv_c = self.prop_invar[self.param_indices]
        object.__setattr__(self, "has_pinv", self.prop_invar.requires_grad
                           or bool((pinv_c > 0).any()))

    # ------------------------------------------------------------------
    @property
    def n_patterns_padded(self) -> int:
        return self.tip_states.shape[1]

    @property
    def n_cats(self) -> int:
        return self.rate_cats.shape[0]

    @property
    def n_matrices(self) -> int:
        return self.subst_rates.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.freqs.dtype

    @property
    def device(self) -> torch.device:
        return self.freqs.device

    def replace(self, **changes) -> "Partition":
        return dataclasses.replace(self, **changes)

    def to(self, device=None, dtype=None) -> "Partition":
        """The partition on ``device`` with float fields in ``dtype``
        (each default: unchanged). Integer fields keep their types."""
        dev = self.device if device is None else resolve_device(device)
        changes = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                if dtype is not None and v.is_floating_point():
                    v = v.to(dtype)
                changes[f.name] = v.to(dev)
        return self.replace(**changes)

    # ------------------------------------------------------------------
    def eigen(self):
        """Batched eigendecomposition over rate matrices — the cache if
        set, else recomputed in the partition's dtype."""
        if not self.reversible:
            raise PllModError(
                ERROR_UNSUPPORTED,
                "eigendecomposition paths require a reversible model")
        if self.eigen_lam is not None:
            return self.eigen_lam, self.eigen_V, self.eigen_Vinv
        return eigen_mod.eigen_reversible(self.subst_rates, self.freqs)

    def cache_eigen(self) -> "Partition":
        """Return a partition with the eigendecomposition materialized.
        Computed in float64 on the host and cast, so float32 P-matrices
        carry only the cast's rounding. Cleared by
        :meth:`with_model_params`."""
        lam, V, Vinv = eigen_mod.eigen_reversible(
            self.subst_rates.detach().to("cpu", torch.float64),
            self.freqs.detach().to("cpu", torch.float64))

        def back(x):
            return x.to(self.device, self.dtype)

        return self.replace(eigen_lam=back(lam), eigen_V=back(V),
                            eigen_Vinv=back(Vinv))

    def with_model_params(self, subst_rates=None, freqs=None) -> "Partition":
        """Replace rates/freqs AND invalidate the eigen cache."""
        kw = dict(eigen_lam=None, eigen_V=None, eigen_Vinv=None)
        if subst_rates is not None:
            kw["subst_rates"] = subst_rates
        if freqs is not None:
            kw["freqs"] = freqs
        return self.replace(**kw)

    def prob_matrices(self, brlens):
        """P-matrices for all edges × categories: [E, C, S, S].

        Routed as the JAX package routes it: the cached
        eigendecomposition when set (differentiable in the lengths,
        category rates and p-inv); otherwise
        :func:`eigen.prob_matrices_params`, differentiable in every model
        parameter and safe at degenerate spectra; the matrix exponential
        for non-reversible models."""
        brlens = torch.as_tensor(brlens).to(self.device, self.dtype)
        if not self.reversible:
            return eigen_mod.prob_matrices_expm_multi(
                self.subst_rates, self.freqs, brlens, self.rate_cats,
                self.param_indices, self.prop_invar)
        if self.eigen_lam is not None:
            return eigen_mod.prob_matrices_multi(
                (self.eigen_lam, self.eigen_V, self.eigen_Vinv), brlens,
                self.rate_cats, self.param_indices, self.prop_invar)
        return eigen_mod.prob_matrices_params(
            self.subst_rates, self.freqs, brlens, self.rate_cats,
            self.param_indices, self.prop_invar)

    def with_alpha(self, alpha) -> "Partition":
        """Return a partition with alpha set and category rates
        recomputed (on the host, differentiable in ``alpha``:
        :func:`gamma.compute_gamma_cats`)."""
        if not isinstance(alpha, torch.Tensor):
            alpha = torch.tensor(float(alpha), dtype=torch.float64)
        cats = gamma_mod.compute_gamma_cats(alpha, self.n_cats,
                                            self.gamma_mode)
        return self.replace(alpha=alpha.to(self.device, self.dtype),
                            rate_cats=cats.to(self.device, self.dtype))

    def freqs_per_cat(self):
        return self.freqs[self.param_indices]          # [C, S]

    def pinv_mix(self):
        """Scalar p-inv of rate matrix 0 — an optimizer's starting point
        only; the likelihood paths index ``prop_invar[param_indices]``
        per category (:meth:`pinv_per_cat`)."""
        return self.prop_invar[0]

    def pinv_per_cat(self):
        """Per-category proportion of invariant sites (prop_invar indexed
        by param_indices — libpll core_likelihood indexing)."""
        return self.prop_invar[self.param_indices]


def create_partition(
    sequences,
    states: int | None = None,
    n_rate_cats: int = 4,
    alpha: float = 1.0,
    subst_rates=None,
    freqs=None,
    prop_invar: float = 0.0,
    n_matrices: int = 1,
    param_indices=None,
    rate_weights=None,
    charmap: "charmap_mod.Charmap | None" = None,
    pattern_weights=None,
    compress: bool = True,
    pattern_pad: int = 128,
    dtype: torch.dtype = torch.float32,
    gamma_mode: int = GAMMA_RATES_MEAN,
    reversible: bool = True,
    device="cuda",
    timings: dict | None = None,
) -> Partition:
    """Build a Partition from raw sequences (list of str/bytes, equal
    length) on ``device`` — pll_partition_create + pll_set_tip_states +
    pll_set_pattern_weights + pll_compress_site_patterns +
    pll_update_invariant_sites. Same arguments and arrays as
    ``pllmod_tpu.ops.partition.create_partition``. ``timings``: optional
    dict, filled with the host seconds of each step: ``encode_s``,
    ``compress_s``, ``tables_s`` (the padded codes, invariant sites and
    model arrays), ``upload_s`` (the tensors' copies onto ``device``)."""
    dev = resolve_device(device)
    if charmap is None:
        if states is None:
            raise ValueError("need states or charmap")
        charmap = charmap_mod.for_states(states)
    states = charmap.states
    clock = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        if timings is not None:
            timings[name] = now - clock[0]
        clock[0] = now

    codes, code_masks = charmap.encode(sequences)   # [tips, sites]
    step("encode_s")
    n_tips, n_sites = codes.shape

    if pattern_weights is None:
        pattern_weights = np.ones(n_sites, dtype=np.float64)
    else:
        pattern_weights = np.asarray(pattern_weights, dtype=np.float64)

    if compress:
        codes, pattern_weights = compress_patterns(codes, pattern_weights)
    step("compress_s")
    n_patterns = codes.shape[1]
    padded = round_up(max(n_patterns, 1), pattern_pad)

    tip_states = np.zeros((n_tips, padded), dtype=np.int32)  # code 0 = gap
    tip_states[:, :n_patterns] = codes
    w = np.zeros(padded, dtype=np.float64)
    w[:n_patterns] = pattern_weights

    inv_mask = gamma_mod.invariant_sites_mask(code_masks, tip_states)
    bits = ((inv_mask[:, None] >> np.arange(states, dtype=np.uint64)[None, :])
            & np.uint64(1))
    inv_indicator = bits.astype(np.float64)
    inv_indicator[n_patterns:] = 0.0   # padding can never be invariant

    code_clv = charmap.mask_to_clv_rows(code_masks)

    nr = states * (states - 1) // 2
    if subst_rates is None:
        subst_rates = np.ones(nr, dtype=np.float64)
    subst_rates = np.broadcast_to(np.asarray(subst_rates, np.float64),
                                  (n_matrices, nr)).copy()
    if freqs is None:
        freqs = np.full(states, 1.0 / states)
    freqs = np.broadcast_to(np.asarray(freqs, np.float64),
                            (n_matrices, states)).copy()
    if param_indices is None:
        param_indices = np.zeros(n_rate_cats, dtype=np.int64)
    if rate_weights is None:
        rate_weights = np.full(n_rate_cats, 1.0 / n_rate_cats)
    if n_rate_cats > 1 and alpha is not None:
        cats = gamma_mod.compute_gamma_cats_host(alpha, n_rate_cats,
                                                 gamma_mode)
    else:
        cats = np.ones(n_rate_cats)

    def dev_t(x, dt=dtype):
        return torch.as_tensor(np.asarray(x), dtype=dt, device=dev)

    step("tables_s")
    part = Partition(
        tip_states=dev_t(tip_states, torch.int32),
        code_clv=dev_t(code_clv),
        pattern_weights=dev_t(w),
        inv_indicator=dev_t(inv_indicator),
        subst_rates=dev_t(subst_rates),
        freqs=dev_t(freqs),
        rate_cats=dev_t(cats),
        rate_weights=dev_t(rate_weights),
        prop_invar=dev_t(np.full((n_matrices,), prop_invar)),
        alpha=dev_t(float("nan") if alpha is None else alpha),
        param_indices=dev_t(param_indices, torch.int64),
        n_tips=n_tips,
        states=states,
        n_patterns=n_patterns,
        gamma_mode=gamma_mode,
        reversible=reversible,
    )
    step("upload_s")
    return part


def make_asc_partition(partition) -> Partition:
    """Companion partition of the S constant-site patterns, for Lewis-type
    ascertainment-bias correction (libpll PLL_ATTRIB_AB_FLAG: the
    reference allocates ``sites + states`` dummy sites,
    treeinfo.c:333-335).

    Pattern j has every tip in state j; the same tree evaluated on it
    gives the probabilities L_j of a constant column, and the corrected
    log-likelihood is ``Σ_p w_p [ln L_p − ln(1 − Σ_j L_j)]`` (Lewis
    2001; :func:`pllmod_tpu_torch.ops.engine.loglikelihood_asc`)."""
    S = partition.states
    pad = partition.n_patterns_padded
    codes = np.zeros((partition.n_tips, pad), np.int32)
    # a pure-state code table of its own: code j+1 = state j, code 0 =
    # gap (padding)
    code_clv = np.zeros((S + 1, S))
    code_clv[0] = 1.0
    for j in range(S):
        code_clv[j + 1, j] = 1.0
        codes[:, j] = j + 1
    w = np.zeros(pad)
    w[:S] = 1.0  # a selector, not a weight
    dev, dt = partition.device, partition.dtype
    return partition.replace(
        tip_states=torch.as_tensor(codes, device=dev),
        code_clv=torch.as_tensor(code_clv, dtype=dt, device=dev),
        pattern_weights=torch.as_tensor(w, dtype=dt, device=dev),
        inv_indicator=torch.zeros((pad, S), dtype=dt, device=dev),
        # the correction is defined for the variable-rates process only
        prop_invar=torch.zeros_like(partition.prop_invar),
    )


def compress_patterns(codes: np.ndarray, weights: np.ndarray):
    """Site-pattern compression: identical alignment columns collapse into
    one pattern with summed weight (libpll ``pll_compress_site_patterns``).
    Native C++ hash-dedup when the runtime library is built; numpy
    fallback otherwise (same first-occurrence order)."""
    from pllmod_tpu_torch import native
    if native.available():
        return native.compress_patterns(codes, weights)
    cols = np.ascontiguousarray(codes.T)
    view = cols.view([("", cols.dtype)] * cols.shape[1]).ravel()
    uniq, inverse = np.unique(view, return_inverse=True)
    n_pat = len(uniq)
    w = np.zeros(n_pat, dtype=weights.dtype)
    np.add.at(w, inverse, weights)
    first_idx = np.full(n_pat, len(view), dtype=np.int64)
    np.minimum.at(first_idx, inverse, np.arange(len(view)))
    order = np.argsort(first_idx, kind="stable")
    new_codes = cols[np.sort(first_idx)].T.copy()
    return new_codes.astype(codes.dtype), w[order]
