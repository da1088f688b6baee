"""Complete maximum-likelihood tree search driver — counterpart of
``pllmod_tpu.algorithm.search``, its host logic line for line.

The reference library ships the pieces — model-parameter optimization
drivers (``src/algorithm/pllmod_algorithm.c``) and the SPR-round engine
(``src/algorithm/algo_search.c:1052-1470``) — and its ``examples/spr-round``
driver runs exactly one FAST round (``examples/spr-round/spr-round.c:249``).
The canonical composition (alternate model optimization with SPR rounds,
escalate the re-insertion radius when a round stops improving, switch from
FAST to THOROUGH re-insertion, stop when the log-likelihood is stationary)
lives downstream of the reference in RAxML-NG.  This module provides that
composition natively so the framework is usable end-to-end: MSA → starting
tree → ``ml_search`` → ML tree + model.

Semantics per stage (FAST, then THOROUGH):
  * run :func:`pllmod_tpu_torch.algorithm.spr.spr_round` with the current
    radius window ``[radius_min, cur_radius]``;
  * a round that improves the incumbent logL by more than ``lh_epsilon``
    keeps the radius and triggers a model re-optimization
    (:func:`pllmod_tpu_torch.algorithm.opt_model.opt_model` honors each
    partition's ``params_to_optimize`` bitmask, so a branch-lengths-only
    setup matches the reference example exactly);
  * a round that does not improve escalates ``cur_radius`` by
    ``radius_step`` until ``radius_max`` is reached, after which the stage
    ends (algo_search.c keeps a fixed radius per call; the escalation
    schedule is the downstream convention).

The search ends with a final model optimization at ``final_epsilon``.

Every likelihood evaluation runs where the TreeInfo's partitions lie
(float32: the kernels; float64: the serial engine); the driver itself
is host code. A checkpoint holds the cutoff state without its
``drops`` (tuple keys, which JSON cannot hold), as the JAX package's
does: a resumed round may skip other subtrees than the uninterrupted
one and apply other moves. A checkpoint holds whole, host-side
partitions, so a sharded search's checkpoint loads unsharded and the
other way round; a resume under a mesh (``treeinfo.mesh``) re-shards
the restored partitions onto it.
"""

from __future__ import annotations

import dataclasses

from pllmod_tpu_torch.algorithm.opt_model import opt_model
from pllmod_tpu_torch.algorithm.spr import spr_round
from pllmod_tpu_torch.parallel.sharding import shard_treeinfo


@dataclasses.dataclass
class SearchRound:
    """One SPR round's outcome (observability record)."""
    mode: str          # "fast" | "thorough"
    radius: int        # cur_radius (max re-insertion distance this round)
    loglh: float       # logL after the round (+ any model re-opt)
    n_applied: int     # SPR moves applied by the round


@dataclasses.dataclass
class SearchResult:
    loglh: float
    rounds: list
    start_loglh: float

    @property
    def n_rounds(self) -> int:
        return len(self.rounds)


def ml_search(treeinfo, *, radius_min: int = 1, radius_step: int = 5,
              radius_max: int = 20, lh_epsilon: float = 0.1,
              model_epsilon: float = 1e-2, final_epsilon: float = 1e-3,
              ntopol_keep: int = 20, subtree_cutoff: float = 1.0,
              blo_params: dict | None = None, symmetries=None,
              constraint=None, max_rounds: int = 50, thorough: bool = True,
              on_round=None, checkpoint_path: str | None = None,
              resume: bool = False):
    """Search for the maximum-likelihood tree, modifying ``treeinfo``
    in place (its tree ends at the best topology found, its partitions at
    the re-optimized model parameters).

    Args:
      treeinfo: :class:`pllmod_tpu_torch.tree.treeinfo.TreeInfo`; which model
        parameters are (re-)optimized between rounds follows each
        partition's ``params_to_optimize`` bitmask.
      radius_min / radius_step / radius_max: SPR re-insertion radius
        window and escalation schedule.
      lh_epsilon: minimum logL gain for a round to count as an improvement
        (the reference example uses 0.1, spr-round.c:245).
      model_epsilon / final_epsilon: convergence tolerance for the
        interleaved / final model-parameter optimization.
      thorough: run the THOROUGH stage (triplet-BLO re-insertion scoring)
        after FAST stops improving; ``False`` = FAST only.
      constraint: optional
        :class:`pllmod_tpu_torch.tree.constraint.Constraint`.
      max_rounds: hard cap across both stages.
      on_round: optional callback ``f(SearchRound)`` after every round.
      checkpoint_path: when given, the full search state (treeinfo via
        :func:`pllmod_tpu_torch.binary.save_treeinfo` + stage/radius/round
        records) is written after every SPR round — the RAxML-NG-style
        search checkpoint built on the binary module (SURVEY §2.7).
      resume: with ``checkpoint_path`` pointing at an existing file,
        restore ``treeinfo`` and continue from the recorded stage and
        radius instead of starting over. The restored partitions go on
        the device, and in the dtype, of ``treeinfo``'s own, and are
        sharded onto ``treeinfo.mesh`` when it has one.

    Returns:
      :class:`SearchResult`; ``treeinfo`` holds the best tree/model.
    """
    import json
    import os

    ck_state = None
    if checkpoint_path and resume and os.path.exists(checkpoint_path):
        from pllmod_tpu_torch.binary import load_treeinfo
        own = next(p for p in treeinfo.partitions if p is not None)
        ti2, extra = load_treeinfo(checkpoint_path, device=own.device)
        treeinfo.tree = ti2.tree
        treeinfo.partitions = [
            p if p is None or p.dtype == own.dtype
            else p.to(dtype=own.dtype).cache_eigen()
            for p in ti2.partitions]
        treeinfo.brlens = ti2.brlens
        treeinfo.brlen_scalers = ti2.brlen_scalers
        treeinfo.params_to_optimize = ti2.params_to_optimize
        treeinfo.brlen_linkage = ti2.brlen_linkage
        if treeinfo.mesh is not None:
            # checkpoints hold whole partitions; the resumed search keeps
            # running sharded
            shard_treeinfo(treeinfo, treeinfo.mesh, treeinfo.mesh_axis)
        # no evaluator, incremental buffer or edge table of the state
        # before the swap may serve the restored one
        treeinfo.clear_caches()
        ck_state = json.loads(extra.decode())

    def save_ck(mode, cur_radius, rounds, lnl, start_lnl):
        if not checkpoint_path:
            return
        from pllmod_tpu_torch.binary import save_treeinfo
        state = {"mode": mode, "radius": cur_radius, "lnl": lnl,
                 "start_lnl": start_lnl,
                 "cutoff": {k: v for k, v in cutoff_state.items()
                            if k != "drops"},
                 "rounds": [[r.mode, r.radius, r.loglh, r.n_applied]
                            for r in rounds]}
        save_treeinfo(checkpoint_path, treeinfo,
                      extra=json.dumps(state).encode())

    # one cutoff_info_t threaded through the whole search (RAxML-NG's
    # usage of pllmod_algorithm.h:41-47)
    cutoff_state: dict = {"sum": 0.0, "n": 0}
    rounds: list[SearchRound] = []
    modes = ("fast", "thorough") if thorough else ("fast",)
    if ck_state is not None:
        start_lnl = ck_state["start_lnl"]
        lnl = ck_state["lnl"]
        cutoff_state.update(ck_state.get("cutoff", {}))
        rounds = [SearchRound(*r) for r in ck_state["rounds"]]
        if ck_state["mode"] in modes:
            skip = modes.index(ck_state["mode"])
            modes = modes[skip:]
        else:       # checkpointed stage not requested on resume: finish up
            modes = ()
        resume_radius = ck_state["radius"]
    else:
        start_lnl = treeinfo.compute_loglh()
        lnl = opt_model(treeinfo, symmetries=symmetries, tol=model_epsilon,
                        blo_kwargs=blo_params)
        resume_radius = None
    for mode in modes:
        cur_radius = min(max(radius_min + radius_step - 1, radius_min),
                         radius_max)
        if resume_radius is not None:
            cur_radius = max(cur_radius, min(resume_radius, radius_max))
            resume_radius = None    # only the interrupted stage resumes
        while len(rounds) < max_rounds:
            best, n_applied, _ = spr_round(
                treeinfo, radius_min=radius_min, radius_max=cur_radius,
                ntopol_keep=ntopol_keep, thorough=(mode == "thorough"),
                blo_params=blo_params, subtree_cutoff=subtree_cutoff,
                constraint=constraint, cutoff_state=cutoff_state)
            improved = best > lnl + lh_epsilon
            if improved:
                # topology changed: re-fit the model before the next round
                lnl = opt_model(treeinfo, symmetries=symmetries,
                                tol=model_epsilon, blo_kwargs=blo_params)
            else:
                lnl = max(lnl, best)
            rec = SearchRound(mode, cur_radius, float(lnl), int(n_applied))
            rounds.append(rec)
            save_ck(mode, cur_radius, rounds, float(lnl), float(start_lnl))
            if on_round is not None:
                on_round(rec)
            if not improved:
                if cur_radius >= radius_max:
                    break
                cur_radius = min(cur_radius + radius_step, radius_max)
        else:
            break  # max_rounds exhausted: skip remaining stages

    lnl = opt_model(treeinfo, symmetries=symmetries, tol=final_epsilon,
                    blo_kwargs=blo_params)
    return SearchResult(loglh=float(lnl), rounds=rounds,
                        start_loglh=float(start_lnl))
