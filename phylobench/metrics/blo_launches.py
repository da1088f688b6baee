"""Kernel launches of one BLO call (``profile.LAUNCHES``, counted inside
the span ``pllmod.blo``): the mean over the cell's problems of their
traced calls' launches. Every call of one problem does the same work, so
the reading does not depend on which calls the traced stretch caught;
where the recorded calls cannot be matched to the traced requests, the
mean over the calls."""

from phylobench.spans import roots, summary


def read(run):
    got = summary(run, "blo", "pllmod.blo")
    if got is None:
        return None
    calls = roots("pllmod.blo")
    traced = [r for r in run.records if r.get("traced")]
    if len(calls) != len(traced):
        return got["pllmod.blo"]["launches"] / got["pllmod.blo"]["count"]
    by_problem: dict = {}
    for rec, s in zip(traced, calls):
        by_problem.setdefault(rec.get("problem"), []).append(s.launches)
    means = [sum(n) / len(n) for n in by_problem.values()]
    return sum(means) / len(means)
