"""Host ms from the evaluator's call to its return, before the readback:
the mean over the window's requests outside the traced stretch (the
profiler's own host cost would inflate it)."""


def read(run):
    if run.kind != "eval":
        return None
    t = [r["issue_s"] for r in run.records
         if "failed" not in r and not r["traced"]]
    return 1e3 * sum(t) / len(t) if t else None
