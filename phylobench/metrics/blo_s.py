"""Seconds a BLO call: the window's seconds over the BLO calls completed
in it."""


def read(run):
    if run.kind != "blo":
        return None
    done = sum("failed" not in r for r in run.records)
    return run.window_s / done if done else None
