"""Sweeps a BLO call: the mean of the driver's own ``stats["sweeps"]``
over the window's calls."""


def read(run):
    if run.kind != "blo":
        return None
    s = [r["stats"]["sweeps"] for r in run.records if "failed" not in r]
    return sum(s) / len(s) if s else None
