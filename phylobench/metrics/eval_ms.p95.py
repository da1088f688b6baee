"""The 95th percentile of every evaluation's latency in the window, in
ms: host clock from the evaluator's call until its logL is on the
host."""

import numpy as np


def read(run):
    if run.kind != "eval":
        return None
    lat = [r["latency_s"] for r in run.records if "failed" not in r]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
