"""CLV updates a second: (n_tips − 2) × compressed unpadded patterns ×
evaluations completed in the window, over the window's seconds."""

from phylobench.roofline import clv_updates


def read(run):
    if run.kind != "eval":
        return None
    done = sum("failed" not in r for r in run.records)
    return clv_updates(run.shape) * done / run.window_s
