"""The device's idle share of a run's traced stretch."""


def idle_pct(run, kind: str):
    tr = run.trace
    if run.kind != kind or tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
