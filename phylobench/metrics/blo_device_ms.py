"""Device ms a BLO call: the union of every device operation's interval
in the traced stretch over the BLO calls in it. The device's share of
``blo_s``, which the host's pace moves far more from run to run."""


def read(run):
    tr = run.trace
    if run.kind != "blo" or tr is None or tr["busy_s"] <= 0 \
            or not tr["requests"]:
        return None
    return 1e3 * tr["busy_s"] / tr["requests"]
