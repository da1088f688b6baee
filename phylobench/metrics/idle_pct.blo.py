"""The device's idle share of the traced stretch of a BLO cell, in %:
100 × (1 − union of device operation intervals / the stretch)."""

from phylobench.idle import idle_pct


def read(run):
    return idle_pct(run, "blo")
