"""Host ms a BLO call spends working: the mean, over the traced
stretch's ``pllmod.blo`` spans, of their duration less their
``pllmod.blo.wait`` spans (the readbacks): the driver's Python and the
launches it issues, while the card may idle."""

from phylobench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "blo", "pllmod.blo", less="pllmod.blo.wait")
