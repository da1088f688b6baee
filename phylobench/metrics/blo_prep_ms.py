"""Host ms of a BLO call's preparation: the mean, over the traced
stretch's ``pllmod.blo`` spans, of their ``pllmod.blo.prep`` span (the
directed traversal, its kernel tables, the edge colours, the edge-id
tensors and the lengths' upload), which a schedule cached across calls
would remove."""

from phylobench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "blo", "pllmod.blo", "pllmod.blo.prep")
