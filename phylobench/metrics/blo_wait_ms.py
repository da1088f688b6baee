"""Host ms a BLO call spends blocked on the card: the mean, over the
traced stretch's ``pllmod.blo`` spans, of their ``pllmod.blo.wait``
spans (each sweep's and polish sweep's logL, the final logL, the Newton
iteration count and the lengths' write-back read to the host)."""

from phylobench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "blo", "pllmod.blo", "pllmod.blo.wait")
