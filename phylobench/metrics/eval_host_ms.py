"""Host ms of one evaluation inside the program: the mean duration of
the span ``pllmod.eval`` (the evaluator's call, P-matrices, walk launch
and root reduction issued, before the readback) over the traced
stretch's evaluations; the inside counterpart of ``issue_ms.eval``, read
under the profiler."""

from phylobench.spans import per_call_ms


def read(run):
    return per_call_ms(run, "eval", "pllmod.eval")
