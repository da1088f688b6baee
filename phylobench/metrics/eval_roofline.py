"""One evaluation's share of its roofline, in %: 100 × the least time of
one evaluation (phylobench.roofline: the larger of the dense pruning
operations over 67 TFLOP/s and the compulsory bytes over 3.35 TB/s; at
both cells' shapes the operations bound it) over the device's busy time
an evaluation, the union of every device operation's interval in the
traced stretch over the evaluations in it. Whatever kernels carry the
evaluation, the same work is counted."""

from phylobench.roofline import eval_least_s


def read(run):
    tr = run.trace
    if run.kind != "eval" or tr is None or tr["busy_s"] <= 0 \
            or not tr["requests"]:
        return None
    least, _ = eval_least_s(run.shape)
    return 100.0 * least / (tr["busy_s"] / tr["requests"])
