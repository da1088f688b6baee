"""The whole evaluation's share of the card's float32 peak, in %: 100 ×
the dense pruning operations of the evaluations completed in the window
(phylobench.roofline, counted from the tree and the shapes) over the
window's seconds and 67 TFLOP/s. Every kernel, launch gap and readback
of the timed path is in the denominator, so a kernel taken off the path
still counts here."""

from phylobench.roofline import F32_FLOPS, eval_flops


def read(run):
    if run.kind != "eval" or run.window_s <= 0:
        return None
    done = sum("failed" not in r for r in run.records)
    s = run.shape
    flops = eval_flops(s["n_tips"], s["n_patterns"], s["C"], s["S"],
                       s["n_codes"])
    return 100.0 * flops * done / (run.window_s * F32_FLOPS)
