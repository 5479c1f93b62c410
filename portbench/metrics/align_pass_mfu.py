"""A whole decode pass's share of one H100's float32 peak, in percent:
the pass's operations (``portbench.counts``: an add and a max
per transition, 2 S^2 an utterance-step) over the
window's wall time a pass (the window over its passes), at 67 TFLOP/s."""

from portbench.counts import FP32_OPS_PER_S


def read(ctx):
    w = ctx.window
    if not w["passes"]:
        return None
    return 100.0 * ctx.work["step_ops"] * w["passes"] / (w["window_s"] * FP32_OPS_PER_S)
