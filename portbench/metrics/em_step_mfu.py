"""The whole EM iteration's share of one H100's float32 peak, in percent:
the iteration's model operations (``portbench.counts``: the E-step's
7 S^2 an utterance-step, and the Gaussian's four products) over the
window's wall time an iteration (the window over its iterations), at
67 TFLOP/s."""

from portbench.counts import FP32_OPS_PER_S


def read(ctx):
    w = ctx.window
    if not w["iterations"]:
        return None
    return 100.0 * ctx.work["step_ops"] * w["iterations"] / (w["window_s"] * FP32_OPS_PER_S)
