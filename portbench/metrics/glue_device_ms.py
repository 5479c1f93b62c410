"""EM glue: device ms an iteration of every kernel that is not K1, K2, K4,
K7, K3 or a GEMM (the [N, S] and [S, S] ops of ``models.hmm_core`` and the
M-step), from the traced stretch."""

from portbench.tracing import other_ms


def read(ctx):
    return other_ms(ctx.trace)
