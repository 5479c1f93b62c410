"""Gaussian log densities and moments: device ms an iteration of the GEMM
kernels (cuBLAS), from the traced stretch."""

from portbench.tracing import family_ms


def read(ctx):
    return family_ms(ctx.trace, "gemm")
