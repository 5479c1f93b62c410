"""K3's share of its roofline, in percent: the least time one H100 could
take for the kernel's work in one unit (portbench.counts) over its
device time in one unit, from the traced stretch."""

from portbench.tracing import family_ms


def read(ctx):
    bound = ctx.work["bounds_ms"].get("K3")
    ms = family_ms(ctx.trace, "K3")
    if bound is None or ms is None:
        return None
    return 100.0 * bound / ms
