"""Decode loop: host milliseconds from a pass's ``align`` call to its return,
before the copy to the host, mean over the window's passes.  The
benchmark's own span."""


def read(ctx):
    ms = ctx.window["spans"]["enqueue_ms"]
    return sum(ms) / len(ms) if ms else None
