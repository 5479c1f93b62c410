"""EM loop: host milliseconds from an iteration's step call to its return,
before the loglik read (the enqueue of one EM iteration), mean over the
window's iterations.  The benchmark's own span."""


def read(ctx):
    ms = ctx.window["spans"]["enqueue_ms"]
    return sum(ms) / len(ms) if ms else None
