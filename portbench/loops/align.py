"""Closed-loop decode: set-up trains one EM job, then the window decodes
the whole corpus again and again, each pass ending with the alignments
copied to the host, as the port's ``align`` command needs them.  The copy
goes into one page-locked host buffer that set-up makes (on a card), not
into a fresh pageable array each pass, whose allocation and page faults
are the host's and not the decode's."""

from __future__ import annotations

import random
import time

import torch

from portbench.tracing import span


def warm(prog, train_iterations: int):
    """Train the job set-up holds (one EM job of ``train_iterations``) and
    decode once into the host buffer; (the parameters, the kernel launches
    of one pass)."""
    params = prog.train(train_iterations)
    before = prog.launches()
    out = prog.decode_device(params)
    prog.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=out.is_cuda)
    prog.host.copy_(out)
    after = prog.launches()
    return params, {k: after[k] - before[k] for k in after}


def window(prog, params, seconds: float, seed: int, tracer=None) -> dict:
    """Run the window; the end-to-end metric, the spans, and the answers
    kept for the check: the first pass's, one drawn from the seed and the
    last one's.  With ``tracer`` the loop runs until the tracer is done (at
    most ``seconds``)."""
    keep_pass = random.Random(seed).randrange(1, 50)
    t0 = time.perf_counter()
    passes, kept, enqueue_ms, out = 0, {}, [], None
    while time.perf_counter() - t0 < seconds:
        if tracer is not None:
            tracer.boundary()
            if tracer.done:
                break
        a = time.perf_counter()
        with span(tracer, "portbench.decode"):
            out = prog.decode_device(params)
        b = time.perf_counter()
        prog.host.copy_(out)
        enqueue_ms.append((b - a) * 1e3)
        if passes in (0, keep_pass):
            kept[passes] = prog.host.numpy().copy()
        if tracer is not None and tracer.active:
            tracer.units += 1
        passes += 1
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        tracer.close()
    kept[passes - 1] = prog.host.numpy().copy()
    return {
        "metrics": {"align_throughput": prog.n * passes / elapsed},
        "attempted": prog.n * passes, "window_s": elapsed, "passes": passes,
        "spans": {"enqueue_ms": enqueue_ms}, "kept": kept,
    }
