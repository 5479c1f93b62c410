"""Closed-loop EM: back-to-back training jobs.

Each job starts from the initial parameters that set-up made once and runs
the configuration's iterations as the port's CLI does: one step, then the
loglik read to the host, which ends the iteration.  The window stops
starting iterations once ``seconds`` have passed and a whole job is done
(the answers the check reads).
"""

from __future__ import annotations

import math
import random
import time

import numpy as np

from portbench.tracing import span


def warm(prog) -> dict:
    """One whole job (every shape the window uses); the kernel launches of
    an iteration, by kernel."""
    before = prog.launches()
    params = prog.init
    for it in range(prog.iterations):
        params, ll = prog.step(params, it)
        float(ll)
    after = prog.launches()
    return {k: (after[k] - before[k]) / prog.iterations for k in after}


def window(prog, seconds: float, seed: int, tracer=None) -> dict:
    """Run the window; the end-to-end metrics, the spans, and the answers
    kept for the check: every iteration's loglik, job by job, and the
    parameters after each iteration of one whole job, drawn from the seed
    (the last whole job where the window ends before it).  With ``tracer``
    the loop runs until the tracer is done (at most ``seconds``) and its
    outputs are only the trace's."""
    keep_job = random.Random(seed).randrange(1, 8)
    t0 = time.perf_counter()
    iter_ms, enqueue_ms, lls_all = [], [], []
    last = None
    job, done = 0, False
    while not done:
        if tracer is not None:
            tracer.boundary()
            if tracer.done:
                break
        params, lls, th = prog.init, [], {0: prog.init}
        for it in range(prog.iterations):
            a = time.perf_counter()
            if a - t0 >= seconds and last is not None:
                done = True
                break
            with span(tracer, "portbench.step"):
                params, ll = prog.step(params, it)
            b = time.perf_counter()
            ll = float(ll)
            c = time.perf_counter()
            iter_ms.append((c - a) * 1e3)
            enqueue_ms.append((b - a) * 1e3)
            lls.append(ll)
            if tracer is not None and tracer.active:
                tracer.units += 1
            th[it + 1] = params
        lls_all.append(lls)
        if len(lls) == prog.iterations and (last is None or last[0] != keep_job):
            last = (job, th)
        job += 1
    elapsed = time.perf_counter() - t0
    if tracer is not None:
        tracer.close()
    flat = [x for lls in lls_all for x in lls]
    first = lls_all[0]
    return {
        "metrics": {"em_throughput": prog.n * len(flat) / elapsed,
                    "em_iter_ms_p95": float(np.percentile(iter_ms, 95))},
        "attempted": len(flat),
        "failed": sum(1 for x in flat if not math.isfinite(x)),
        "window_s": elapsed, "iterations": len(flat), "jobs": len(lls_all),
        "jobs_unlike_first": sum(1 for lls in lls_all if lls != first[:len(lls)]),
        "spans": {"enqueue_ms": enqueue_ms},
        "lls": lls_all, "kept": dict([last]) if last is not None else {},
    }
