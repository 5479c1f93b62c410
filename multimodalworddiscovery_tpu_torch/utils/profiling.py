"""Tracing / timing helpers.

Counterpart of ``multimodalworddiscovery_tpu/utils/profiling.py``:

  - ``trace(dir)``: a ``torch.profiler`` context that writes a Chrome
    trace (CPU ops and, on a CUDA host, the card's kernels) under the
    directory, viewable in Perfetto or chrome://tracing;
  - ``timeit``: mean seconds per call, with CUDA events after a
    synchronize when the result lies on the card.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome trace
    format) when it ends, even if it raised."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / "trace.json"))


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)


def timeit(fn, *args, reps: int = 10, warmup: int = 1, **kwargs) -> tuple[float, object]:
    """Mean seconds per call over ``reps`` calls after ``warmup`` calls ->
    (seconds, last output).  When the output holds a CUDA tensor the calls
    are timed with CUDA events after a synchronize; else by the host
    clock."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    if any(t.is_cuda for t in _leaves(out)):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            out = fn(*args, **kwargs)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / reps, out
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args, **kwargs)
    return (time.perf_counter() - t0) / reps, out
