"""Tracing helpers.

Counterpart of ``multimodalworddiscovery_tpu/utils/profiling.py``:

  - ``span(name)``: a named range around one layer of the port (the
    ``mwd.*`` names at the model and op boundaries).  Off by default, when
    it costs one read of a flag and does nothing else;
  - ``spans()``: turns the spans on around a block and hands back their
    table, {name: [host nanoseconds, calls]};
  - ``trace(dir)``: a ``torch.profiler`` context, spans on, that writes a
    Chrome trace (CPU ops, the ``mwd.*`` spans and, on a CUDA host, the
    card's kernels) under the directory, viewable in Perfetto or
    chrome://tracing, and the spans' table beside it.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path

import torch

_on = False
_table: dict[str, list[int]] = {}


class _Off:
    """The span while spans are off: enters and leaves doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    """The span while spans are on: adds its host time and one call to the
    table, and is a ``record_function`` range while a profiler records."""

    __slots__ = ("name", "t0", "rf")

    def __init__(self, name: str):
        self.name = name
        self.rf = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        dt = time.perf_counter_ns() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        entry = _table.get(self.name)
        if entry is None:
            _table[self.name] = [dt, 1]
        else:
            entry[0] += dt
            entry[1] += 1
        return False


def span(name: str):
    """A context manager around one layer's call: the shared no-op while
    spans are off (no clock read, no allocation, never a device sync)."""
    if not _on:
        return _OFF
    return _Span(name)


@contextlib.contextmanager
def spans():
    """Turn the spans on for the block; yields the table the block's spans
    fill, {name: [host nanoseconds, calls]}.  The state before the block
    (off, or another block's table) comes back when it ends."""
    global _on, _table
    before = (_on, _table)
    _on, _table = True, {}
    try:
        yield _table
    finally:
        _on, _table = before


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the block, spans on, and write ``<log_dir>/trace.json``
    (Chrome trace format) and ``<log_dir>/spans.json`` (each span's host
    ms, under the profiler, and calls) when it ends, even if it raised."""
    from torch.profiler import ProfilerActivity, profile

    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    table: dict[str, list[int]] = {}
    try:
        with spans() as table:
            yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(str(out / "trace.json"))
        (out / "spans.json").write_text(json.dumps(
            {name: {"host_ms": ns / 1e6, "calls": calls}
             for name, (ns, calls) in sorted(table.items())}, indent=1))
