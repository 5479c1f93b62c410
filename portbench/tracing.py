"""The traced stretch of a ``--trace 1`` run and what is read from it.

The measured window runs untraced, as in any run, and gives the span-based
metrics.  After it the same loop runs on under ``torch.profiler``: one unit
(a job or a pass, at whose boundaries the host has just read a result, so
the device is idle) as warm-up, which takes the profiler's start (seconds
on the card, and it drops a window's first kernels), then whole units until
at least ``TRACED_S`` seconds have been recorded.  Only that last stretch
is kept (the profiler's schedule).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
import time

TRACED_S = 0.5
CAP_S = 120.0  # the traced loop's limit, should the profiler never finish

# the length ranking that K2's, K4's and K3's C calls each launch first
# (``csrc/order.cuh``) counts with the kernel launched after it
RANK = "mwd_length_rank"
FAMILIES = {
    "K1": lambda n: "mwd_table_lookup" in n,
    "K2": lambda n: "mwd_estep_counts" in n,
    "K4": lambda n: "mwd_estep" in n and "mwd_estep_counts" not in n,
    "K7": lambda n: "mwd_pair_counts" in n,
    "K3": lambda n: "mwd_viterbi" in n,
    "gemm": lambda n: re.search(r"gemm|xmma|cutlass", n, re.IGNORECASE) is not None,
}


class Tracer:
    """Drives the profiler at the window's unit boundaries."""

    def __init__(self):
        self.state = "idle"  # idle -> warm -> active -> done
        self.prof = None
        self.t_start = self.t_active = self.t_end = None
        self.units = 0
        self.path = None

    def boundary(self) -> None:
        """Called at each unit boundary (before a job or a pass, when the
        device is idle).  The loop adds to ``units`` each iteration or pass
        it runs while ``active``, and stops once ``done``."""
        from torch.profiler import ProfilerActivity, profile, schedule

        now = time.perf_counter()
        if self.state == "idle":
            fd, self.path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
            os.close(fd)
            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: p.export_chrome_trace(self.path))
            self.prof.start()
            self.state, self.t_start = "warm", now
        elif self.state == "warm":
            self.prof.step()
            self.state, self.t_active = "active", time.perf_counter()
        elif self.state == "active" and now - self.t_active >= TRACED_S:
            self._finish(now)

    def _finish(self, now: float) -> None:
        self.t_end = now
        self.prof.step()
        self.prof.stop()
        self.state = "done"

    def close(self) -> None:
        """End the trace at the window's end if it is still recording."""
        if self.state == "active":
            self._finish(time.perf_counter())
        elif self.state == "warm":
            self.prof.stop()
            self.state = "done"

    @property
    def active(self) -> bool:
        return self.state == "active"

    @property
    def done(self) -> bool:
        return self.state == "done"

    def read(self) -> dict | None:
        """The traced stretch: {"window_s", "busy_s", "units", "kernels":
        [(name, start_us, dur_us)], "breakdown"}; None if nothing was
        traced."""
        if self.t_end is None or self.path is None or not os.path.getsize(self.path):
            return None
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.unlink(self.path)
        dev, kernels, host = [], [], []
        for e in events:
            cat = e.get("cat")
            item = (e.get("name", ""), float(e.get("ts", 0.0)), float(e.get("dur", 0.0)))
            if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
                dev.append(item)
                if cat == "kernel":
                    kernels.append(item)
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
                host.append(item)
        busy = _merge([(ts, ts + dur) for _, ts, dur in dev])
        busy_s = sum(b - a for a, b in busy) / 1e6
        return {"window_s": self.t_end - self.t_active, "busy_s": busy_s, "units": self.units,
                "kernels": kernels,
                "breakdown": {"device_ops": _top_ops(dev), "idle_gaps": _idle(busy, host)}}


def span(tracer, name: str):
    """A named range in the trace while ``tracer`` records; else nothing."""
    if tracer is None:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


def _top_ops(dev) -> list:
    total: dict[str, float] = {}
    for name, _, dur in dev:
        total[_short(name)] = total.get(_short(name), 0.0) + dur / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]


def _idle(busy, host, lookback: int = 256) -> list:
    """Idle device time between the traced stretch's device operations,
    summed by the innermost host event running at each gap's middle (among
    the ``lookback`` host events that started last before it)."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    total: dict[str, float] = {}
    for (_, b0), (a1, _) in zip(busy, busy[1:]):
        mid = 0.5 * (b0 + a1)
        i = bisect.bisect_right(starts, mid)
        inner = [h for h in host[max(0, i - lookback):i] if mid <= h[1] + h[2]]
        name = min(inner, key=lambda h: h[2])[0] if inner else "host (no traced event)"
        total[_short(name)] = total.get(_short(name), 0.0) + (a1 - b0) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:10]]


def _families(trace: dict) -> list:
    """[(family or None, dur_us)] of each traced kernel, the length ranking
    given the family of the next K2, K4 or K3 kernel."""
    kernels = sorted(trace["kernels"], key=lambda k: k[1])
    fams = [next((f for f, m in FAMILIES.items() if m(name)), None)
            for name, _, _ in kernels]
    nxt = None
    for i in range(len(kernels) - 1, -1, -1):
        if kernels[i][0].startswith(RANK) or RANK + "(" in kernels[i][0]:
            fams[i] = nxt
        elif fams[i] in ("K2", "K4", "K3"):
            nxt = fams[i]
    return [(f, dur) for f, (_, _, dur) in zip(fams, kernels)]


def family_ms(trace: dict | None, family: str) -> float | None:
    """Device ms per traced unit of the kernels of ``family``; None where
    the trace holds none."""
    if trace is None or not trace["units"]:
        return None
    total = sum(dur for f, dur in _families(trace) if f == family)
    return total / 1e3 / trace["units"] if total > 0 else None


def other_ms(trace: dict | None) -> float | None:
    """Device ms per traced unit of every kernel outside the families."""
    if trace is None or not trace["units"]:
        return None
    total = sum(dur for f, dur in _families(trace) if f is None)
    return total / 1e3 / trace["units"] if total > 0 else None
