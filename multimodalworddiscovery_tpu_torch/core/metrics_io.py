"""JSONL metrics writer.

Counterpart of ``multimodalworddiscovery_tpu/core/metrics_io.py``: every
run appends structured records (the same JSONL records as the reference)
for the evaluator and the benchmarks.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch


def _to_jsonable(v: Any) -> Any:
    """Numbers, numpy values and tensors (0-d: a number, else a list), in
    dicts, lists and tuples, as JSON values."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return v.item() if v.ndim == 0 else v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, dict):
        return {k: _to_jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_to_jsonable(x) for x in v]
    return v


class MetricsWriter:
    """Append-only JSONL metrics log, with optional TensorBoard scalars.

    ``tensorboard_dir``: when set (CLI: ``train.tensorboard=true`` writes to
    ``<workdir>/tb``), every scalar metric is also written as a TensorBoard
    scalar through ``torch.utils.tensorboard``, which needs the
    ``tensorboard`` package; it is imported only then, and its absence is
    an error naming it.  JSONL stays the source of truth.
    """

    def __init__(self, path: str | Path, tensorboard_dir: str | Path | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._tb = None
        if tensorboard_dir is not None:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError as e:
                raise ImportError(
                    "train.tensorboard=true needs the 'tensorboard' package, which is not "
                    f"installed ({e}); set train.tensorboard=false (the JSONL log is "
                    "written either way)") from e
            self._tb = SummaryWriter(log_dir=str(tensorboard_dir))

    def write(self, step: int, **metrics: Any) -> None:
        rec = {"step": step, "time": time.time(), **_to_jsonable(metrics)}
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            for k, v in rec.items():
                if k not in ("step", "time") and isinstance(v, (int, float)):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.close()

    def read_all(self) -> list[dict]:
        if not self.path.exists():
            return []
        with self.path.open() as f:
            return [json.loads(line) for line in f if line.strip()]
