"""Checkpoints of parameter trees with ``torch.save``.

Counterpart of ``multimodalworddiscovery_tpu/utils/checkpoint.py`` (orbax
there).  Every EM iteration or training step can checkpoint the whole
parameter tree (tensors, ``nn.Module``s, optimizer states, step counters,
in dataclasses, dicts and tuples) plus the step, so runs resume exactly.

Layout: ``<directory>/<step>/state.pt``.  A save writes into a temporary
directory beside it and renames it into place, so a reader sees a whole
checkpoint or none; under a ``torch.distributed`` process group only rank
0 writes (the ranks' parameters are identical) and every rank waits at a
barrier until it has.  The newest ``max_to_keep`` checkpoints are kept.

A step directory without ``state.pt`` is the reference's orbax format,
which this package cannot read: ``restore`` raises and says so (it never
starts a run fresh in its place).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import shutil
import tempfile
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

STATE_FILE = "state.pt"


def _to_state(x: Any) -> Any:
    """A tree of plain containers and CPU tensors (what ``torch.load``
    reads with ``weights_only=True``)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    if isinstance(x, nn.Module):
        return {k: v.detach().cpu() for k, v in x.state_dict().items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _to_state(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: _to_state(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_to_state(v) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    raise TypeError(f"cannot checkpoint a {type(x).__name__}")


def _from_state(template: Any, state: Any, path: str) -> Any:
    """``state`` laid onto ``template``'s structure, each tensor on the
    template tensor's device and in its dtype; numbers and strings are the
    saved ones."""
    if isinstance(template, torch.Tensor):
        if not isinstance(state, torch.Tensor) or tuple(state.shape) != tuple(template.shape):
            got = tuple(state.shape) if isinstance(state, torch.Tensor) else type(state).__name__
            raise ValueError(f"checkpoint leaf {path or '<root>'}: saved {got}, "
                             f"template {tuple(template.shape)}")
        return state.to(device=template.device, dtype=template.dtype)
    if isinstance(template, nn.Module):
        module = copy.deepcopy(template)
        module.load_state_dict(state)
        return module
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _from_state(getattr(template, f.name), state[f.name], f"{path}/{f.name}")
            for f in dataclasses.fields(template) if f.init})
    if isinstance(template, dict):
        if set(template) != set(state):
            raise ValueError(f"checkpoint node {path or '<root>'}: saved keys {sorted(state)}, "
                             f"template keys {sorted(template)}")
        return {k: _from_state(v, state[k], f"{path}/{k}") for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        if len(template) != len(state):
            raise ValueError(f"checkpoint node {path or '<root>'}: saved {len(state)} items, "
                             f"template {len(template)}")
        return type(template)(_from_state(t, s, f"{path}/{i}")
                              for i, (t, s) in enumerate(zip(template, state)))
    return state


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


class CheckpointManager:
    """(params, step) checkpoints under one directory."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self.directory = Path(directory).absolute()
        self.max_to_keep = max_to_keep
        if _rank0():
            self.directory.mkdir(parents=True, exist_ok=True)

    def _steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def save(self, step: int, params: Any, extra: dict | None = None) -> None:
        """Write step ``step`` (rank 0 only under a process group; every
        rank returns once it is on disk)."""
        if _rank0():
            state = {"step": int(step), "params": _to_state(params)}
            if extra:
                state["extra"] = _to_state(extra)
            self.directory.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix=f".tmp-{step}-", dir=self.directory))
            try:
                torch.save(state, tmp / STATE_FILE)
                final = self.directory / str(step)
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            ours = [s for s in self._steps() if (self.directory / str(s) / STATE_FILE).exists()]
            for old in ours[:-self.max_to_keep] if self.max_to_keep else []:
                shutil.rmtree(self.directory / str(old), ignore_errors=True)
        if dist.is_initialized():
            dist.barrier()

    def latest_step(self) -> int | None:
        """The newest step on disk (an orbax step of the reference counts
        too, so a resume tries it and fails loudly instead of starting
        fresh)."""
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, params_template: Any, step: int | None = None) -> tuple[Any, int]:
        """Restore (params, step); the template gives the structure, devices
        and dtypes."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        d = self.directory / str(step)
        if not (d / STATE_FILE).exists():
            raise RuntimeError(
                f"{d} is not a checkpoint of this package (no {STATE_FILE}): it looks like an "
                "orbax checkpoint of the JAX package, which the PyTorch port cannot read; "
                "train again with --fresh (or in a new workdir), or carry the parameters "
                "across through `mwd export` and the models' params_from_numpy")
        state = torch.load(d / STATE_FILE, map_location="cpu", weights_only=True)
        return _from_state(params_template, state["params"], ""), int(state["step"])

    def close(self) -> None:
        pass
