"""Carry a flax parameter tree (numpy arrays) onto a torch module.

The reference's networks are flax modules; the port's are ``nn.Module``s
with the same layers.  ``load_flax_tree`` reads the flax array of each
torch parameter, in the torch module's parameter order, and converts its
layout by the torch layer's type:

  nn.Linear    weight [out, in] from a Dense kernel [in, out], a
               DenseGeneral((h, d)) kernel [in, h, d] or a
               DenseGeneral(axis=(-2, -1)) kernel [h, d, out]; bias flattened
  nn.Conv1d    weight [out, in, w] from a Conv kernel [w, in, out]
  nn.Conv2d    weight [out, in, kh, kw] from a Conv kernel [kh, kw, in, out]
  nn.Embedding weight from ``embedding``, as it is
  nn.LayerNorm weight / bias from ``scale`` / ``bias``
  a bare nn.Parameter of the module (a position table), as it is

A torch submodule's flax name is its attribute name, renamed by the
caller's table (flax names auto-generated submodules ``LayerNorm_0``,
``Dense_1``, ...); ``enc.0`` (an ``nn.ModuleList`` entry) becomes ``enc_0``.
The same function reads an optimizer's moment trees, which share the
parameters' layout.  ``flax_init`` draws a module's weights as flax
initialises these layers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from multimodalworddiscovery_tpu_torch.models import hmm_dnn


def _flax_leaf(module: nn.Module, pname: str) -> str:
    if pname == "bias":
        return "bias"
    if isinstance(module, nn.LayerNorm):
        return "scale"
    if isinstance(module, nn.Embedding):
        return "embedding"
    return "kernel" if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)) else pname


def _to_torch_layout(module: nn.Module, pname: str, a: np.ndarray, shape) -> np.ndarray:
    if pname == "weight" and isinstance(module, nn.Linear):
        return a.reshape(shape[1], shape[0]).T
    if pname == "weight" and isinstance(module, nn.Conv1d):
        return a.transpose(2, 1, 0)
    if pname == "weight" and isinstance(module, nn.Conv2d):
        return a.transpose(3, 2, 0, 1)
    return a.reshape(shape)


def flax_paths(model: nn.Module, rename: dict[str, str]) -> list[tuple[str, ...]]:
    """Each parameter's path in the flax tree, in ``model.parameters()`` order."""
    paths = []
    for mod_name, module in model.named_modules():
        prefix = []
        parts = mod_name.split(".") if mod_name else []
        i = 0
        while i < len(parts):
            if i + 1 < len(parts) and parts[i + 1].isdigit():  # a ModuleList entry
                prefix.append(f"{parts[i]}_{parts[i + 1]}")
                i += 2
            else:
                prefix.append(rename.get(parts[i], parts[i]))
                i += 1
        for pname, _ in module.named_parameters(recurse=False):
            paths.append((*prefix, _flax_leaf(module, pname)))
    return paths


def load_flax_tree(model: nn.Module, tree: dict, rename: dict[str, str],
                   device) -> list[torch.Tensor]:
    """The flax tree's arrays (optionally under "params") in ``model``'s
    parameter order, each in its torch layout, as float32 tensors on
    ``device``."""
    tree = tree.get("params", tree)
    out = []
    owners = [(m, pname) for _, m in model.named_modules()
              for pname, _ in m.named_parameters(recurse=False)]
    for (module, pname), path, p in zip(owners, flax_paths(model, rename), model.parameters()):
        a = tree
        for k in path:
            a = a[k]
        a = np.asarray(a, dtype=np.float32)
        out.append(torch.tensor(_to_torch_layout(module, pname, a, tuple(p.shape)),
                                device=device))
    return out


def copy_into(model: nn.Module, tensors) -> None:
    """Copy ``tensors`` into ``model``'s parameters, in order."""
    with torch.no_grad():
        for p, x in zip(model.parameters(), tensors):
            p.copy_(x)


def flax_init(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisation of ``model``'s layers, drawn on the CPU
    from ``generator``: Dense and Conv kernels lecun normal (a normal
    truncated at +-2 sigma, sigma = 1/sqrt(fan_in) / 0.8796, fan_in the
    kernel's size over all but its output axis, in * kh * kw for a 2-D
    convolution), biases 0,
    embeddings normal with std 1/sqrt(features), LayerNorm scales 1 and
    biases 0.  Parameters of other layers are left as they are."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv1d, nn.Conv2d)):
                w = module.weight
                std = 1.0 / math.sqrt(w[0].numel()) / hmm_dnn.TRUNC_STD
                w.copy_(hmm_dnn.truncated_normal(w.shape, generator) * std)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                w = module.weight
                w.copy_(torch.randn(w.shape, generator=generator) / math.sqrt(w.shape[1]))
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
