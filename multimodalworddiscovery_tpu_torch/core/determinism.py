"""The two pieces that keep the gradient steps reproducible on the card.

One seed and one input give the same bits in every run, as the reference's
jitted steps do.  Two backward passes of the models would not on their own:

- an embedding lookup's autograd backward adds its rows into the weight
  with atomics, in an order that changes from run to run.
  ``FixedOrderEmbedding`` is ``nn.Embedding`` with ``core.counts.embed_rows``
  as its lookup, whose backward is ``segment_sum``'s one-hot product taken
  in a fixed order;
- cuDNN picks convolution backward algorithms that add with atomics unless
  asked for deterministic ones.  ``deterministic_convolutions()`` asks for
  them around a step's loss and gradient only: nothing outside the step
  changes, and inside it cuDNN stays on and TF32 as the caller set it.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from multimodalworddiscovery_tpu_torch.core.counts import embed_rows


class FixedOrderEmbedding(nn.Embedding):
    """``nn.Embedding`` (the same parameter, state dict and flax mapping)
    whose weight gradient sums in a fixed order (``embed_rows``)."""

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return embed_rows(self.weight, ids)


@contextlib.contextmanager
def deterministic_convolutions():
    """cuDNN's deterministic algorithms, chosen by its heuristics (no
    benchmarking), inside the block; every flag restored on exit, after an
    exception too.  ``enabled`` and ``allow_tf32`` keep the caller's values:
    ``torch.backends.cudnn.flags()``' own defaults are cuDNN off and TF32
    on."""
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                     allow_tf32=cudnn.allow_tf32):
        yield
