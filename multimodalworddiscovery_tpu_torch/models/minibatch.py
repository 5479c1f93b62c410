"""Minibatch training for the gradient-based aligners (attention, grounding).

Counterpart of ``multimodalworddiscovery_tpu/models/minibatch.py``, its
single-device half: the corpus stays on the device, and each step gathers a
random minibatch there (one ``index_select`` per corpus field) and runs the
model step on it.  Teacher signals (the HMM guide of guided attention) are
computed per batch inside the step function.  The draws come from a
``torch.Generator``: a CPU generator draws on the CPU (one seed, one
sequence on every machine) and the indices go to the corpus's device.

The data-parallel forms (a mesh, ``sample="local"``,
``sample_local_batch``) and the streamed trainer
(``train_minibatch_streaming``) wait for the port's mesh and streaming
(ROADMAP queue 1, items 6 and 7); until then they raise
NotImplementedError.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus

StepFn = Callable[[Any, Corpus], tuple[Any, dict]]
DATA_AXIS = "data"
_WAITS = ("waits for the port's {} (ROADMAP queue 1, items 6-7: the mesh and "
          "data-parallel EM, and data/stream)")


def gather_batch(corpus: Corpus, idx: torch.Tensor) -> Corpus:
    """Static-shape minibatch: one gather per corpus field, on its device."""
    idx = idx.to(corpus.device).long()
    take = lambda x: x.index_select(0, idx)  # noqa: E731
    return Corpus(src=take(corpus.src), src_len=take(corpus.src_len), trg=take(corpus.trg),
                  trg_len=take(corpus.trg_len), src_vocab=corpus.src_vocab,
                  trg_vocab=corpus.trg_vocab)


def sample_local_batch(corpus: Corpus, generator, batch_size: int, mesh,
                       axis_name: str = DATA_AXIS):
    """Per-device stratified minibatch over a sharded corpus."""
    raise NotImplementedError("sample_local_batch " + _WAITS.format("mesh"))


def make_minibatch_step(
    step_fn: StepFn,
    corpus: Corpus,
    batch_size: int,
    mesh=None,
    axis_name: str = DATA_AXIS,
    sample: str = "global",
    bind_corpus: bool = True,
):
    """``(state, generator) -> (state, stats)`` sampling a fresh minibatch.

    ``step_fn(state, batch) -> (state, stats)`` is any model step (its guide
    or teacher logic runs inside, per batch).  ``sample="global"`` draws
    uniformly without replacement from the whole corpus (a prefix of a
    random permutation); ``sample="valid"`` uniformly with replacement over
    the rows with src_len > 0 (a shard padded with zero-length utterances
    never burns steps on padding).  With ``bind_corpus=False`` the step is
    ``(state, generator, corpus)``, one step for same-shape corpora.
    """
    n = corpus.n
    if batch_size > n:
        raise ValueError(f"batch_size {batch_size} > corpus size {n}")
    if sample not in ("global", "local", "valid"):
        raise ValueError(f"sample must be global|local|valid, got {sample!r}")
    if mesh is not None or sample == "local":
        raise NotImplementedError("make_minibatch_step with a mesh or sample='local' "
                                  + _WAITS.format("mesh"))

    def step(state, generator: torch.Generator, c: Corpus):
        if sample == "valid":
            probs = (c.src_len > 0).to(torch.float32).to(generator.device)
            idx = torch.multinomial(probs, batch_size, replacement=True, generator=generator)
        else:
            idx = torch.randperm(c.n, generator=generator, device=generator.device)[:batch_size]
        return step_fn(state, gather_batch(c, idx))

    if not bind_corpus:
        return step
    return lambda state, generator: step(state, generator, corpus)


def train_minibatch_streaming(step_fn: StepFn, state, reader, batch_size: int,
                              num_steps: int, **kwargs):
    """Out-of-core minibatch SGD over streamed corpus shards."""
    raise NotImplementedError("train_minibatch_streaming " + _WAITS.format("data/stream"))


def train_minibatch(
    step_fn: StepFn,
    state,
    corpus: Corpus,
    batch_size: int,
    num_steps: int,
    generator: torch.Generator | None = None,
    mesh=None,
):
    """``num_steps`` minibatch steps -> (state, per-step logliks as floats).
    The draws come from ``generator`` (a CPU generator seeded 0 when None);
    the logliks stay on the device until the loop ends."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    one = make_minibatch_step(step_fn, corpus, batch_size, mesh=mesh)
    lls = []
    for _ in range(num_steps):
        state, stats = one(state, generator)
        lls.append(stats["loglik"])
    return state, (torch.stack(lls).tolist() if lls else [])
