"""Scale measurement: the minibatch CRF aligner at 40,000 utterances.

Counterpart of ``scripts/exp_crf40k.py``, on the corpus of
``scripts/self_train.py``'s 40k recipe (the same generator and seed), in
both transition modes:

  em_trans   ``hmm_dnn.init``; each step's transitions from the closed-form
             M-step (``hmm_crf.em_step``)
  e2e_trans  ``hmm_crf.init_e2e``; the transitions trained by Adam through
             the CRF moment gradient (``learn_transitions=True``)

Each mode runs ``models/minibatch.train_minibatch`` (B=512, 500 steps; K4
through the CRF's ``logmarginal`` on every batch), then decodes the corpus in
8 chunks (K3) and scores positional accuracy.  One JSON line a mode, with
``ms_per_step`` (CUDA events around the training loop on the card, the host
clock on the CPU), ``acc``, ``ll_first`` and ``ll_last``.

    python -m multimodalworddiscovery_tpu_torch.scripts.exp_crf40k
    python -m multimodalworddiscovery_tpu_torch.scripts.exp_crf40k \\
        --utterances 64 --batch-size 16 --steps 3 --device cpu

The device is "cuda" unless ``--device`` names another ("cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import functools
import json
import time

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.models import hmm_crf, hmm_dnn
from multimodalworddiscovery_tpu_torch.models.minibatch import train_minibatch
from multimodalworddiscovery_tpu_torch.scripts.exp_gauss_dense import chunks_of, word_mask
from multimodalworddiscovery_tpu_torch.scripts.self_train import build_corpus

MODES = ("em_trans", "e2e_trans")
DECODE_CHUNKS = 8
# the JAX package's positional accuracies at N=40,000, B=512, 500 steps
# (docs/PERFORMANCE.md:414-419)
DOCUMENTED = {"em_trans": 0.960, "e2e_trans": 0.987}


def chunked_accuracy(params, corpus, gold_alignment: np.ndarray, mask: np.ndarray,
                     chunks: int = DECODE_CHUNKS) -> float:
    """Decode ``chunks`` slices of the corpus (bounding the decode's
    memory), then positional accuracy over the scored frames."""
    pred = np.concatenate([hmm_crf.align(params, c).cpu().numpy()
                           for c in chunks_of(corpus, chunks)], axis=0)
    return float((pred == gold_alignment)[mask].mean())


def train_mode(mode: str, corpus, batch_size: int, steps: int):
    """Initial parameters of ``mode`` (weights from a CPU generator seeded
    0), then ``steps`` minibatch CRF steps (draws seeded 1) -> (params,
    per-step logliks, ms per step)."""
    lt = mode == "e2e_trans"
    init = hmm_crf.init_e2e if lt else hmm_dnn.init
    params = init(corpus, generator=torch.Generator().manual_seed(0))
    step_fn = functools.partial(hmm_crf.em_step, learn_transitions=lt)
    gen = torch.Generator().manual_seed(1)
    if corpus.device.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        params, lls = train_minibatch(step_fn, params, corpus, batch_size, steps, generator=gen)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
    else:
        t0 = time.perf_counter()
        params, lls = train_minibatch(step_fn, params, corpus, batch_size, steps, generator=gen)
        ms = 1e3 * (time.perf_counter() - t0)
    return params, lls, ms / max(steps, 1)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=40_000)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    fc, fg = build_corpus(args.utterances, args.device)
    wm = word_mask(fc, fg.alignment)
    print(json.dumps({"corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len}), flush=True)
    device = torch.cuda.get_device_name(0) if fc.device.type == "cuda" else "cpu"
    rows = {}
    for mode in MODES:
        params, lls, ms = train_mode(mode, fc, args.batch_size, args.steps)
        acc = chunked_accuracy(params, fc, fg.alignment, wm)
        rows[mode] = dict(mode=mode, n=fc.n, batch=args.batch_size, steps=args.steps,
                          seconds=ms * args.steps / 1e3, ms_per_step=ms, acc=acc,
                          ll_first=lls[0], ll_last=lls[-1], device=device)
        print(json.dumps(rows[mode]), flush=True)
    return {"study": "exp_crf40k", "corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len,
            "device": device, "modes": rows}


if __name__ == "__main__":
    main()
