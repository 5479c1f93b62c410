"""The supervised ceiling of the stretch config at its shipped shape.

Counterpart of ``scripts/exp_ceiling_fullscale.py``.  The stretch config's
full-scale alignment F1 (N=4000, S=64, configs/stretch_hubert_clip.py) needs
a denominator at its own scale; this runs the dense-region study's ceiling
protocol there:

  ceiling      supervised GMM fit from GOLD alignments: ``supervised_counts``
               over ``--chunks`` slices of the corpus, summed (counts are
               additive, so the [N, Ts, C, K] responsibilities never exceed
               a slice), then ``m_step``; 5 times -> decode
  ceiling+EM   ``--iters`` exact chunked EM iterations on top (does the
               likelihood walk away from gold at this scale?)

Reports frame accuracy (the study's metric) and alignment F1 (the config's
metric) for each, one JSON line a variant.

    python -m multimodalworddiscovery_tpu_torch.scripts.exp_ceiling_fullscale   # N=4000
    python -m multimodalworddiscovery_tpu_torch.scripts.exp_ceiling_fullscale \\
        --n 16 --iters 2 --feat-dim 4 --concepts 10 2 3 --device cpu

The device is "cuda" unless ``--device`` names another ("cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian
from multimodalworddiscovery_tpu_torch.models.bucketed import chunked_expected_counts
from multimodalworddiscovery_tpu_torch.scripts.exp_gauss_dense import (
    DENSE,
    MAX_JUMP,
    accuracy,
    build_corpus,
    chunks_of,
    word_mask,
)

SUPERVISED_ROUNDS = 5  # the study's supervised_fit iteration count
# the JAX package's values at N=4000 (docs/PERFORMANCE.md:464-470): frame
# accuracy / alignment F1
DOCUMENTED = {"supervised_ceiling": (0.511, 0.502), "ceiling_plus_10_em": (0.466, 0.469)}


def chunked_supervised_fit(params, corpus, gold, chunks: int,
                           rounds: int = SUPERVISED_ROUNDS):
    """``rounds`` x (``supervised_counts`` summed over ``chunks`` slices,
    then ``m_step``)."""
    csz = -(-corpus.n // chunks)
    for _ in range(rounds):
        total = None
        for i, c in enumerate(chunks_of(corpus, chunks)):
            cts = hmm_gaussian.supervised_counts(params, c, gold[i * csz:(i + 1) * csz])
            total = cts if total is None else {k: total[k] + v for k, v in cts.items()}
        params = hmm_gaussian.m_step(params, total)
    return params


def chunked_em(params, corpus, iters: int, chunks: int):
    """``iters`` exact EM iterations, the E-step over ``chunks`` slices."""
    for _ in range(iters):
        counts, _ = chunked_expected_counts(hmm_gaussian, params, corpus, chunks)
        params = hmm_gaussian.m_step(params, counts)
    return params


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--concepts", type=int, nargs=3, default=list(DENSE),
                    metavar=("VOCAB", "MIN", "MAX"),
                    help="concept vocabulary and concepts an image (small for a quick run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    _, _, fc, fg = build_corpus(args.n, args.feat_dim, args.device, tuple(args.concepts))
    gold = torch.as_tensor(fg.alignment, device=args.device)
    wm = word_mask(fc, fg.alignment)
    print(json.dumps({"corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len}), flush=True)
    variants = {}

    def measure(p, label: str, t0: float) -> None:
        pred = hmm_gaussian.align(p, fc)
        f1 = float(alignment_prf(pred, gold, fc.src_mask())["f1"])
        acc = accuracy(pred.cpu().numpy(), fg.alignment, wm)
        variants[label] = {"frame_acc": acc, "alignment_f1": f1,
                           "seconds": time.perf_counter() - t0}
        print(json.dumps({"variant": label, **variants[label]}), flush=True)

    params = hmm_gaussian.init(fc, max_jump=MAX_JUMP, n_components=2,
                               generator=torch.Generator().manual_seed(0))
    t0 = time.perf_counter()
    p = chunked_supervised_fit(params, fc, gold, args.chunks)
    measure(p, "supervised_ceiling", t0)
    t0 = time.perf_counter()
    p_em = chunked_em(p, fc, args.iters, args.chunks)
    measure(p_em, f"ceiling_plus_{args.iters}_em", t0)
    device = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" \
        else "cpu"
    return {"study": "exp_ceiling_fullscale", "corpus": list(fc.src.shape),
            "states": 2 * fc.max_trg_len, "n": args.n, "chunks": args.chunks,
            "iters": args.iters, "device": device, "variants": variants}


if __name__ == "__main__":
    main()
