"""Dense-region Gaussian-HMM quality study: task bound or optimisation failure?

Counterpart of ``scripts/exp_gauss_dense.py``.  The stretch config's flat
start reaches about 0.15 frame alignment accuracy; this study asks whether
that is a bound of the synthetic dense-region corpus or a failure of EM:

  ceiling         supervised GMM fit from GOLD alignments
                  (``hmm_gaussian.supervised_fit``) -> Viterbi decode; it
                  bounds every unsupervised scheme
  ceiling+EM      10 exact EM iterations from the ceiling (does the
                  likelihood walk away from gold?)
  global          symmetric global-mean init -> EM
  diagonal        uniform-alignment flat start -> EM
  diag+anneal     deterministic annealing (beta 0.25 -> 1 over 6 iterations)
                  on the flat start
  random          decode accuracy of the untrained diagonal init (floor)
  control         the discrete HMM on the underlying phone tokens
  VQ teacher      k-means codes (``quantize_frames``) -> discrete-HMM EM on
                  them, decoded by the teacher itself; then the Gaussian
                  emissions seeded from its posteriors (``seed_from_teacher``)
                  and 10 EM iterations on top (the stretch recipe's stages)

Shapes follow configs/stretch_hubert_clip.py (200 concepts, 16-32 per image,
64-d frames); ``--n`` scales the corpus.  The EM is exact and chunked
(``models/bucketed.chunked_expected_counts``, ``--chunks`` slices), as the
stretch config's ``train.corpus_chunks``; decode runs chunk by chunk too.

    python -m multimodalworddiscovery_tpu_torch.scripts.exp_gauss_dense        # N=1000
    python -m multimodalworddiscovery_tpu_torch.scripts.exp_gauss_dense \\
        --n 16 --iters 2 --feat-dim 4 --concepts 10 2 3 --device cpu

Prints one JSON line per variant and the results as the last line; the
device is "cuda" unless ``--device`` names another ("cpu" runs the kernels'
plain versions).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_gaussian
from multimodalworddiscovery_tpu_torch.models.bucketed import chunked_expected_counts
from multimodalworddiscovery_tpu_torch.models.minibatch import gather_batch

MAX_JUMP = 5
ANNEAL = (0.25, 6)
N_CODES = 64
DENSE = (200, 16, 32)  # concepts, and the least and most an image (the stretch config's)
# the JAX package's frame accuracies for this study at its defaults
# (docs/PERFORMANCE.md:426-438); it draws other random numbers
DOCUMENTED = {
    "random_init_floor": 0.074, "ceiling_supervised": 0.519, "ceiling_plus_em": 0.471,
    "em_global": 0.080, "em_diagonal": 0.118, "em_diag_anneal": 0.195,
    "discrete_tokens_control": 0.370, "vq_teacher_itself": 0.333,
    "vq_teacher_seeded": 0.360, "vq_seed_plus_em": 0.418,
}


def build_corpus(n: int, feat_dim: int, device="cuda", concepts: tuple[int, int, int] = DENSE,
                 ) -> tuple:
    """The stretch config's dense-region corpus at N=``n`` (``concepts``:
    the vocabulary and the least and most concepts an image): (phone corpus,
    phone gold, frame corpus, frame gold), seed 0."""
    n_concepts, lo, hi = concepts
    pc, pg, _ = make_flickr8k_mini(n_utterances=n, n_concepts=n_concepts, min_concepts=lo,
                                   max_concepts=hi, seed=0, device=device)
    fc, fg, _ = phones_to_frames(pc, pg, feat_dim=feat_dim, seed=0, device=device)
    return pc, pg, fc, fg


def chunks_of(corpus: Corpus, chunks: int) -> list[Corpus]:
    """``chunks`` consecutive slices of the corpus (the last may be
    shorter), at the corpus's padded lengths."""
    csz = -(-corpus.n // chunks)
    return [gather_batch(corpus, torch.arange(lo, min(lo + csz, corpus.n)))
            for lo in range(0, corpus.n, csz)]


def word_mask(corpus: Corpus, gold_alignment: np.ndarray) -> np.ndarray:
    """The frames the study scores: valid and gold-aligned to a concept."""
    return corpus.src_mask().cpu().numpy() & (gold_alignment > 0)


def accuracy(pred: np.ndarray, gold_alignment: np.ndarray, mask: np.ndarray) -> float:
    return float((pred == gold_alignment)[mask].mean())


def chunked_align(mod, params, corpus: Corpus, chunks: int) -> np.ndarray:
    """Decode ``chunks`` slices of the corpus one at a time -> [N, Ts]."""
    return np.concatenate([mod.align(params, c).cpu().numpy()
                           for c in chunks_of(corpus, chunks)], axis=0)


def em_chunked_step(params, corpus: Corpus, chunks: int, scale: float = 1.0):
    """One exact EM iteration with the E-step over ``chunks`` slices at
    emission temperature ``scale`` -> (params, loglik on the device)."""
    counts, ll = chunked_expected_counts(hmm_gaussian, params, corpus, chunks,
                                         emit_scale=scale)
    return hmm_gaussian.m_step(params, counts), ll


def chunked_train(params, corpus: Corpus, iters: int, chunks: int,
                  anneal: tuple[float, int] | None = None) -> tuple:
    """``iters`` chunked EM iterations -> (params, logliks as floats)."""
    lls = []
    for scale in hmm_gaussian.anneal_scales(iters, anneal):
        params, ll = em_chunked_step(params, corpus, chunks, scale)
        lls.append(ll)
    return params, torch.stack(lls).tolist()


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--feat-dim", type=int, default=64)
    ap.add_argument("--components", type=int, default=2)
    ap.add_argument("--chunks", type=int, default=4)
    ap.add_argument("--concepts", type=int, nargs=3, default=list(DENSE),
                    metavar=("VOCAB", "MIN", "MAX"),
                    help="concept vocabulary and concepts an image (small for a quick run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    pc, pg, fc, fg = build_corpus(args.n, args.feat_dim, args.device, tuple(args.concepts))
    gold = torch.as_tensor(fg.alignment, device=args.device)
    wm = word_mask(fc, fg.alignment)
    print(json.dumps({"corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len,
                      "valid_frames": int(wm.sum())}), flush=True)
    nchunk, k = args.chunks, args.components
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731 (one key, as the study)
    results, seconds, lls_of = {}, {}, {}

    def acc(params) -> float:
        return accuracy(chunked_align(hmm_gaussian, params, fc, nchunk), fg.alignment, wm)

    def record(name: str, value: float, t0: float, lls=None) -> None:
        _sync(args.device)
        results[name], seconds[name] = value, time.perf_counter() - t0
        line = {"variant": name, "frame_acc": value, "seconds": seconds[name]}
        if lls is not None:
            lls_of[name] = lls
            line["loglik_first_last"] = [lls[0], lls[-1]]
        print(json.dumps(line), flush=True)

    # --- the floor and the supervised ceiling ---
    t0 = time.perf_counter()
    base = hmm_gaussian.init_diagonal(fc, max_jump=MAX_JUMP, n_components=k, generator=gen())
    record("random_init_floor", acc(base), t0)
    t0 = time.perf_counter()
    sup = hmm_gaussian.supervised_fit(base, fc, gold, num_iterations=5)
    record("ceiling_supervised", acc(sup), t0)

    # --- unsupervised variants ---
    for name, init_fn, anneal in (("em_global", hmm_gaussian.init, None),
                                  ("em_diagonal", hmm_gaussian.init_diagonal, None),
                                  ("em_diag_anneal", hmm_gaussian.init_diagonal, ANNEAL)):
        t0 = time.perf_counter()
        p0 = init_fn(fc, max_jump=MAX_JUMP, n_components=k, generator=gen())
        p, lls = chunked_train(p0, fc, args.iters, nchunk, anneal)
        record(name, acc(p), t0, lls)

    # --- does EM walk away from the gold optimum? ---
    t0 = time.perf_counter()
    ref, lls = chunked_train(sup, fc, args.iters, nchunk)
    record("ceiling_plus_em", acc(ref), t0, lls)

    # --- control: the discrete HMM on the phone tokens at the same density ---
    t0 = time.perf_counter()
    dp, lls = hmm.train(hmm.init(pc, max_jump=MAX_JUMP), pc, args.iters)
    dmask = pc.src_mask().cpu().numpy() & (pg.alignment > 0)
    record("discrete_tokens_control",
           accuracy(hmm.align(dp, pc).cpu().numpy(), pg.alignment, dmask), t0, lls.tolist())

    # --- the recipe's stages: VQ codes -> discrete teacher -> seeding -> EM ---
    t0 = time.perf_counter()
    cc = hmm_gaussian.quantize_frames(fc, n_codes=N_CODES,
                                      generator=torch.Generator().manual_seed(1))
    tp, lls = hmm.train(hmm.init(cc, max_jump=MAX_JUMP), cc, args.iters)
    record("vq_teacher_itself", accuracy(hmm.align(tp, cc).cpu().numpy(), fg.alignment, wm),
           t0, lls.tolist())
    t0 = time.perf_counter()
    gp = hmm_gaussian.seed_from_teacher(base, fc, cc, tp, seed_rounds=3, chunks=nchunk)
    record("vq_teacher_seeded", acc(gp), t0)
    t0 = time.perf_counter()
    gp2, lls = chunked_train(gp, fc, args.iters, nchunk)
    record("vq_seed_plus_em", acc(gp2), t0, lls)

    device = torch.cuda.get_device_name(0) if torch.device(args.device).type == "cuda" \
        else "cpu"
    out = {"study": "exp_gauss_dense", "corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len,
           "phone_corpus": list(pc.src.shape), "n": args.n, "feat_dim": args.feat_dim,
           "components": k, "iters": args.iters, "chunks": nchunk, "device": device,
           "results": results, "seconds": seconds, "logliks": lls_of}
    print(json.dumps({"results": results}), flush=True)
    return out


if __name__ == "__main__":
    main()
