"""Teacher-student alternation (the DNN-HMM-DNN hybrid, iterated).

Counterpart of ``scripts/self_train.py``:

  round 0  a GMM-HMM teacher by EM (``hmm_gaussian``, K=2; K4, decoded by
           K3) -> a guided-attention student (``attention``, its guide from
           the teacher's posteriors, gamma from K4)
  round k  the teacher's emissions re-seeded from the student's alignments
           (hard-count means and variances per concept, broadcast over the
           components), more EM, a fresh guide, a new student

Each stage's positional alignment accuracy on the synthetic frames corpus
(gold known) is one JSON line.  The student trains full batch, or with
``--batch-size`` on minibatches drawn on the device with the guide made per
batch inside the step (``minibatch.make_minibatch_step``).

    python -m multimodalworddiscovery_tpu_torch.scripts.self_train              # N=800
    python -m multimodalworddiscovery_tpu_torch.scripts.self_train \\
        --utterances 40000 --batch-size 512 --attn-iters 4000            # at scale
    python -m multimodalworddiscovery_tpu_torch.scripts.self_train \\
        --utterances 24 --hmm-iters 2 --attn-iters 3 --device cpu

The device is "cuda" unless ``--device`` names another ("cpu" runs the
kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.models import attention, hmm_gaussian
from multimodalworddiscovery_tpu_torch.models.minibatch import (
    gather_batch,
    make_minibatch_step,
    step_generator,
)

ALIGN_CHUNK = 4000  # utterances a student decode, above which it runs in chunks
# the JAX package's accuracies of this loop (docs/PERFORMANCE.md:389-402): at
# N=800, full batch, and at N=40,000 with B=512 and 4000 student steps
DOCUMENTED = {800: [0.820, 0.858, 0.942, 0.934], 40000: [0.823, 0.813, 0.938, 0.867]}


def build_corpus(n: int, device="cuda"):
    """The loop's frames corpus: (frame corpus, frame gold), seed 11."""
    pc, pg, _ = make_flickr8k_mini(n_utterances=n, seed=11, device=device)
    fc, fg, _ = phones_to_frames(pc, pg, feat_dim=13, noise=0.1, seed=11, device=device)
    return fc, fg


def teacher(corpus, iters: int, params=None, seed: int = 0):
    """``iters`` EM iterations of the GMM-HMM teacher from ``params`` (a
    fresh ``hmm_gaussian.init``, K=2, jitter seeded ``seed``, when None) ->
    (params, logliks)."""
    if params is None:
        params = hmm_gaussian.init(corpus, n_components=2,
                                   generator=torch.Generator().manual_seed(seed))
    return hmm_gaussian.train(params, corpus, iters)


def train_student(hp, corpus, attn_iters: int, batch_size: int = 0, seed: int = 0,
                  state=None):
    """A guided-attention student of the teacher ``hp``: full batch with
    one guide (AdamW at the default rate), or ``batch_size``-row minibatches
    at 1e-3 with each batch's guide made inside the step; step ``it``'s
    draws from ``step_generator(seed + 100, it)``.  It starts from
    ``state``, or from new weights seeded ``seed`` when None."""
    gen = torch.Generator().manual_seed(seed)
    if batch_size:
        def guided_step(st, batch):
            g = attention.hmm_guide_matrix(hp, batch, posteriors_fn=hmm_gaussian.posteriors)
            return attention.em_step(st, batch, guide=g)

        st = state if state is not None else attention.init(corpus, learning_rate=1e-3,
                                                            generator=gen)
        step = make_minibatch_step(guided_step, corpus, batch_size)
        for it in range(attn_iters):
            st, _ = step(st, step_generator(seed + 100, it))
        return st
    guide = attention.hmm_guide_matrix(hp, corpus, posteriors_fn=hmm_gaussian.posteriors)
    st = state if state is not None else attention.init(corpus, generator=gen)
    st, _ = attention.train(st, corpus, attn_iters, guide)
    return st


def align_student(st, corpus, chunk: int = ALIGN_CHUNK) -> torch.Tensor:
    """The student's alignment [N, Ts]; above ``chunk`` utterances decoded
    ``chunk`` rows at a time (``gather_batch``)."""
    if corpus.n <= chunk:
        return attention.align(st, corpus)
    return torch.cat([attention.align(st, gather_batch(
        corpus, torch.arange(i, min(i + chunk, corpus.n)))) for i in range(0, corpus.n, chunk)])


def reseed_teacher(hp, corpus, a_student: torch.Tensor):
    """The teacher's emissions from the student's alignment: each frame
    hard-assigned to its aligned concept (NULL = 0), per-concept means and
    variances (floored at 1e-3) broadcast over the components."""
    concept_of = torch.cat([torch.zeros((corpus.n, 1), dtype=corpus.trg.dtype,
                                        device=corpus.device), corpus.trg], dim=1)
    frame_concept = torch.take_along_dim(concept_of, a_student.long(), dim=1)
    x = corpus.src
    w = corpus.src_mask().to(x.dtype)
    onehot = torch.nn.functional.one_hot(frame_concept.long(), corpus.trg_vocab).to(x.dtype)
    onehot = onehot * w[..., None]
    c0 = torch.clamp(onehot.sum(dim=(0, 1)), min=1e-3)  # [C]
    mu = torch.einsum("ntc,ntd->cd", onehot, x) / c0[:, None]
    var = torch.einsum("ntc,ntd->cd", onehot, x**2) / c0[:, None] - mu**2
    var = torch.clamp(var, min=1e-3)
    return dataclasses.replace(
        hp, means=mu[:, None, :].expand(hp.means.shape).contiguous(),
        log_vars=torch.log(var)[:, None, :].expand(hp.log_vars.shape).contiguous())


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=800)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--hmm-iters", type=int, default=15)
    ap.add_argument("--attn-iters", type=int, default=400)
    ap.add_argument("--batch-size", type=int, default=0,
                    help="minibatch student steps (0 = full batch); for large corpora, "
                         "e.g. --utterances 40000 --batch-size 512 --attn-iters 4000")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain versions)")
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device; pass --device cpu to run on the CPU")

    t_start = time.perf_counter()
    fc, fg = build_corpus(args.utterances, args.device)
    wm = fc.src_mask().cpu().numpy() & (fg.alignment > 0)
    stages = []

    def log(stage: str, pred: torch.Tensor) -> None:
        acc = float((pred.cpu().numpy() == fg.alignment)[wm].mean())
        stages.append({"stage": stage, "acc": acc, "seconds": time.perf_counter() - t_start})
        print(json.dumps(stages[-1]), flush=True)

    hp, _ = teacher(fc, args.hmm_iters)
    log("round 0 teacher (GMM-HMM)", hmm_gaussian.align(hp, fc))
    for r in range(args.rounds):
        st = train_student(hp, fc, args.attn_iters, args.batch_size, seed=r)
        a_student = align_student(st, fc)
        log(f"round {r} student (guided attention)", a_student)
        if r + 1 == args.rounds:
            break
        hp, _ = teacher(fc, args.hmm_iters, params=reseed_teacher(hp, fc, a_student))
        log(f"round {r + 1} teacher (re-seeded GMM-HMM)", hmm_gaussian.align(hp, fc))
    device = torch.cuda.get_device_name(0) if fc.device.type == "cuda" else "cpu"
    return {"study": "self_train", "corpus": list(fc.src.shape), "states": 2 * fc.max_trg_len,
            "batch_size": args.batch_size,
            "attn_iters": args.attn_iters, "device": device, "stages": stages,
            "accuracies": [s["acc"] for s in stages],
            "seconds": time.perf_counter() - t_start}


if __name__ == "__main__":
    main()
