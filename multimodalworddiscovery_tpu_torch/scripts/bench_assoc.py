"""The matrix-product forward passes against the sequential ones on one
GPU -> JSON lines.

Counterpart of ``scripts/bench_assoc.py``: the sequential forward
(``hmm_core.forward``, one torch step per time step), the associative scan
(``forward_associative``) and the blocked forward (``forward_blocked``,
blocks of 8, 16 and 32), their combines through K8, at the reference's S64
(N=256, Ts=147) and S128 (N=64, Ts=176) shapes, from ``hmm.init``.  One more
row, ``estep_k4``, times K4, the port's sequential E-step kernel (forward
and backward), on the same emissions.

    python -m multimodalworddiscovery_tpu_torch.scripts.bench_assoc \\
        [--reps 5] [--out build/bench/assoc.jsonl]

Each record (ms per call, utterances per second, the FLOP model's rate, the
summed logZ as a check, and the time against the sequential forward) is
printed as one JSON line and appended to ``--out``, with the card's name
and power limit; times are CUDA events after a warm-up and a synchronize
(``bench_kernels.gpu_ms``).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import pathlib

import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd
from multimodalworddiscovery_tpu_torch.scripts.bench_kernels import (
    DEFAULT_OUT,
    Recorder,
    gpu_ms,
    require_cuda,
)

SHAPES = (
    ("S64", dict(n_utterances=256, n_concepts=200, n_phones=48, min_concepts=24,
                 max_concepts=32, min_word_len=3, max_word_len=5, seed=1)),
    ("S128", dict(n_utterances=64, n_concepts=400, n_phones=48, min_concepts=48,
                  max_concepts=64, min_word_len=2, max_word_len=3, seed=2)),
)
BLOCKS = (8, 16, 32)


def variants(params, corpus):
    """(name, fn -> logZ [N]) of every forward timed, on ``corpus``."""
    log_init, log_trans, log_emit = hmm._machinery(params, corpus)
    args = (log_init, log_trans, log_emit, corpus.src_len)
    base, rowz, colmask = hmm_core.factor_log_trans(params.log_jump, params.log_p0, corpus,
                                                    params.max_jump)
    out = [("fwd_scan", lambda: hmm_core.forward(*args)[1]),
           ("fwd_assoc", lambda: hmm_core.forward_associative(*args)[1])]
    for b in BLOCKS:
        out.append((f"fwd_blocked_b{b}",
                    lambda b=b: hmm_core.forward_blocked(*args, block=b)[1]))
    out.append(("estep_k4", lambda: hmm_fwdbwd.hmm_estep(log_init, base, rowz, colmask, log_emit,
                                                         corpus.src_len)[2]))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=pathlib.Path, default=DEFAULT_OUT.with_name("assoc.jsonl"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    record = Recorder(args.out)
    for label, gen in SHAPES:
        corpus, _, _ = make_flickr8k_mini(**gen, device=dev)
        params = hmm.init(corpus)
        n, ts, s = corpus.n, corpus.max_src_len, 2 * corpus.max_trg_len
        scan_ms = None
        for name, fn in variants(params, corpus):
            ms = gpu_ms(fn, args.reps)
            # FLOP model (the reference's): a vector-matrix step is 2 S^2 N,
            # the matrix forms ~Ts [S, S] x [S, S] products, 2 S^3 N each;
            # K4's forward, backward and xi are 7 S^2 N a step
            per_step = {"fwd_scan": 2.0 * s**2, "estep_k4": 7.0 * s**2}.get(name, 2.0 * s**3)
            flops = per_step * n * ts
            rec = dict(kernel=name, shape=label, N=n, Ts=ts, S=s, ms=ms,
                       utt_per_sec=n * 1e3 / ms, flops_per_sec=flops * 1e3 / ms,
                       logz_check=float(fn().sum()))
            if name == "fwd_scan":
                scan_ms = ms
            else:
                rec["x_vs_scan"] = ms / scan_ms
            record(**rec)
        del corpus, params
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
