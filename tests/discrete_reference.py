"""The JAX reference of the dense-caption discrete HMM (S=128, outside the
fused route's gate).

The corpus is the reference's own S=128 row of ``scripts/bench_kernels.py``
(``bench_hmm_estep`` / ``bench_viterbi``, docs/PERFORMANCE.md:115):
``make_flickr8k_mini(n_utterances=512, n_concepts=400, n_phones=48,
min_concepts=48, max_concepts=64, min_word_len=2, max_word_len=3, seed=2)``,
N=512, Ts=181, S=128, V_src=49, V_trg=401.  The JAX package runs
``hmm.init`` (deterministic, so both packages start from the same point),
``hmm.train`` for 10 iterations (its dense scan E-step) and ``hmm.align``
on the CPU, then the alignment P/R/F1 against the gold.  It prints those
and the logliks, the values of ``chip_smoke.REFERENCE_DENSE_F1``:

    JAX_PLATFORMS=cpu python tests/discrete_reference.py

With ``--port`` it also runs the port's plain path on the CPU from the same
corpus, the run ``chip_smoke.py`` path 8 makes on the card.
``tests/test_torch_hmm.py`` runs the same functions at a small size.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.eval.metrics import alignment_prf
from multimodalworddiscovery_tpu.models import hmm

CORPUS = dict(n_utterances=512, n_concepts=400, n_phones=48, min_concepts=48,
              max_concepts=64, min_word_len=2, max_word_len=3, seed=2)
ITERS = 10


def jax_run(corpus_kw: dict, iters: int) -> dict:
    corpus, gold, _ = make_flickr8k_mini(**corpus_kw)
    params, lls = jax.jit(lambda p: hmm.train(p, corpus, iters))(hmm.init(corpus))
    pred = jax.jit(hmm.align)(params, corpus)
    prf = alignment_prf(pred, jnp.asarray(gold.alignment), corpus.src_mask())
    return {"shape": {"N": corpus.n, "Ts": corpus.max_src_len, "S": 2 * corpus.max_trg_len,
                      "V_src": corpus.src_vocab, "V_trg": corpus.trg_vocab},
            "alignment": {k: float(v) for k, v in prf.items()},
            "loglik": np.asarray(lls).tolist()}


def port_run(corpus_kw: dict, iters: int) -> dict:
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf as t_prf
    from multimodalworddiscovery_tpu_torch.models import hmm as thmm

    corpus, gold, _ = torch_make(**corpus_kw, device="cpu")
    params, lls = thmm.train(thmm.init(corpus), corpus, iters)
    pred = thmm.align(params, corpus)
    prf = t_prf(pred, torch.as_tensor(gold.alignment), corpus.src_mask())
    return {"alignment": {k: float(v) for k, v in prf.items()}, "loglik": lls.tolist()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=CORPUS["n_utterances"])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--port", action="store_true", help="also the port's plain path")
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    kw = dict(CORPUS, n_utterances=args.utterances)
    out = {"jax": jax_run(kw, args.iters)}
    if args.port:
        out["port_plain"] = port_run(kw, args.iters)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
