"""The JAX reference of Model-1 on the headline corpus (BASELINE config #1
at the reference's ``model1_align`` Tt6 shape).

The corpus is ``scripts/bench_kernels.py``'s Tt6 row of ``bench_model1_align``:
``make_flickr8k_mini(n_utterances=8000, n_concepts=60, n_phones=48,
min_concepts=3, max_concepts=6, seed=0)``.  The JAX package runs
``model1.init`` (deterministic, so both packages start from the same
table), ``model1.train`` for 10 iterations and ``model1.align`` on the CPU,
then the alignment P/R/F1 against the gold.  It prints those and the
logliks, the values of ``chip_smoke.REFERENCE_MODEL1_F1``:

    JAX_PLATFORMS=cpu python tests/model1_reference.py [--port]

With ``--port`` it also runs the port's plain path on the CPU from the same
corpus, the run ``chip_smoke.py`` path 10 makes on the card.
``tests/test_torch_model1.py`` runs the same functions at a small size.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.eval.metrics import alignment_prf
from multimodalworddiscovery_tpu.models import model1

CORPUS = dict(n_utterances=8000, n_concepts=60, n_phones=48, min_concepts=3, max_concepts=6,
              seed=0)
ITERS = 10


def jax_run(corpus_kw: dict, iters: int) -> dict:
    corpus, gold, _ = make_flickr8k_mini(**corpus_kw)
    params, lls = jax.jit(lambda p: model1.train(p, corpus, iters))(model1.init(corpus))
    pred = jax.jit(model1.align)(params, corpus)
    prf = alignment_prf(pred, jnp.asarray(gold.alignment), corpus.src_mask())
    return {"shape": {"N": corpus.n, "Ts": corpus.max_src_len, "Tt": corpus.max_trg_len,
                      "V_src": corpus.src_vocab, "V_trg": corpus.trg_vocab},
            "alignment": {k: float(v) for k, v in prf.items()},
            "loglik": np.asarray(lls).tolist()}


def port_run(corpus_kw: dict, iters: int) -> dict:
    import torch

    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
    from multimodalworddiscovery_tpu_torch.eval.metrics import alignment_prf as t_prf
    from multimodalworddiscovery_tpu_torch.models import model1 as tm1

    corpus, gold, _ = torch_make(**corpus_kw, device="cpu")
    params, lls = tm1.train(tm1.init(corpus), corpus, iters)
    pred = tm1.align(params, corpus)
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
