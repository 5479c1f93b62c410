"""The JAX reference of the DNN-HMM and CRF aligners, started from the
port's initial parameters.

The corpus is ``configs/hmm_crf_frames.py``'s (and ``hmm_crf_e2e.py``'s):
``make_flickr8k_mini(400, n_concepts=40, n_phones=48, min_concepts=2,
max_concepts=4, seed=0)`` expanded by ``phones_to_frames(feat_dim=12,
seed=0)``.  The initial parameters are the port's (``hmm_dnn.init`` /
``hmm_crf.init_e2e`` with hidden 256, n_sgd 4, lr 1e-3, max_jump 3, the MLP
drawn from a CPU ``torch.Generator`` with seed 0), carried into the JAX
package as numpy arrays with fresh Adam states.  Then the JAX package
trains on the CPU (its dense scan E-step) and decodes:

- ``hmm_crf_frames``: ``hmm_crf.train`` for 10 iterations;
- ``hmm_crf_e2e``: ``hmm_crf.train(learn_transitions=True)`` for 20;
- ``hmm_dnn``: ``hmm_dnn.train`` for 10 (the CLI's ``model.name=hmm_dnn``
  on the same config).

It prints each run's alignment P/R/F1, positional accuracy and logliks,
the values of ``chip_smoke.REFERENCE_CRF_*``:

    JAX_PLATFORMS=cpu python tests/crf_reference.py

``tests/test_torch_hmm_crf.py`` runs the same functions at a small size.
"""

from __future__ import annotations

import argparse
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames
from multimodalworddiscovery_tpu.eval.metrics import alignment_prf
from multimodalworddiscovery_tpu.models import hmm_crf, hmm_dnn
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.models import hmm_crf as port_crf
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as port_dnn

# configs/hmm_crf_frames.py and configs/hmm_crf_e2e.py on core/config.py's
# base_config (seed 0, max_jump 3)
CORPUS = dict(n_utterances=400, n_concepts=40, n_phones=48, min_concepts=2,
              max_concepts=4, seed=0)
FRAMES = dict(feat_dim=12, seed=0)
MODEL = dict(max_jump=3, hidden=256, learning_rate=1e-3, n_sgd=4)
RUNS = {"hmm_crf_frames": 10, "hmm_crf_e2e": 20, "hmm_dnn": 10}
SEED = 0  # the port's CPU generator seed for the MLP's weights


def corpora(corpus_kw: dict, frames_kw: dict):
    """(JAX frame corpus, its gold, the port's frame corpus on the CPU)."""
    pc, pg, _ = make_flickr8k_mini(**corpus_kw)
    fc, fg, _ = phones_to_frames(pc, pg, **frames_kw)
    tpc, tpg, _ = torch_make(**corpus_kw, device="cpu")
    tfc, _, _ = torch_frames(tpc, tpg, **frames_kw, device="cpu")
    return fc, fg, tfc


def port_init(tfc, e2e: bool, model_kw: dict, seed: int = SEED):
    """The port's initial parameters (on the CPU)."""
    init = port_crf.init_e2e if e2e else port_dnn.init
    return init(tfc, **model_kw, generator=torch.Generator().manual_seed(seed))


def mlp_to_numpy(mlp) -> dict:
    """The port's MLP weights in flax's layout {"params": {"Dense_i":
    {"kernel": [in, out], "bias": [out]}}}, as numpy arrays (the inverse of
    ``hmm_dnn.params_from_numpy``'s transpose)."""
    return {"params": {
        f"Dense_{i}": {"kernel": layer.weight.detach().cpu().numpy().T.copy(),
                       "bias": layer.bias.detach().cpu().numpy().copy()}
        for i, layer in enumerate(mlp.dense)}}


def to_jax(tp, e2e: bool = False):
    """The port's parameters as the JAX package's DnnHMMParams, with fresh
    Adam states (the optimizer of ``hmm_dnn`` or, with ``e2e``, the
    two-rate optimizer of ``hmm_crf.init_e2e``)."""
    mlp = jax.tree.map(jnp.asarray, mlp_to_numpy(tp.mlp))
    lj = jnp.asarray(tp.log_jump.detach().cpu().numpy())
    lp0 = jnp.asarray(tp.log_p0.detach().cpu().numpy())
    opt = (hmm_crf._optimizer_e2e(tp.learning_rate).init((mlp, lj, lp0)) if e2e
           else hmm_dnn._optimizer(tp.learning_rate).init(mlp))
    return hmm_dnn.DnnHMMParams(
        mlp=mlp, opt_state=opt, log_prior=jnp.asarray(tp.log_prior.cpu().numpy()),
        log_jump=lj, log_p0=lp0, max_jump=tp.max_jump, hidden=tp.hidden,
        learning_rate=tp.learning_rate, n_sgd=tp.n_sgd,
    )


def run(name: str, fc, fg, jp, iters: int) -> dict:
    """Train ``jp`` with the JAX package for ``iters`` iterations, decode,
    and score against the frame gold."""
    if name == "hmm_dnn":
        jp, lls = jax.jit(lambda p: hmm_dnn.train(p, fc, iters))(jp)
    else:
        e2e = name == "hmm_crf_e2e"
        jp, lls = jax.jit(lambda p: hmm_crf.train(p, fc, iters, learn_transitions=e2e))(jp)
    pred = np.asarray(jax.jit(hmm_dnn.align)(jp, fc))
    gold = jnp.asarray(fg.alignment[:, : fc.max_src_len])
    prf = alignment_prf(jnp.asarray(pred), gold, fc.src_mask())
    mask = np.asarray(fc.src_mask()) & (fg.alignment > 0)
    return {
        "alignment": {k: float(v) for k, v in prf.items()},
        "positional_accuracy": float((pred == fg.alignment)[mask].mean()),
        "loglik": np.asarray(lls).tolist(),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=CORPUS["n_utterances"])
    args = ap.parse_args()
    jax.config.update("jax_platforms", "cpu")
    fc, fg, tfc = corpora(dict(CORPUS, n_utterances=args.utterances), FRAMES)
    out = {}
    for name, iters in RUNS.items():
        e2e = name == "hmm_crf_e2e"
        out[name] = run(name, fc, fg, to_jax(port_init(tfc, e2e, MODEL), e2e), iters)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
