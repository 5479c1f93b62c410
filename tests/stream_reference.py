"""The JAX reference of the streamed DNN-HMM (``hmm_dnn.train_streaming``)
at ``chip_smoke.py`` path 18's configuration, started from the port's
initial parameters.

The corpus is ``configs/hmm_crf_frames.py``'s (as in
``tests/crf_reference.py``: N=400 utterances of 12-dim frames), written by
the port's ``data.stream.write_shards`` in 4 shards of 100 and read by the
JAX package's reader.  The initial parameters are the port's
(``hmm_dnn.init`` with hidden 256, n_sgd 4, lr 1e-3, max_jump 3, the MLP
drawn from a CPU ``torch.Generator`` with seed 0), carried into the JAX
package with fresh Adam states.  The JAX package then runs 10 streamed
iterations on the CPU and decodes the whole corpus; beside it, its resident
``hmm_dnn.train`` from the same parameters.  It prints each run's logliks,
positional accuracy and alignment F1, the values of
``chip_smoke.REFERENCE_STREAM_DNN_*``:

    JAX_PLATFORMS=cpu python tests/stream_reference.py   # about a minute
"""

from __future__ import annotations

import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

from crf_reference import CORPUS, FRAMES, MODEL, corpora, port_init, to_jax
from multimodalworddiscovery_tpu.data.stream import ShardedCorpusReader
from multimodalworddiscovery_tpu.eval.metrics import alignment_prf
from multimodalworddiscovery_tpu.models import hmm_dnn
from multimodalworddiscovery_tpu_torch.data.stream import write_shards

SHARDS = 4
ITERS = 10


def score(jp, fc, fg) -> dict:
    pred = np.asarray(jax.jit(hmm_dnn.align)(jp, fc))
    prf = alignment_prf(jnp.asarray(pred), jnp.asarray(fg.alignment), fc.src_mask())
    mask = np.asarray(fc.src_mask()) & (fg.alignment > 0)
    return {"f1": float(prf["f1"]),
            "positional_accuracy": float((pred == fg.alignment)[mask].mean())}


def main() -> None:
    jax.config.update("jax_platforms", "cpu")
    fc, fg, tfc = corpora(CORPUS, FRAMES)
    tp = port_init(tfc, False, MODEL)
    out = {}
    with tempfile.TemporaryDirectory() as d:
        write_shards(tfc, d, tfc.n // SHARDS)
        js, lls = hmm_dnn.train_streaming(to_jax(tp), ShardedCorpusReader(d), ITERS)
    out["streamed"] = {"loglik": [float(v) for v in lls], **score(js, fc, fg)}
    jr, lls_r = jax.jit(lambda p: hmm_dnn.train(p, fc, ITERS))(to_jax(tp))
    out["resident"] = {"loglik": np.asarray(lls_r).tolist(), **score(jr, fc, fg)}
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
