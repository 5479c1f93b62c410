"""The port's exp_crf40k against the JAX package, on the CPU: from the JAX
package's initial parameters (``hmm_dnn.init`` for em_trans,
``hmm_crf.init_e2e`` for e2e_trans, hidden 16) carried across with
``hmm_dnn.params_from_numpy``, three ``hmm_crf.em_step``s on minibatches
of the same rows on both sides, each loglik within rtol 1e-5, then the
chunked decode's accuracy equal; and ``main`` end to end at a tiny size.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.models import hmm_crf as jcrf
from multimodalworddiscovery_tpu.models import hmm_dnn as jdnn
from multimodalworddiscovery_tpu.models.minibatch import gather_batch as jgather
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as tdnn
from multimodalworddiscovery_tpu_torch.models.minibatch import gather_batch
from multimodalworddiscovery_tpu_torch.scripts import exp_crf40k as crf40k
from torch_studies_common import LOOP, LOOP_FRAMES, both_frames, one_thread  # noqa: F401

HIDDEN = 16


@pytest.fixture(scope="module")
def loop_corpus():
    return both_frames(LOOP, LOOP_FRAMES)


def _dnn_to_port(jp, e2e: bool):
    p = tdnn.params_from_numpy(jax.tree.map(np.asarray, jp.mlp), jp.log_prior, jp.log_jump,
                               jp.log_p0, max_jump=jp.max_jump, hidden=jp.hidden,
                               learning_rate=jp.learning_rate, n_sgd=jp.n_sgd, device="cpu")
    if e2e:  # a fresh Adam state over the transitions, as init_e2e makes it
        p.opt_state["trans"] = tdnn.adam_init((p.log_jump, p.log_p0))
    return p


@pytest.mark.parametrize("mode", crf40k.MODES)
def test_crf_minibatch_steps_match_jax(loop_corpus, mode):
    """exp_crf40k's steps: hmm_crf.em_step on three minibatches, the same
    rows on both sides; then the chunked decode."""
    jfc, fc, fg, wm = loop_corpus
    lt = mode == "e2e_trans"
    init = jcrf.init_e2e if lt else jdnn.init
    jp = init(jfc, hidden=HIDDEN, n_sgd=1, key=jax.random.PRNGKey(0))
    tp = _dnn_to_port(jp, lt)
    jstep = jax.jit(functools.partial(jcrf.em_step, learn_transitions=lt))
    rng = np.random.default_rng(5)
    for _ in range(3):
        idx = rng.permutation(fc.n)[:8]
        jp, s_w = jstep(jp, jgather(jfc, jnp.asarray(idx)))
        tp, s = crf40k.hmm_crf.em_step(tp, gather_batch(fc, torch.as_tensor(idx)),
                                       learn_transitions=lt)
        np.testing.assert_allclose(float(s["loglik"]), float(s_w["loglik"]), rtol=1e-5)
    got = crf40k.chunked_accuracy(tp, fc, fg.alignment, wm, 2)
    csz = -(-jfc.n // 2)
    pred = np.concatenate([np.asarray(jcrf.align(jp, jax.tree.map(
        lambda x: x[i * csz:(i + 1) * csz], jfc))) for i in range(2)])
    assert got == float((pred == fg.alignment)[wm].mean())


def test_crf40k_runs_end_to_end():
    out = crf40k.main(["--utterances", "24", "--batch-size", "8", "--steps", "2",
                       "--device", "cpu"])
    assert set(out["modes"]) == set(crf40k.MODES)
    for row in out["modes"].values():
        assert {"ms_per_step", "acc", "ll_first", "ll_last"} <= set(row)
        assert 0.0 <= row["acc"] <= 1.0 and np.isfinite(row["ll_last"])


