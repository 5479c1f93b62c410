"""The port's self_train stage by stage against the JAX package, on the
CPU: the GMM-HMM teacher's EM from the JAX package's initial parameters
(each loglik rtol 1e-5, the decode equal), ``reseed_teacher`` against the
root script's lines 113-129 in jnp (atol 1e-5) and the EM after it, the
student's chunked decode, and ``main`` end to end at a tiny size.  The
student's steps are in test_torch_guided_student.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu_torch.models import attention as tatt
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.scripts import self_train as st
from torch_studies_common import (  # noqa: F401
    LOOP,
    LOOP_FRAMES,
    both_frames,
    gauss_to_port,
    one_thread,
)

DIM = 16
_j_align = jax.jit(jg.align)
_j_train = jax.jit(jg.train, static_argnums=2)


@pytest.fixture(scope="module")
def loop_corpus():
    return both_frames(LOOP, LOOP_FRAMES)


@pytest.fixture(scope="module")
def loop_teacher(loop_corpus):
    """self_train's round-0 teacher from JAX's init, 3 EM iterations on each
    side: (JAX params, port params)."""
    jfc, fc, _, _ = loop_corpus
    jp0 = jg.init(jfc, n_components=2, key=jax.random.PRNGKey(0))
    tp, lls = st.teacher(fc, 3, params=gauss_to_port(jp0))
    jp, jlls = _j_train(jp0, jfc, 3)
    np.testing.assert_allclose(lls.numpy(), np.asarray(jlls), rtol=1e-5)
    return jp, tp


def test_teacher_matches_jax(loop_corpus, loop_teacher):
    jfc, fc, fg, wm = loop_corpus
    jp, tp = loop_teacher
    np.testing.assert_array_equal(tg.align(tp, fc).numpy(), np.asarray(_j_align(jp, jfc)))


def test_align_student_chunks(loop_corpus):
    _, fc, _, _ = loop_corpus
    state = tatt.init(fc, dim=DIM, generator=torch.Generator().manual_seed(0))
    assert torch.equal(st.align_student(state, fc, chunk=6), st.align_student(state, fc))


def _jax_reseed(hp, fc, a_student):
    """The root scripts/self_train.py:113-129, verbatim in jnp."""
    concept_of = jnp.concatenate([jnp.zeros((fc.n, 1), fc.trg.dtype), fc.trg], axis=1)
    frame_concept = jnp.take_along_axis(concept_of, jnp.asarray(a_student), axis=1)
    x = fc.src
    v = fc.trg_vocab
    w = fc.src_mask().astype(x.dtype)
    onehot = jax.nn.one_hot(frame_concept, v, dtype=x.dtype) * w[..., None]
    c0 = jnp.maximum(jnp.sum(onehot, axis=(0, 1)), 1e-3)
    mu = jnp.einsum("ntc,ntd->cd", onehot, x) / c0[:, None]
    var = jnp.einsum("ntc,ntd->cd", onehot, x**2) / c0[:, None] - mu**2
    var = jnp.maximum(var, 1e-3)
    return hp.replace(
        means=jnp.broadcast_to(mu[:, None, :], hp.means.shape),
        log_vars=jnp.broadcast_to(jnp.log(var)[:, None, :], hp.log_vars.shape),
    )


def test_reseed_teacher_matches_jax(loop_corpus, loop_teacher):
    jfc, fc, _, _ = loop_corpus
    jp, tp = loop_teacher
    a = np.random.default_rng(3).integers(0, fc.max_trg_len + 1, size=(fc.n, fc.max_src_len))
    a = np.where(fc.src_mask().numpy(), np.minimum(a, fc.trg_len.numpy()[:, None]), 0)
    got = st.reseed_teacher(tp, fc, torch.as_tensor(a, dtype=torch.int32))
    want = _jax_reseed(jp, jfc, a.astype(np.int32))
    for f in ("means", "log_vars"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    # and the teacher's EM from there
    got, lls = st.teacher(fc, 3, params=got)
    _, jlls = _j_train(want, jfc, 3)
    np.testing.assert_allclose(lls.numpy(), np.asarray(jlls), rtol=1e-5)


@pytest.mark.parametrize("batch_size", ["0", "8"])
def test_self_train_runs_end_to_end(batch_size):
    out = st.main(["--utterances", "16", "--hmm-iters", "2", "--attn-iters", "2",
                   "--batch-size", batch_size, "--device", "cpu"])
    assert [s["stage"].split(" (")[0] for s in out["stages"]] == [
        "round 0 teacher", "round 0 student", "round 1 teacher", "round 1 student"]
    assert all(0.0 <= a <= 1.0 for a in out["accuracies"])


