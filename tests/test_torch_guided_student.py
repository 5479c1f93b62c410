"""The guided-attention student of the port's self_train
(``train_student``) against the JAX package, on the CPU.

The teacher is the JAX package's GMM-HMM init (K=2) and the student the JAX
package's attention weights (dim 16), both carried across with
``params_from_numpy``.  Full batch (one guide) and on minibatches (the
guide made per batch inside the step) each step's loss is held to the JAX
step on the same rows within rtol 1e-4, and the student's alignment must
be equal.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.models import attention as jatt
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models.minibatch import gather_batch as jgather
from multimodalworddiscovery_tpu_torch.models import attention as tatt
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.models.minibatch import gather_batch, step_generator
from multimodalworddiscovery_tpu_torch.scripts import self_train as st
from torch_studies_common import (  # noqa: F401
    LOOP,
    LOOP_FRAMES,
    both_frames,
    gauss_to_port,
    one_thread,
)

DIM = 16


@pytest.fixture(scope="module")
def loop_corpus():
    return both_frames(LOOP, LOOP_FRAMES)


@pytest.fixture(scope="module")
def loop_teacher(loop_corpus):
    """A GMM-HMM teacher (the JAX package's init, K=2): (JAX, port)."""
    jp = jg.init(loop_corpus[0], n_components=2, key=jax.random.PRNGKey(0))
    return jp, gauss_to_port(jp)


@pytest.fixture(scope="module")
def student_init(loop_corpus):
    """The JAX student's initial state (dim 16); the port carries it."""
    return jatt.init(loop_corpus[0], dim=DIM, key=jax.random.PRNGKey(1))


_j_student_step = jax.jit(jatt.em_step)
_j_guide = jax.jit(functools.partial(jatt.hmm_guide_matrix, posteriors_fn=jg.posteriors))


@pytest.mark.parametrize("batch_size", [0, LOOP["n_utterances"]])
def test_student_steps_match_jax(loop_corpus, loop_teacher, student_init, batch_size):
    """train_student, full batch (one guide) and on minibatches (the guide
    made per batch, on rows the port drew: a permutation of all of them,
    so the JAX steps keep one shape; the JAX side takes the same rows):
    each step's loss rtol 1e-4, then the student's alignment."""
    jfc, fc, fg, wm = loop_corpus
    jp, tp = loop_teacher
    js = student_init
    ts = tatt.params_from_numpy(jax.tree.map(np.asarray, js.params),
                                learning_rate=js.learning_rate, device="cpu")
    steps = 3
    got = st.train_student(tp, fc, steps, batch_size, seed=0, state=ts)
    losses, ref = [], ts
    for it in range(steps):
        if batch_size:
            idx = torch.randperm(fc.n, generator=step_generator(100, it))[:batch_size]
            jb, tb = jgather(jfc, jnp.asarray(idx.numpy())), gather_batch(fc, idx)
        else:
            jb, tb = jfc, fc
        js, jstats = _j_student_step(js, jb, _j_guide(jp, jb))
        ref, stats = tatt.em_step(ref, tb, guide=tatt.hmm_guide_matrix(
            tp, tb, posteriors_fn=tg.posteriors))
        np.testing.assert_allclose(float(stats["loss"]), float(jstats["loss"]), rtol=1e-4)
        losses.append(float(stats["loss"]))
    for a, b in zip(got.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)  # train_student is the loop above
    pred = st.align_student(got, fc).numpy()
    np.testing.assert_array_equal(pred, np.asarray(jax.jit(jatt.align)(js, jfc)))
    assert np.isfinite(losses).all()
