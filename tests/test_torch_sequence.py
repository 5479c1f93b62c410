"""The port's time-sharded forward and E-step (parallel/sequence.py) on local
gloo worlds of 2 and 4 CPU ranks, against the port's sequential forward and
dense E-step and against the JAX package's ``forward_time_sharded`` /
``estep_time_sharded`` on its 8-device "seq" mesh, from the same padded
inputs (Ts padded to a multiple of 8 on both sides).

Bounds are the reference's (tests/test_parallel.py:70, :177): logZ rtol
1e-4 (atol 1e-4 against the E-step's), alphas at valid (t, state) positions
rtol / atol 2e-3, gamma and the jump-width counts projected from xi rtol /
atol 2e-3.  The chunk products compose through the plain log-semiring
product and through K8's plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_parallel_workers as w
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.parallel.sequence import (
    estep_time_sharded,
    forward_time_sharded,
)
from multimodalworddiscovery_tpu_torch.models import hmm_core
from multimodalworddiscovery_tpu_torch.parallel.multihost import spawn


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world(request, tmp_path_factory):
    return spawn(w.sequence_world, request.param, device="cpu", timeout=300,
                 store_dir=tmp_path_factory.mktemp(f"seq{request.param}"))


def _chunks(world, key, field, axis):
    return np.concatenate([r[key][field] for r in world], axis=axis)


def _jax_inputs(name):
    """The JAX package's (corpus, params, machinery) on the same padded
    inputs as the ranks'."""
    jc, _, _ = jax_make(**w.SEQ_CORPORA[name])
    ts = jc.max_src_len
    pad = -(-ts // w.SEQ_PAD) * w.SEQ_PAD - ts
    jc = jc.replace(src=jnp.pad(jc.src, ((0, 0), (0, pad))))
    params = jhmm.init(jc)
    return jc, params, jhmm._machinery(params, jc)


@pytest.fixture(scope="module")
def seq_mesh():
    return Mesh(np.array(jax.devices()), ("seq",))


def _valid_alphas(got, want, corpus):
    sl = corpus.src_len.numpy()
    smask = hmm_core.state_mask(corpus).numpy()
    for i in range(corpus.n):
        for t in range(sl[i]):
            np.testing.assert_allclose(got[t, i][smask[i]], want[t, i][smask[i]], rtol=2e-3,
                                       atol=2e-3, err_msg=f"utt {i} t {t}")


def test_forward_time_sharded_matches_sequential(world):
    corpus, _, log_init, log_trans, log_emit = w.sequence_inputs("forward")
    a_seq, z_seq = hmm_core.forward(log_init, log_trans, log_emit, corpus.src_len)
    for r in world:
        np.testing.assert_allclose(r["forward"]["logz"], z_seq.numpy(), rtol=1e-4)
    _valid_alphas(_chunks(world, "forward", "alphas", 0), a_seq.numpy(), corpus)


def test_forward_time_sharded_matches_jax(world, seq_mesh):
    corpus = w.sequence_inputs("forward")[0]
    jc, _, (li, lt, le) = _jax_inputs("forward")
    a_j, z_j = forward_time_sharded(li, lt, le, jc.src_len, seq_mesh)
    np.testing.assert_allclose(world[0]["forward"]["logz"], np.asarray(z_j), rtol=1e-4)
    _valid_alphas(_chunks(world, "forward", "alphas", 0), np.asarray(a_j), corpus)


@pytest.mark.parametrize("route", ["plain", "k8"])
def test_estep_time_sharded_matches_sequential(world, route):
    """Against the port's dense E-step (hmm_core.estep, plain path)."""
    corpus, params, log_init, log_trans, log_emit = w.sequence_inputs("estep")
    gamma_ref, width_ref, logz_ref = hmm_core.estep(params.log_jump, params.log_p0,
                                                    params.max_jump, log_emit, corpus,
                                                    use_kernels=False)
    key = f"estep_{route}"
    for r in world:
        np.testing.assert_allclose(r[key]["logz"], logz_ref.numpy(), rtol=1e-4, atol=1e-4)
        width = hmm_core.project_widths(torch.as_tensor(r[key]["xi"]), corpus.max_trg_len,
                                        params.max_jump)
        np.testing.assert_allclose(width.numpy(), width_ref.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_chunks(world, key, "gamma", 1), gamma_ref.numpy(), rtol=2e-3,
                               atol=2e-3)


@pytest.mark.parametrize("route", ["plain", "k8"])
def test_estep_time_sharded_matches_jax(world, route, seq_mesh):
    jc, _, (li, lt, le) = _jax_inputs("estep")
    gamma, xi, logz = estep_time_sharded(li, lt, le, jc.src_len, jcore.state_mask(jc), seq_mesh)
    key = f"estep_{route}"
    np.testing.assert_allclose(world[0][key]["logz"], np.asarray(logz), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(world[0][key]["xi"], np.asarray(xi), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_chunks(world, key, "gamma", 1), np.asarray(gamma), rtol=2e-3,
                               atol=2e-3)


def test_ranks_agree_and_ts_must_divide(world):
    for r in world[1:]:
        for key in ("estep_plain", "estep_k8"):
            assert np.array_equal(r[key]["xi"], world[0][key]["xi"])
    assert world[0]["indivisible"].startswith("ValueError")
    assert "must divide" in world[0]["indivisible"]
