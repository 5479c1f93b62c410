"""The port's DNN-HMM (models/hmm_dnn.py) against the JAX reference, on the
CPU.

The frame corpus comes from the same numpy generator on both sides (N=12,
feat_dim 8, noise 0.1, seed 31; hidden 32, n_sgd 3, as in
tests/test_hmm_crf.py:14-17).  The initial parameters are the port's,
carried into the JAX package with ``tests/crf_reference.to_jax`` (the MLP's
torch weights [out, in] become flax kernels [in, out]), so both sides start
from the same point.  Tolerances, and why:

- the MLP's logits on the same weights: rtol 1e-5 atol 1e-5 (the same
  float32 products, summed in another order);
- one E-step (frame posteriors, prior and width counts, logZ): rtol 1e-4,
  atol 1e-5 x the quantity's scale;
- generalized-EM trajectories (3 steps: E-step, closed-form M-step, 3 Adam
  steps): loglik and CE rtol 1e-4 at each step, parameters rtol 1e-3 atol
  1e-4 (float32 Adam steps of two libraries);
- decode: equal alignments.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crf_reference import corpora, mlp_to_numpy, port_init, to_jax
from multimodalworddiscovery_tpu.models import hmm_dnn as jd
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as td

CORPUS = dict(n_utterances=12, seed=31)
FRAMES = dict(feat_dim=8, noise=0.1, seed=31)
MODEL = dict(max_jump=3, hidden=32, learning_rate=1e-3, n_sgd=3)


@pytest.fixture(scope="module")
def setup():
    fc, fg, tfc = corpora(CORPUS, FRAMES)
    tp = port_init(tfc, False, MODEL)
    return fc, fg, tfc, tp, to_jax(tp)


def _close(got: torch.Tensor, want, rtol=1e-4, atol_rel=1e-5):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol_rel * scale)


def _weights_close(tp, jp, rtol, atol):
    got = mlp_to_numpy(tp.mlp)["params"]
    for name, layer in jp.mlp["params"].items():
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(got[name][k], np.asarray(layer[k]), rtol=rtol, atol=atol,
                                       err_msg=f"{name}.{k}")


def test_initial_weights_are_flax_dense_init():
    """lecun normal truncated at +-2 sigma, biases 0, from the CPU generator:
    one seed gives one set of weights, on any device."""
    _, _, tfc = corpora(CORPUS, FRAMES)
    a = port_init(tfc, False, MODEL)
    b = port_init(tfc, False, MODEL)
    c = port_init(tfc, False, MODEL, seed=1)
    for la, lb, lc in zip(a.mlp.dense, b.mlp.dense, c.mlp.dense):
        sigma = 1.0 / np.sqrt(la.in_features) / 0.87962566103423978
        w = la.weight.detach()
        assert torch.equal(w, lb.weight) and not torch.equal(w, lc.weight)
        assert float(w.abs().max()) <= 2 * sigma * (1 + 1e-6)
        assert abs(float(w.std()) - sigma * 0.87962566) < 0.1 * sigma
        assert torch.all(la.bias == 0)
    assert a.log_prior.shape == (tfc.trg_vocab,) and a.opt_state["mlp"].count == 0


def test_mlp_logits_match_flax(setup):
    """The weights cross with the right transpose: the port's MLP and the
    flax module give the same logits."""
    fc, _, tfc, tp, jp = setup
    want = jd._module(fc, MODEL["hidden"]).apply(jp.mlp, fc.src)
    with torch.no_grad():
        got = tp.mlp(tfc.src)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_params_from_numpy_round_trip(setup):
    _, _, _, tp, jp = setup
    back = td.params_from_numpy(jax.tree.map(np.asarray, jp.mlp), jp.log_prior, jp.log_jump,
                                jp.log_p0, max_jump=jp.max_jump, hidden=jp.hidden,
                                learning_rate=jp.learning_rate, n_sgd=jp.n_sgd, device="cpu")
    for a, b in zip(back.mlp.parameters(), tp.mlp.parameters()):
        assert torch.equal(a, b)
    assert back.hidden == tp.hidden and back.n_sgd == tp.n_sgd


@pytest.mark.parametrize("use_kernels", [False, True])
def test_frame_posteriors_match_jax(setup, use_kernels):
    """Through the plain dense E-step and through K4's plain version."""
    fc, _, tfc, tp, jp = setup
    r_w, wc_w, z_w = jd.frame_posteriors(jp, fc)
    r, wc, z = td.frame_posteriors(tp, tfc, use_kernels=use_kernels)
    _close(r, r_w)
    _close(wc, wc_w)
    _close(z, z_w)


def test_expected_counts_and_m_step_match_jax(setup):
    fc, _, tfc, tp, jp = setup
    c_w, ll_w = jd.expected_counts(jp, fc)
    c, ll = td.expected_counts(tp, tfc)
    _close(c["prior"], c_w["prior"])
    _close(c["width"], c_w["width"])
    np.testing.assert_allclose(float(ll), float(ll_w), rtol=1e-4)
    jm = jd.m_step(jp, c_w)
    tm = td.m_step(tp, {k: torch.as_tensor(np.array(v)) for k, v in c_w.items()})
    for f in ("log_prior", "log_jump", "log_p0"):
        np.testing.assert_allclose(getattr(tm, f).numpy(), np.asarray(getattr(jm, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)


def test_loglik_and_posteriors_match_jax(setup):
    fc, _, tfc, tp, jp = setup
    np.testing.assert_allclose(float(td.loglik(tp, tfc)), float(jd.loglik(jp, fc)), rtol=1e-5)
    _close(td.posteriors(tp, tfc), jd.posteriors(jp, fc))


def test_em_steps_match_jax(setup):
    """Three generalized-EM steps from the same parameters."""
    fc, _, tfc, tp, jp = setup
    for _ in range(3):
        jp, s_w = jd.em_step(jp, fc)
        tp, s = td.em_step(tp, tfc)
        np.testing.assert_allclose(float(s["loglik"]), float(s_w["loglik"]), rtol=1e-4)
        np.testing.assert_allclose(float(s["ce"]), float(s_w["ce"]), rtol=1e-4)
    _weights_close(tp, jp, rtol=1e-3, atol=1e-4)
    for f in ("log_prior", "log_jump", "log_p0"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)
    assert tp.opt_state["mlp"].count == 9
    np.testing.assert_array_equal(td.align(tp, tfc).numpy(), np.asarray(jd.align(jp, fc)))


def test_em_step_leaves_its_input_untouched(setup):
    _, _, tfc, tp, _ = setup
    before = [p.detach().clone() for p in tp.mlp.parameters()]
    new, _ = td.em_step(tp, tfc)
    assert all(torch.equal(a, b) for a, b in zip(before, tp.mlp.parameters()))
    assert new.mlp is not tp.mlp and tp.opt_state["mlp"].count == 0


def test_params_from_numpy_carries_the_adam_state(setup):
    """After a JAX step the Adam moments are nonzero; carried across
    (transposed like the kernels), the next step matches JAX's."""
    fc, _, tfc, _, jp = setup
    jp, _ = jd.em_step(jp, fc)
    adam = jp.opt_state[0]
    tp = td.params_from_numpy(
        jax.tree.map(np.asarray, jp.mlp), jp.log_prior, jp.log_jump, jp.log_p0,
        max_jump=jp.max_jump, hidden=jp.hidden, learning_rate=jp.learning_rate,
        n_sgd=jp.n_sgd, adam={"count": adam.count, "mu": jax.tree.map(np.asarray, adam.mu),
                              "nu": jax.tree.map(np.asarray, adam.nu)}, device="cpu")
    assert tp.opt_state["mlp"].count == MODEL["n_sgd"]
    jp, s_w = jd.em_step(jp, fc)
    tp, s = td.em_step(tp, tfc)
    np.testing.assert_allclose(float(s["ce"]), float(s_w["ce"]), rtol=1e-4)
    _weights_close(tp, jp, rtol=1e-3, atol=1e-4)


def test_neural_m_step_over_batches_matches_jax(setup):
    """The neural M-step pooled over two batches (length buckets)."""
    fc, _, tfc, tp, jp = setup
    r_w, _, _ = jd.frame_posteriors(jp, fc)
    r = torch.as_tensor(np.array(r_w))
    halves = (slice(0, fc.n // 2), slice(fc.n // 2, None))

    def take(c, sl):
        return dataclasses.replace(c, src=c.src[sl], src_len=c.src_len[sl], trg=c.trg[sl],
                                   trg_len=c.trg_len[sl])

    j_batches = [(take(fc, sl), jnp.asarray(r_w)[sl]) for sl in halves]
    t_batches = [(take(tfc, sl), r[sl]) for sl in halves]
    jp2, ce_w = jd.neural_m_step(jp, j_batches)
    tp2, ce = td.neural_m_step(tp, t_batches)
    np.testing.assert_allclose(float(ce), float(ce_w), rtol=1e-4)
    _weights_close(tp2, jp2, rtol=1e-3, atol=1e-4)


def test_train_stacks_logliks(setup):
    _, _, tfc, tp, _ = setup
    p, lls = td.train(tp, tfc, 2)
    assert lls.shape == (2,) and torch.all(torch.isfinite(lls))
    assert p.opt_state["mlp"].count == 2 * MODEL["n_sgd"]


def test_dnn_hmm_needs_frames():
    corpus, _, _ = make_flickr8k_mini(n_utterances=4, seed=1, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        td.init(corpus)
