"""The port's end-to-end CRF aligner (models/hmm_crf.py) against the JAX
reference, on the CPU.

Corpus and initial parameters as in tests/test_torch_hmm_dnn.py (N=12,
feat_dim 8, hidden 32, n_sgd 3; the port's parameters carried into the JAX
package).  Tolerances, and why:

- ``logmarginal``'s gradient in log_emit is gamma itself: exact against
  the port's E-step, rtol 1e-3 atol 1e-5 against the reference's custom
  VJP (its gamma from another float32 scan);
- MLP and transition gradients against ``jax.grad``: rtol 1e-4, atol 1e-4
  x the tensor's largest entry (float32 sums over ~10^3 frames in another
  order);
- the transition gradients against float64 central differences of the
  dense forward: rtol 2e-3 atol 2e-3 (tests/test_hmm_crf.py:104-146);
- three ``em_step``s of each aligner: loglik and the last Adam step's
  loss rtol 1e-4 at each step, parameters rtol 1e-3 atol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crf_reference import corpora, mlp_to_numpy, port_init, to_jax
from multimodalworddiscovery_tpu.models import hmm_crf as jcrf
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.models import hmm_crf as tcrf
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as td

CORPUS = dict(n_utterances=12, seed=33)
FRAMES = dict(feat_dim=8, noise=0.1, seed=33)
MODEL = dict(max_jump=3, hidden=32, learning_rate=1e-3, n_sgd=3)


@pytest.fixture(scope="module")
def setup():
    fc, fg, tfc = corpora(CORPUS, FRAMES)
    tp = port_init(tfc, False, MODEL)
    return fc, tfc, tp, to_jax(tp)


def _grad_close(got: torch.Tensor, want, rtol=1e-4):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=1e-4 * scale)


def _n_frames(c):
    return torch.clamp(c.src_mask().sum(), min=1).to(torch.float32)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_logmarginal_gradient_is_gamma(setup, use_kernels):
    """Through the dense E-step and through K4's plain version: the
    gradient in log_emit is the E-step's gamma, zero off the valid frames,
    and equals the reference's custom-VJP gradient."""
    fc, tfc, tp, jp = setup
    le = tcrf._log_emit_from_mlp(tp.mlp, tfc).detach().requires_grad_()
    ll = tcrf.logmarginal(tp.max_jump, use_kernels, "float32", tp.log_jump, tp.log_p0, le, tfc)
    (g,) = torch.autograd.grad(ll, [le])
    gamma, _, logz = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, le.detach(), tfc,
                                 use_kernels=use_kernels)
    assert torch.equal(g, gamma) and float(ll.detach()) == float(logz.sum())
    mask = tfc.src_mask()
    torch.testing.assert_close(g.sum(-1)[mask], torch.ones(int(mask.sum())), rtol=0, atol=1e-4)
    assert torch.all(g[~mask] == 0)
    j_le = jcrf._log_emit_from_mlp(jp.mlp, jp, fc)
    g_w = jax.grad(lambda x: jcrf.logmarginal(jp.max_jump, False, "float32", jp.log_jump,
                                              jp.log_p0, x, fc))(j_le)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_w), rtol=1e-3, atol=1e-5)


def test_mlp_gradients_match_jax(setup):
    """The first Adam step's gradient of -logZ / frames in the MLP's
    weights, through the self-consistent prior."""
    fc, tfc, tp, jp = setup
    weights = list(tp.mlp.parameters())
    loss = -tcrf.logmarginal(tp.max_jump, None, "float32", tp.log_jump, tp.log_p0,
                             tcrf._log_emit_from_mlp(tp.mlp, tfc), tfc) / _n_frames(tfc)
    grads = torch.autograd.grad(loss, weights)
    n_frames = jnp.maximum(jnp.sum(fc.src_mask()), 1).astype(jnp.float32)
    g_w = jax.grad(lambda mlp: -jcrf.logmarginal(
        jp.max_jump, False, "float32", jp.log_jump, jp.log_p0,
        jcrf._log_emit_from_mlp(mlp, jp, fc), fc) / n_frames)(jp.mlp)["params"]
    for i in range(3):
        _grad_close(grads[2 * i], np.asarray(g_w[f"Dense_{i}"]["kernel"]).T)
        _grad_close(grads[2 * i + 1], g_w[f"Dense_{i}"]["bias"])


@pytest.fixture(scope="module")
def e2e_inputs(setup):
    fc, tfc, tp, jp = setup
    return (tcrf._log_emit_from_mlp(tp.mlp, tfc).detach(),
            jcrf._log_emit_from_mlp(jp.mlp, jp, fc))


@pytest.mark.parametrize("use_kernels", [False, True])
def test_e2e_transition_gradients_match_jax(setup, e2e_inputs, use_kernels):
    fc, tfc, tp, jp = setup
    le, j_le = e2e_inputs
    lj = tp.log_jump.clone().requires_grad_()
    lp0 = tp.log_p0.clone().requires_grad_()
    ll = tcrf.logmarginal_e2e(tp.max_jump, use_kernels, "float32", lj, lp0, le, tfc)
    g_lj, g_lp0 = torch.autograd.grad(ll, [lj, lp0])
    w_lj, w_lp0 = jax.grad(
        lambda a, b: jcrf.logmarginal_e2e(jp.max_jump, False, "float32", a, b, j_le, fc),
        argnums=(0, 1))(jp.log_jump, jp.log_p0)
    _grad_close(g_lj, w_lj)
    np.testing.assert_allclose(float(g_lp0), float(w_lp0), rtol=1e-4, atol=1e-4)


def test_e2e_transition_gradients_match_finite_differences(setup, e2e_inputs):
    """Float64 central differences of the port's dense forward."""
    _, tfc, tp, _ = setup
    le, _ = e2e_inputs
    lj = tp.log_jump.clone().requires_grad_()
    lp0 = tp.log_p0.clone().requires_grad_()
    ll = tcrf.logmarginal_e2e(tp.max_jump, False, "float32", lj, lp0, le, tfc)
    g_lj, g_lp0 = torch.autograd.grad(ll, [lj, lp0])

    le64 = le.double()

    def f(lj64, lp064):
        li = tcore.build_log_init(lp064, tfc)
        lt = tcore.build_log_trans(lj64, lp064, tfc, tp.max_jump)
        return float(tcore.forward(li, lt, le64, tfc.src_len)[1].sum())

    lj0, p00 = tp.log_jump.double(), tp.log_p0.double()
    eps = 1e-5
    fd_jump = []
    for k in range(lj0.numel()):
        e = torch.zeros_like(lj0)
        e[k] = eps
        fd_jump.append((f(lj0 + e, p00) - f(lj0 - e, p00)) / (2 * eps))
    fd_p0 = (f(lj0, p00 + eps) - f(lj0, p00 - eps)) / (2 * eps)
    np.testing.assert_allclose(g_lj.numpy(), fd_jump, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(float(g_lp0), fd_p0, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("learn_transitions", [False, True])
def test_em_steps_match_jax(learn_transitions):
    """Three hybrid iterations of each aligner from the same parameters."""
    fc, _, tfc = corpora(CORPUS, FRAMES)
    tp = port_init(tfc, learn_transitions, MODEL)
    jp = to_jax(tp, learn_transitions)
    for _ in range(3):
        jp, s_w = jcrf.em_step(jp, fc, learn_transitions=learn_transitions)
        tp, s = tcrf.em_step(tp, tfc, learn_transitions=learn_transitions)
        np.testing.assert_allclose(float(s["loglik"]), float(s_w["loglik"]), rtol=1e-4)
        np.testing.assert_allclose(float(s["nll_per_frame"]), float(s_w["nll_per_frame"]),
                                   rtol=1e-4)
    for f in ("log_prior", "log_jump", "log_p0"):
        np.testing.assert_allclose(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)),
                                   rtol=1e-3, atol=1e-4, err_msg=f)
    got = mlp_to_numpy(tp.mlp)["params"]
    for name, layer in jp.mlp["params"].items():
        np.testing.assert_allclose(got[name]["kernel"], np.asarray(layer["kernel"]), rtol=1e-3,
                                   atol=1e-4, err_msg=name)
    if learn_transitions:
        assert tp.opt_state["trans"].count == 3 * MODEL["n_sgd"]
    np.testing.assert_array_equal(tcrf.align(tp, tfc).numpy(), np.asarray(jcrf.align(jp, fc)))


def test_kernel_route_em_step_matches_plain(setup):
    """One CRF iteration with the E-steps through K4's plain version and
    through the dense plain path: loglik rtol 1e-5."""
    _, tfc, tp, _ = setup
    p_k, s_k = tcrf.em_step(tp, tfc, use_kernels=True)
    p_p, s_p = tcrf.em_step(tp, tfc, use_kernels=False)
    np.testing.assert_allclose(float(s_k["loglik"]), float(s_p["loglik"]), rtol=1e-5)
    torch.testing.assert_close(p_k.log_jump, p_p.log_jump, rtol=1e-4, atol=1e-5)


def test_train_stacks_logliks_and_checks_its_state(setup):
    _, tfc, tp, _ = setup
    p, lls = tcrf.train(tp, tfc, 2)
    assert lls.shape == (2,) and torch.all(torch.isfinite(lls))
    assert p.opt_state["mlp"].count == 2 * MODEL["n_sgd"]
    with pytest.raises(ValueError, match="init_e2e"):
        tcrf.em_step(tp, tfc, learn_transitions=True)
    assert tcrf.init is td.init and tcrf.align is td.align
