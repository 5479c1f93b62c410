"""Port attention aligner vs the JAX reference.

The corpus comes from the numpy generator with a fixed seed (the same in
both packages); the JAX model's flax tree and AdamW state cross over with
``params_from_numpy``.  Sizes: N <= 16, dim 32.  Tolerances: logits and
attention weights rtol 1e-4 atol 1e-5; the loss rtol 1e-5; the parameters
after AdamW steps atol 1e-6; the guide matrix rtol 1e-5 atol 1e-6.

The exception are the elements whose gradient is zero up to rounding (every
key projection's bias, whose shift of a query row's logits the softmax
cancels, and now and then an element of another weight): Adam divides by the
gradient's scale and turns that rounding into a step of up to the learning
rate in either direction.  After one step, elements whose JAX gradient
(its first moment over 1 - b1) is below GRAD_FLOOR are held to having moved
at most the learning rate on both sides; every other element atol 1e-6, and
they are at least 95% of the elements.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import attention as jatt
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.models import attention as tatt
from multimodalworddiscovery_tpu_torch.models import flax_params
from multimodalworddiscovery_tpu_torch.models import hmm as thmm

GEN = dict(n_utterances=12, seed=4)
DIM = 32
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


JAX_STEP = jax.jit(jatt.em_step)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


GRAD_FLOOR = 1e-6


def _assert_step_matches(ts, js, before):
    """After ONE step: every element atol 1e-6 of the JAX one, but those
    whose JAX gradient is below GRAD_FLOOR (see above), which both sides
    moved by at most the learning rate."""
    load = lambda tree: flax_params.load_flax_tree(  # noqa: E731
        ts.model, _np_tree(tree), tatt._FLAX_NAMES, "cpu")
    assert int(js.opt_state[0].count) == 1
    grads = [m / (1 - 0.9) for m in load(js.opt_state[0].mu)]
    held = total = 0
    for (name, p), w, b, g in zip(ts.model.named_parameters(), load(js.params), before, grads):
        big = g.abs() >= GRAD_FLOOR
        torch.testing.assert_close(p.detach()[big], w[big], rtol=0, atol=1e-6, msg=name)
        bound = ts.learning_rate * (1 + 1e-3)
        for moved in (p.detach() - b, w - b):
            assert float(torch.cat([moved[~big].abs(), torch.zeros(1)]).max()) <= bound, name
        held, total = held + int(big.sum()), total + p.numel()
    assert held >= 0.95 * total, (held, total)


@pytest.fixture(scope="module")
def corpora():
    jc, jg, _ = jax_make(**GEN)
    tc, tg, _ = torch_make(**GEN, device="cpu")
    jfc, _, _ = jax_frames(jc, jg, feat_dim=5, seed=4)
    tfc, _, _ = torch_frames(tc, tg, feat_dim=5, seed=4, device="cpu")
    return {"discrete": (jc.pad_to(jc.n + 2), tc.pad_to(tc.n + 2)),
            "frames": (jfc.pad_to(jfc.n + 2), tfc.pad_to(tfc.n + 2))}


CASES = [("discrete", 1), ("discrete", 2), ("frames", 2), ("frames", 3)]


def _pair(corpora, kind, subsample, **kw):
    jc, tc = corpora[kind]
    js = jatt.init(jc, dim=DIM, subsample=subsample, key=jax.random.PRNGKey(1), **kw)
    ts = tatt.params_from_numpy(_np_tree(js.params), device="cpu",
                                entropy_weight=kw.get("entropy_weight", 0.0))
    return jc, tc, js, ts


@pytest.mark.parametrize("kind,subsample", CASES)
def test_forward_matches_jax(corpora, kind, subsample):
    jc, tc, js, ts = _pair(corpora, kind, subsample)
    mod = jatt._module(jc, DIM, subsample)
    j_logits, j_attn = jax.jit(mod.apply)(js.params, *jatt._inputs(jc))
    with torch.no_grad():
        t_logits, t_attn = ts.model(*tatt._inputs(tc))
    np.testing.assert_allclose(t_logits.numpy(), np.array(j_logits), **FWD_TOL)
    np.testing.assert_allclose(t_attn.numpy(), np.array(j_attn), **FWD_TOL)
    np.testing.assert_allclose(tatt.attention_matrix(ts, tc).numpy(),
                               np.array(jatt.attention_matrix(js, jc)), **FWD_TOL)
    np.testing.assert_array_equal(tatt.align(ts, tc).numpy(), np.array(jatt.align(js, jc)))
    np.testing.assert_allclose(float(tatt.loglik(ts, tc)), float(jatt.loglik(js, jc)),
                               rtol=1e-5)


def test_param_tree_is_complete(corpora):
    """Every flax leaf lands in exactly one torch parameter, shape for shape."""
    for kind, subsample in CASES:
        jc, _, js, ts = _pair(corpora, kind, subsample)
        leaves = {tuple(k.key for k in path)
                  for path, _ in jax.tree_util.tree_flatten_with_path(js.params["params"])[0]}
        paths = flax_params.flax_paths(ts.model, tatt._FLAX_NAMES)
        assert sorted(paths) == sorted(leaves) and len(set(paths)) == len(paths)


@pytest.mark.parametrize("kind,subsample,entropy_weight",
                         [("discrete", 1, 0.5), ("frames", 2, 0.0)])
def test_adamw_steps_match_jax(corpora, kind, subsample, entropy_weight):
    """Two AdamW steps: loss rtol 1e-5 each; parameters after the first as
    above; the JAX AdamW state carried in matches the port's and continues
    the same."""
    jc, tc, js, ts = _pair(corpora, kind, subsample, entropy_weight=entropy_weight)
    before = [p.detach().clone() for p in ts.model.parameters()]
    for step in range(2):
        js, jstats = JAX_STEP(js, jc)
        ts, tstats = tatt.em_step(ts, tc)
        np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tstats["loglik"]), float(jstats["loglik"]), rtol=1e-5)
        if step == 0:
            _assert_step_matches(ts, js, before)
    adam = js.opt_state[0]
    carried = tatt.params_from_numpy(
        _np_tree(js.params), adam=dict(count=np.asarray(adam.count), mu=_np_tree(adam.mu),
                                       nu=_np_tree(adam.nu)),
        entropy_weight=entropy_weight, device="cpu")
    assert carried.opt_state.count == ts.opt_state.count == 2
    for a, b in zip(carried.opt_state.mu, ts.opt_state.mu):
        torch.testing.assert_close(a, b, rtol=1e-3, atol=1e-6)
    js, jstats = JAX_STEP(js, jc)
    carried, cstats = tatt.em_step(carried, tc)
    np.testing.assert_allclose(float(cstats["loss"]), float(jstats["loss"]), rtol=1e-5)


@pytest.fixture(scope="module")
def teacher(corpora):
    jc, tc = corpora["discrete"]
    jh = jhmm.init(jc)
    for _ in range(3):
        jh, _ = jhmm.em_step(jh, jc)
    th = thmm.params_from_numpy(np.array(jh.log_emit), np.array(jh.log_jump),
                                np.array(jh.log_p0), jh.max_jump, device="cpu")
    return jh, th


@pytest.mark.parametrize("use_kernels", [False, True])
def test_hmm_guide_matrix_matches_jax(corpora, teacher, use_kernels):
    """The guide through the plain forward-backward (use_kernels=False) and
    through K4's route (its plain version on the CPU) against the JAX guide;
    the plain route's gamma is ``posteriors_from``'s."""
    jc, tc = corpora["discrete"]
    jh, th = teacher
    want = np.array(jatt.hmm_guide_matrix(jh, jc))
    got = tatt.hmm_guide_matrix(th, tc, use_kernels=use_kernels)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    gamma = thmm.posteriors(th, tc, use_kernels=use_kernels)
    from multimodalworddiscovery_tpu_torch.models import hmm_core

    plain = hmm_core.posteriors_from(*thmm._machinery(th, tc), tc)
    if use_kernels:
        torch.testing.assert_close(gamma, plain, rtol=1e-5, atol=1e-6)
    else:
        assert torch.equal(gamma, plain)


@pytest.mark.parametrize("subsample", [1, 2])
def test_guided_steps_match_jax(corpora, teacher, subsample):
    jc, tc, js, ts = _pair(corpora, "discrete", subsample)
    jh, th = teacher
    jg = jatt.hmm_guide_matrix(jh, jc)
    tg = tatt.hmm_guide_matrix(th, tc, use_kernels=False)
    before = [p.detach().clone() for p in ts.model.parameters()]
    for step in range(2):
        js, jstats = JAX_STEP(js, jc, guide=jg, guide_weight=0.7)
        ts, tstats = tatt.em_step(ts, tc, guide=tg, guide_weight=0.7)
        np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-5)
        if step == 0:
            _assert_step_matches(ts, js, before)
    np.testing.assert_allclose(tatt.pool_guide(tg, 3).numpy(),
                               np.array(_jax_pool(jg, 3)), rtol=1e-6, atol=1e-7)


def _jax_pool(guide, ss):
    import jax.numpy as jnp

    n, tt, ts = guide.shape
    ts_sub = -(-ts // ss)
    g = jnp.pad(guide, ((0, 0), (0, 0), (0, ts_sub * ss - ts)))
    g = jnp.sum(g.reshape(n, tt, ts_sub, ss), axis=-1)
    return g / jnp.maximum(jnp.sum(g, axis=-1, keepdims=True), 1e-9)


def test_init_and_train(corpora):
    """The port's own init: one seed gives one model; train lowers the loss
    and leaves its input state untouched."""
    _, tc = corpora["discrete"]
    s1 = tatt.init(tc, dim=DIM, generator=torch.Generator().manual_seed(3))
    s2 = tatt.init(tc, dim=DIM, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(s1.model.parameters(), s2.model.parameters()))
    before = [p.detach().clone() for p in s1.model.parameters()]
    s3, lls = tatt.train(s1, tc, 20)
    assert all(torch.equal(a, b) for a, b in zip(before, s1.model.parameters()))
    assert s3.step == 20 and lls.shape == (20,) and float(lls[-1]) > float(lls[0])


def test_same_pad_matches_xla():
    import jax.numpy as jnp
    from jax import lax

    rng = np.random.default_rng(0)
    for t, s in ((7, 2), (8, 2), (9, 3), (1, 3), (10, 4)):
        w = 2 * s - 1
        x = rng.normal(size=(2, 3, t)).astype(np.float32)
        k = rng.normal(size=(4, 3, w)).astype(np.float32)
        want = lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (s,), "SAME")
        got = torch.nn.functional.conv1d(tatt.same_pad(torch.as_tensor(x), w, s),
                                         torch.as_tensor(k), stride=s)
        np.testing.assert_allclose(got.numpy(), np.array(want), rtol=1e-5, atol=1e-6)
