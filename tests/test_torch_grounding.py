"""Port grounding baseline vs the JAX reference.

The corpus comes from the numpy generator with a fixed seed (the same in
both packages); the flax tree and Adam state cross over with
``params_from_numpy``.  Sizes: N <= 16, dim 32.  Tolerances: embeddings and
scores rtol 1e-5 atol 1e-6; the loss rtol 1e-5; the parameters after one
Adam step atol 1e-6, except elements whose gradient is nonzero but below
1e-6 (zero up to rounding, which Adam's division by the gradient's scale
turns into a step of up to the learning rate), held to having moved at most
that; at least 95% of the elements are held to atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.corpus import Corpus as JCorpus
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import grounding as jgr
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus as TCorpus
from multimodalworddiscovery_tpu_torch.models import flax_params
from multimodalworddiscovery_tpu_torch.models import grounding as tgr

GEN = dict(n_utterances=12, seed=6)
DIM = 32
TOL = dict(rtol=1e-5, atol=1e-6)
JAX_STEP = jax.jit(jgr.em_step)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpora():
    jc, jg, _ = jax_make(**GEN)
    tc, tg, _ = torch_make(**GEN, device="cpu")
    jfc, _, _ = jax_frames(jc, jg, feat_dim=5, seed=6)
    tfc, _, _ = torch_frames(tc, tg, feat_dim=5, seed=6, device="cpu")
    # region features: each concept a fixed random 7-vector, padding zeros
    table = np.random.default_rng(0).normal(size=(jc.trg_vocab, 7)).astype(np.float32)
    feats = np.where(np.array(jc.trg_mask())[..., None], table[np.array(jc.trg)], 0.0)
    jr = JCorpus(src=jc.src, src_len=jc.src_len, trg=jnp.asarray(feats), trg_len=jc.trg_len,
                 src_vocab=jc.src_vocab, trg_vocab=0)
    tr = TCorpus(src=tc.src, src_len=tc.src_len, trg=torch.as_tensor(feats),
                 trg_len=tc.trg_len, src_vocab=tc.src_vocab, trg_vocab=0)
    return {"discrete": (jc.pad_to(jc.n + 2), tc.pad_to(tc.n + 2)),
            "frames": (jfc.pad_to(jfc.n + 2), tfc.pad_to(tfc.n + 2)),
            "regions": (jr, tr)}


def _pair(corpora, kind):
    jc, tc = corpora[kind]
    js = jgr.init(jc, dim=DIM, key=jax.random.PRNGKey(2))
    return jc, tc, js, tgr.params_from_numpy(_np_tree(js.params), device="cpu")


@pytest.mark.parametrize("kind", ["discrete", "frames", "regions"])
def test_forward_and_scores_match_jax(corpora, kind):
    jc, tc, js, ts = _pair(corpora, kind)
    leaves = {tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(js.params["params"])[0]}
    assert sorted(flax_params.flax_paths(ts.model, tgr._flax_names(ts.model))) == sorted(leaves)
    j_s, j_r = jgr._module(jc, DIM).apply(js.params, jc.src, jc.trg)
    t_s, t_r = tgr._embed(ts, tc)
    np.testing.assert_allclose(t_s.numpy(), np.array(j_s), **TOL)
    np.testing.assert_allclose(t_r.numpy(), np.array(j_r), **TOL)
    np.testing.assert_allclose(tgr.retrieval_scores(ts, tc).numpy(),
                               np.array(jgr.retrieval_scores(js, jc)), **TOL)
    np.testing.assert_array_equal(tgr.align(ts, tc).numpy(), np.array(jgr.align(js, jc)))
    np.testing.assert_allclose(float(tgr._loss_fn(ts.model, tc, 1.0)),
                               float(jgr._loss_fn(js.params, jgr._module(jc, DIM), jc, 1.0)),
                               rtol=1e-5)


@pytest.mark.parametrize("direction", ["c2i", "i2c"])
def test_pooled_scores_match_jax(corpora, direction, monkeypatch):
    jc, tc, js, ts = _pair(corpora, "discrete")
    rng = np.random.default_rng(1)
    cand = np.concatenate([np.arange(jc.n)[:, None], rng.integers(0, jc.n, (jc.n, 5))], 1)
    want = np.array(jgr.retrieval_scores_pooled(js, jc, jnp.asarray(cand), direction=direction))
    # chunks of 3 rows
    monkeypatch.setattr(tgr, "POOL_CHUNK_BYTES", 3 * 4 * 6 * tc.max_src_len * tc.max_trg_len)
    got = tgr.retrieval_scores_pooled(ts, tc, torch.as_tensor(cand), direction=direction)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("kind", ["discrete", "frames"])
def test_adam_steps_match_jax(corpora, kind):
    """One Adam step as in the module docstring, a second step's loss rtol
    1e-5, and the carried Adam state continues the same."""
    jc, tc, js, ts = _pair(corpora, kind)
    names = tgr._flax_names(ts.model)

    def load(tree):
        return flax_params.load_flax_tree(ts.model, _np_tree(tree), names, "cpu")

    before = [p.detach().clone() for p in ts.model.parameters()]
    js, jstats = JAX_STEP(js, jc)
    ts, tstats = tgr.em_step(ts, tc)
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-5)
    grads = [m / (1 - 0.9) for m in load(js.opt_state[0].mu)]
    held = total = 0
    for (name, p), w, b, g in zip(ts.model.named_parameters(), load(js.params), before, grads):
        big = (g.abs() >= 1e-6) | (g == 0)
        torch.testing.assert_close(p.detach()[big], w[big], rtol=0, atol=1e-6, msg=name)
        for moved in (p.detach() - b, w - b):
            assert float(torch.cat([moved[~big].abs(), torch.zeros(1)]).max()) \
                <= ts.learning_rate * (1 + 1e-3), name
        held, total = held + int(big.sum()), total + p.numel()
    assert held >= 0.95 * total, (held, total)
    adam = js.opt_state[0]
    carried = tgr.params_from_numpy(_np_tree(js.params), adam=dict(
        count=np.asarray(adam.count), mu=_np_tree(adam.mu), nu=_np_tree(adam.nu)), device="cpu")
    js, jstats = JAX_STEP(js, jc)
    ts, tstats = tgr.em_step(ts, tc)
    carried, cstats = tgr.em_step(carried, tc)
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(cstats["loss"]), float(jstats["loss"]), rtol=1e-5)


def test_l2_normalize_gradient_finite_at_zero():
    x = torch.zeros(2, 4, requires_grad=True)
    y = tgr._l2_normalize(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert bool(torch.isfinite(g).all()) and bool((y == 0).all())


def test_amax_splits_tied_gradient():
    """The max over regions splits the gradient over tied regions, as JAX."""
    x = jnp.array([[1.0, 3.0, 3.0]])
    jg = np.array(jax.grad(lambda v: jnp.max(v, axis=-1).sum())(x))
    t = torch.tensor([[1.0, 3.0, 3.0]], requires_grad=True)
    (tg,) = torch.autograd.grad(torch.amax(t, dim=-1).sum(), t)
    np.testing.assert_array_equal(tg.numpy(), jg)


def test_init_and_train(corpora):
    _, tc = corpora["discrete"]
    s1 = tgr.init(tc, dim=DIM, generator=torch.Generator().manual_seed(3))
    s2 = tgr.init(tc, dim=DIM, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a, b) for a, b in zip(s1.model.parameters(), s2.model.parameters()))
    s3, lls = tgr.train(s1, tc, 15)
    assert s3.step == 15 and float(lls[-1]) > float(lls[0])
