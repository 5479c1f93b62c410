"""Port minibatch trainer and model registry vs the JAX reference.

``gather_batch`` selects the same rows as the reference's; a minibatch step
equals ``em_step`` on the batch its generator draws; the samplers keep
their protocols; the mesh forms reject a non-mesh (they run on gloo ranks
in tests/test_torch_parallel.py; the streamed trainer is tested in
tests/test_torch_stream.py); the registry
returns the eight aligners under the reference's names.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import minibatch as jmb
from multimodalworddiscovery_tpu.models import registry as jreg
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import attention, grounding
from multimodalworddiscovery_tpu_torch.models import minibatch as tmb
from multimodalworddiscovery_tpu_torch.models import registry as treg

GEN = dict(n_utterances=20, seed=8)


@pytest.fixture(scope="module")
def corpora():
    jc, _, _ = jax_make(**GEN)
    tc, _, _ = torch_make(**GEN, device="cpu")
    return jc.pad_to(jc.n + 3), tc.pad_to(tc.n + 3)


def test_gather_batch_matches_jax(corpora):
    jc, tc = corpora
    idx = np.array([5, 0, 22, 5, 13], np.int32)
    jb = jmb.gather_batch(jc, jnp.asarray(idx))
    tb = tmb.gather_batch(tc, torch.as_tensor(idx))
    for f in ("src", "src_len", "trg", "trg_len"):
        np.testing.assert_array_equal(getattr(tb, f).numpy(), np.array(getattr(jb, f)), f)
    assert (tb.src_vocab, tb.trg_vocab) == (jb.src_vocab, jb.trg_vocab)


@pytest.mark.parametrize("model", ["attention", "grounding"])
@pytest.mark.parametrize("sample", ["global", "valid"])
def test_step_equals_em_step_on_its_batch(corpora, model, sample):
    _, tc = corpora
    mod = {"attention": attention, "grounding": grounding}[model]
    state = mod.init(tc, dim=16, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(11)
    twin = torch.Generator().manual_seed(11)
    step = tmb.make_minibatch_step(mod.em_step, tc, 8, sample=sample)
    s1, stats = step(state, gen)
    if sample == "valid":
        probs = (tc.src_len > 0).to(torch.float32)
        idx = torch.multinomial(probs, 8, replacement=True, generator=twin)
    else:
        idx = torch.randperm(tc.n, generator=twin)[:8]
    s2, want = mod.em_step(state, tmb.gather_batch(tc, idx))
    assert float(stats["loss"]) == float(want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(s1.model.parameters(), s2.model.parameters()))


def test_samplers_keep_their_protocols(corpora):
    _, tc = corpora
    seen = []
    step = tmb.make_minibatch_step(lambda s, b: (s, {"loglik": b.src_len.sum()}), tc, 10,
                                   sample="global", bind_corpus=False)
    gen = torch.Generator().manual_seed(1)
    rows = {tuple(r.tolist()) for r in tc.src}
    for _ in range(5):
        _, out = step(None, gen, tc)
        seen.append(float(out["loglik"]))
    assert len(set(seen)) > 1  # each call draws afresh
    valid = tmb.make_minibatch_step(lambda s, b: (s, b), tc, 23, sample="valid")
    _, batch = valid(None, torch.Generator().manual_seed(2))
    assert bool((batch.src_len > 0).all())  # never a zero-length row
    _, batch = tmb.make_minibatch_step(lambda s, b: (s, b), tc, tc.n)(
        None, torch.Generator().manual_seed(3))
    assert {tuple(r.tolist()) for r in batch.src} == rows  # without replacement
    with pytest.raises(ValueError, match="batch_size"):
        tmb.make_minibatch_step(attention.em_step, tc, tc.n + 1)
    with pytest.raises(ValueError, match="sample"):
        tmb.make_minibatch_step(attention.em_step, tc, 4, sample="stratified")


def test_mesh_and_streaming_forms_raise(corpora):
    """The mesh forms take a 1-D DeviceMesh (tests/test_torch_parallel.py
    runs them on gloo ranks): any other object is a TypeError, and local
    sampling needs a mesh, as in the reference."""
    _, tc = corpora
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmb.make_minibatch_step(attention.em_step, tc, 4, mesh=object())
    with pytest.raises(ValueError, match="requires a mesh"):
        tmb.make_minibatch_step(attention.em_step, tc, 4, sample="local")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmb.sample_local_batch(tc, torch.Generator(), 4, object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmb.train_minibatch(attention.em_step, None, tc, 4, 1, mesh=object())


def test_train_minibatch_lowers_the_loss(corpora):
    _, tc = corpora
    state = grounding.init(tc, dim=16, generator=torch.Generator().manual_seed(0))
    state, lls = tmb.train_minibatch(grounding.em_step, state, tc, 16, 30,
                                     generator=torch.Generator().manual_seed(4))
    assert len(lls) == 30 and state.step == 30
    assert np.mean(lls[-5:]) > np.mean(lls[:5])  # loglik = -loss rises


def test_registry_names():
    names = ("model1", "hmm", "hmm_gaussian", "hmm_dnn", "hmm_crf", "attention", "grounding",
             "segmental_kmeans")
    for name in names:
        mod = treg.get_model(name)
        assert mod.__name__ == f"multimodalworddiscovery_tpu_torch.models.{name}"
        assert jreg.get_model(name).__name__.rsplit(".", 1)[1] == name
        assert hasattr(mod, "init") and (hasattr(mod, "align") or hasattr(mod, "discover"))
    for bad in ("bucketed", "Model1", ""):
        with pytest.raises(KeyError):
            treg.get_model(bad)
