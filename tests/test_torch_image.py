"""The port's image frontend and image generators against the JAX
reference, on the CPU.

Inputs come from numpy generators with fixed seeds.  Tolerances, and why:

- ``make_boxes_mini``, ``concept_palette`` and ``images_for_corpus``: the
  arrays equal for two seeds (the same numpy draws in the same order);
- VGG16 at input_size 32, fc_dim 64 and 10 classes, from the JAX
  package's init carried across by ``params_from_flax``: logits and fc2
  rtol 1e-4 atol 1e-5 (13 float32 convolutions summed in another order);
- ``crop_and_resize`` and ``preprocess``: atol 1e-6 (the same float32
  operations; the gathers are exact);
- ``resize``: rtol 1e-5 against ``jax.image.resize`` run op by op
  (``jax.disable_jit``).  Compiled, XLA on the CPU computes the resize
  weights' division approximately, which moves its output from its own
  formula by more than rtol 1e-5; op by op it computes the formula, as
  ``F.interpolate(antialias=True)`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data import synthetic as jsyn
from multimodalworddiscovery_tpu.frontend import image as jimg
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import synthetic as tsyn
from multimodalworddiscovery_tpu_torch.frontend import image as timg
from multimodalworddiscovery_tpu_torch.models import flax_params

VGG = dict(num_classes=10, fc_dim=64)
SIZE = 32
NET_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 5])
def test_image_generators_equal_the_references(seed):
    for got, want in zip(tsyn.make_boxes_mini(n_images=6, image_size=24, seed=seed),
                         jsyn.make_boxes_mini(n_images=6, image_size=24, seed=seed)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsyn.concept_palette(9, seed=seed),
                                  jsyn.concept_palette(9, seed=seed))
    kw = dict(n_utterances=8, n_concepts=9, min_concepts=2, max_concepts=4, seed=seed)
    jc, _, _ = jax_make(**kw)
    tc, _, _ = torch_make(**kw, device="cpu")
    for got, want in zip(tsyn.images_for_corpus(tc, image_size=24, seed=seed),
                         jsyn.images_for_corpus(jc, image_size=24, seed=seed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def vgg():
    mod = jimg.VGG16(**VGG)
    params = mod.init(jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32))
    model = timg.params_from_flax(jax.tree.map(np.asarray, params), device="cpu")
    return mod, params, model


def test_vgg16_matches_jax(vgg):
    mod, params, model = vgg
    assert (model.num_classes, model.fc_dim, model.input_size) == (10, 64, SIZE)
    x = np.random.default_rng(3).normal(size=(3, SIZE, SIZE, 3)).astype(np.float32)
    j_logits, j_fc2 = mod.apply(params, jnp.asarray(x))
    with torch.no_grad():
        t_logits, t_fc2 = model(torch.as_tensor(x))
    np.testing.assert_allclose(t_fc2.numpy(), np.asarray(j_fc2), **NET_TOL)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), **NET_TOL)


def test_image_concepts_and_region_embeddings_match_jax(vgg):
    mod, params, model = vgg
    rng = np.random.default_rng(4)
    imgs = rng.integers(0, 256, size=(2, SIZE, SIZE, 3)).astype(np.float32)
    want = np.asarray(jimg.image_concepts(mod, params, jnp.asarray(imgs)))
    got = timg.image_concepts(model, torch.as_tensor(imgs)).numpy()
    np.testing.assert_allclose(got, want, **NET_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)
    img = rng.integers(0, 256, size=(48, 40, 3)).astype(np.float32)
    boxes = np.array([[0.1, 0.1, 0.6, 0.5], [0.3, 0.2, 0.9, 0.95]], np.float32)
    crops = jimg.crop_and_resize(jimg.preprocess(jnp.asarray(img)), jnp.asarray(boxes), SIZE)
    want = np.asarray(mod.apply(params, crops)[1])
    got = timg.region_embeddings(model, torch.as_tensor(img), torch.as_tensor(boxes))
    np.testing.assert_allclose(got.numpy(), want, **NET_TOL)


def _torchvision_state_dict(model: nn.Module) -> dict:
    """The model's state dict, checked to hold torchvision's VGG16 names."""
    sd = model.state_dict()
    assert all(k.startswith(("features.", "classifier.")) for k in sd)
    assert {k for k in sd if k.startswith("classifier.")} == {
        f"classifier.{i}.{p}" for i in (0, 3, 6) for p in ("weight", "bias")}
    return sd


def test_load_torch_weights_round_trips(tmp_path, vgg):
    """A torchvision-layout state dict on disk loads into an equal model,
    whose forward equals the reference's ``load_torch_weights`` model."""
    _, _, model = vgg
    path = tmp_path / "vgg16.pt"
    torch.save(_torchvision_state_dict(model), path)
    loaded = timg.load_torch_weights(path, device="cpu")
    assert (loaded.num_classes, loaded.fc_dim, loaded.input_size) == (10, 64, SIZE)
    for (k, a), (_, b) in zip(model.state_dict().items(), loaded.state_dict().items()):
        assert torch.equal(a, b), k
    jmod, jparams = jimg.load_torch_weights(path)
    x = np.random.default_rng(5).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    with torch.no_grad():
        got = loaded(torch.as_tensor(x))
    for g, w in zip(got, jmod.apply(jparams, jnp.asarray(x))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **NET_TOL)


def test_flax_init_covers_conv2d():
    """flax_init draws Conv2d kernels lecun normal over fan_in = in*kh*kw
    (the std of the draws, within sampling error) and zeroes the biases."""
    conv = nn.Conv2d(16, 64, 3)
    flax_params.flax_init(conv, torch.Generator().manual_seed(0))
    assert torch.count_nonzero(conv.bias) == 0
    std = float(conv.weight.detach().std())
    assert abs(std - 1.0 / np.sqrt(16 * 9)) < 0.05 / np.sqrt(16 * 9)
    assert float(conv.weight.detach().abs().max()) <= 2.0 / np.sqrt(16 * 9) / 0.87962566 + 1e-6


def test_crop_and_resize_and_preprocess_match_jax():
    rng = np.random.default_rng(6)
    img = rng.normal(size=(37, 29, 3)).astype(np.float32)
    y1, x1 = rng.uniform(-0.1, 0.7, 6), rng.uniform(-0.1, 0.7, 6)
    boxes = np.stack([y1, x1, y1 + rng.uniform(0.05, 0.5, 6), x1 + rng.uniform(0.05, 0.5, 6)],
                     -1).astype(np.float32)
    boxes[0] = [0, 0, 1, 1]
    for size in (7, 16):
        want = np.asarray(jimg.crop_and_resize(jnp.asarray(img), jnp.asarray(boxes), size))
        got = timg.crop_and_resize(torch.as_tensor(img), torch.as_tensor(boxes), size)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    for x in (rng.integers(0, 256, size=(2, 5, 4, 3)).astype(np.uint8),
              rng.uniform(0, 1, size=(2, 5, 4, 3)).astype(np.float32)):
        want = np.asarray(jimg.preprocess(jnp.asarray(x)))
        got = timg.preprocess(torch.as_tensor(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(128, 160), (300, 260), (7, 3), (224, 100)])
def test_resize_matches_jax(shape):
    """Shrinking (antialiased), growing, and one axis unchanged."""
    img = np.random.default_rng(7).uniform(0, 255, size=(*shape, 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax.image.resize(jnp.asarray(img), (224, 224, 3), "bilinear"))
    got = timg.resize(torch.as_tensor(img), 224, 224).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_image_entry_points_default_to_cuda(tmp_path, vgg):
    """With no device named, the image frontend's constructors build on the
    card: on a host without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod, params, model = vgg
    torch.save(model.state_dict(), tmp_path / "w.pt")
    no_cuda = pytest.raises((AssertionError, RuntimeError), match="CUDA")
    with no_cuda:
        timg.init_vgg16(**VGG, input_size=SIZE)
    with no_cuda:
        timg.load_torch_weights(tmp_path / "w.pt")
    with no_cuda:
        timg.params_from_flax(jax.tree.map(np.asarray, params))
