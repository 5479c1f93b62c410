"""The port's pretrained frontends (HuBERT speech, CLIP regions) against the
JAX package's, on the CPU.

Both run the same ``transformers`` models; the reference's are already
torch.  Tiny random-init checkpoints written with ``save_pretrained`` stand
in for the real ones (no network), as in tests/test_pretrained_frontend.py.
The port's outputs must equal the reference's exactly (the same models on
the same inputs, on the CPU).  The card's host has no ``transformers``, so
these run only here.
"""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.frontend import pretrained as jpre
from multimodalworddiscovery_tpu_torch.frontend import pretrained as tpre

transformers = pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def hubert_ckpt(tmp_path_factory):
    from transformers import HubertConfig, HubertModel

    cfg = HubertConfig(
        hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
        intermediate_size=64, conv_dim=(16, 16), conv_kernel=(10, 3),
        conv_stride=(5, 2), num_feat_extract_layers=2,
    )
    torch.manual_seed(0)
    d = tmp_path_factory.mktemp("hubert")
    HubertModel(cfg).save_pretrained(d)
    return d


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    from transformers import (
        CLIPConfig, CLIPImageProcessor, CLIPModel, CLIPTextConfig, CLIPVisionConfig,
    )

    cfg = CLIPConfig(
        text_config=CLIPTextConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=16, vocab_size=99,
        ).to_dict(),
        vision_config=CLIPVisionConfig(
            hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, image_size=32, patch_size=16,
        ).to_dict(),
        projection_dim=24,
    )
    torch.manual_seed(1)
    d = tmp_path_factory.mktemp("clip")
    CLIPModel(cfg).save_pretrained(d)
    CLIPImageProcessor(size={"shortest_edge": 32}, crop_size=32).save_pretrained(d)
    return d


def test_checkpoint_available(tmp_path, hubert_ckpt):
    for path in (tmp_path / "nope", tmp_path, hubert_ckpt):
        assert tpre.checkpoint_available(path) == jpre.checkpoint_available(path)
    assert tpre.checkpoint_available(hubert_ckpt)


def test_extract_hubert_equals_the_references(hubert_ckpt):
    rng = np.random.default_rng(0)
    wavs = [rng.normal(size=4000).astype(np.float32), rng.normal(size=6400).astype(np.float32)]
    got = tpre.extract_hubert(wavs, hubert_ckpt, layer=1, device="cpu")
    want = jpre.extract_hubert(wavs, hubert_ckpt, layer=1)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.shape[1] == 32
        np.testing.assert_array_equal(g, w)


def test_extract_clip_regions_equals_the_references(clip_ckpt):
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 255, size=(64, 96, 3)).astype(np.uint8)
    boxes = np.asarray([[0.0, 0.0, 0.5, 0.5], [0.25, 0.25, 1.0, 1.0], [0.4, 0.1, 0.9, 0.3]])
    got = tpre.extract_clip_regions(image, boxes, clip_ckpt, device="cpu")
    want = jpre.extract_clip_regions(image, boxes, clip_ckpt)
    assert got.shape == (3, 24)
    np.testing.assert_array_equal(got, want)


def test_pretrained_entry_points_default_to_cuda(hubert_ckpt, clip_ckpt):
    """With no device named, the extractors run on the card: on a host
    without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    no_cuda = pytest.raises((AssertionError, RuntimeError), match="CUDA")
    with no_cuda:
        tpre.extract_hubert([np.zeros(4000, np.float32)], hubert_ckpt)
    with no_cuda:
        tpre.extract_clip_regions(np.zeros((32, 32, 3), np.uint8),
                                  np.asarray([[0.0, 0.0, 1.0, 1.0]]), clip_ckpt)
