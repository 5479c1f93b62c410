"""Port data layer vs the JAX reference: the synthetic generator gives
identical arrays and gold for the same seed, and the torch Corpus behaves
like the reference's (padding, masks)."""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.core import masking as jmasking
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu_torch.core import masking as tmasking
from multimodalworddiscovery_tpu_torch.data import Corpus
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make

SETTINGS = {
    "default": dict(n_utterances=40),
    "headline": dict(n_utterances=40, n_concepts=60, n_phones=48,
                     min_concepts=3, max_concepts=6),
}


@pytest.mark.parametrize("seed", [0, 3, 21])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_make_flickr8k_mini_identical_to_jax(seed, setting):
    kw = dict(SETTINGS[setting], seed=seed)
    jc, jg, jm = jax_make(**kw)
    tc, tg, tm = torch_make(**kw, device="cpu")
    for field in ("src", "src_len", "trg", "trg_len"):
        want = np.asarray(getattr(jc, field))
        got = getattr(tc, field).numpy()
        assert got.dtype == want.dtype == np.int32, field
        np.testing.assert_array_equal(got, want, err_msg=field)
    assert (tc.src_vocab, tc.trg_vocab) == (jc.src_vocab, jc.trg_vocab)
    np.testing.assert_array_equal(tg.alignment, jg.alignment)
    assert tg.segments == jg.segments
    assert tm.lexicon == jm.lexicon
    assert tm.phone_names == jm.phone_names
    assert tm.concept_names == jm.concept_names


def test_corpus_pad_to_and_masks_match_jax():
    jc, _, _ = jax_make(n_utterances=20, seed=5)
    tc, _, _ = torch_make(n_utterances=20, seed=5, device="cpu")
    jp, tp = jc.pad_to(24), tc.pad_to(24)
    assert tp.n == 24 and tp.max_src_len == jp.max_src_len
    for field in ("src", "src_len", "trg", "trg_len"):
        np.testing.assert_array_equal(
            getattr(tp, field).numpy(), np.asarray(getattr(jp, field))
        )
    np.testing.assert_array_equal(tp.src_mask().numpy(), np.asarray(jp.src_mask()))
    assert int(tp.src_len[-4:].sum()) == 0
    with pytest.raises(ValueError):
        tc.pad_to(10)


def test_corpus_to_and_from_ragged():
    src = [np.array([3, 1, 2]), np.array([4])]
    trg = [np.array([1, 2]), np.array([2])]
    c = Corpus.from_ragged(src, trg, src_vocab=5, trg_vocab=3, device="cpu")
    assert c.src.dtype == torch.int32 and c.src.shape == (2, 3)
    np.testing.assert_array_equal(c.src_len.numpy(), [3, 1])
    moved = c.to("cpu")
    assert moved.device.type == "cpu" and moved.src_vocab == 5
    with pytest.raises(ValueError, match="src ids"):
        Corpus.from_ragged([np.array([7])], trg[:1], src_vocab=5, trg_vocab=3, device="cpu")


def test_masking_helpers_match_jax():
    rng = np.random.default_rng(0)
    seqs = [rng.integers(0, 9, size=int(k)) for k in rng.integers(0, 7, size=12)]
    want, want_len = jmasking.pad_and_stack(seqs, max_len=5)
    got, got_len = tmasking.pad_and_stack(seqs, max_len=5)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)
    lens = np.array([0, 3, 5, 2], np.int32)
    np.testing.assert_array_equal(
        tmasking.lengths_to_mask(torch.as_tensor(lens), 5).numpy(),
        np.asarray(jmasking.lengths_to_mask(lens, 5)),
    )


def test_entry_points_default_to_cuda(tmp_path):
    """With no device named, the data and parameter entry points build on
    the card: on a host without CUDA they raise instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from multimodalworddiscovery_tpu_torch.data import phones_to_frames
    from multimodalworddiscovery_tpu_torch.frontend import vq
    from multimodalworddiscovery_tpu_torch.models import hmm, hmm_gaussian

    no_cuda = pytest.raises((AssertionError, RuntimeError), match="CUDA")
    with no_cuda:
        torch_make(n_utterances=2)
    with no_cuda:
        Corpus.from_ragged([np.array([3, 1])], [np.array([1])], src_vocab=5, trg_vocab=3)
    corpus, gold, _ = torch_make(n_utterances=2, device="cpu")
    with no_cuda:
        phones_to_frames(corpus, gold, feat_dim=4)
    with no_cuda:
        hmm.params_from_numpy(np.zeros((3, 2)), np.zeros(7), -1.0)
    with no_cuda:
        hmm_gaussian.params_from_numpy(*(np.zeros(s) for s in ((2, 1, 3), (2, 1, 3), (2, 1),
                                                                (7,), ())))
    np.save(tmp_path / "cb.npy", np.zeros((4, 3), np.float32))
    with no_cuda:
        vq.load_codebook(tmp_path / "cb.npy")
