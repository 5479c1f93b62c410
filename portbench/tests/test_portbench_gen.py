"""The generator copies give the port's generators' arrays for a seed, and
the frames made on the device follow ``phones_to_frames``' construction."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.gen.synthetic import frames_on_device, frames_per_token, make_flickr8k_mini


@pytest.mark.parametrize("kw", [
    dict(n_utterances=300, n_concepts=60, n_phones=48, min_concepts=3, max_concepts=6, seed=0),
    dict(n_utterances=50, n_concepts=400, n_phones=48, min_concepts=48, max_concepts=64,
         min_word_len=2, max_word_len=3, seed=2),
    dict(n_utterances=40, n_concepts=200, n_phones=48, min_concepts=16, max_concepts=32,
         seed=2147483700),
])
def test_caption_copy_equals_the_port(kw):
    from multimodalworddiscovery_tpu_torch.data.synthetic import make_flickr8k_mini as port

    corpus, _, _ = port(**kw, device="cpu")
    src, src_len, trg, trg_len, v_src, v_trg = make_flickr8k_mini(**kw)
    assert np.array_equal(src, corpus.src.numpy())
    assert np.array_equal(src_len, corpus.src_len.numpy())
    assert np.array_equal(trg, corpus.trg.numpy())
    assert np.array_equal(trg_len, corpus.trg_len.numpy())
    assert (v_src, v_trg) == (corpus.src_vocab, corpus.trg_vocab)


def test_fixed_lexicon_and_width_keep_the_shapes():
    kw = dict(n_utterances=500, n_concepts=60, n_phones=48, min_concepts=3, max_concepts=6,
              lexicon_seed=0, max_src_len=24)
    a = make_flickr8k_mini(**kw, seed=1)
    b = make_flickr8k_mini(**kw, seed=2)
    assert a[0].shape == b[0].shape == (500, 24)
    assert a[1].max() <= 24 and b[1].max() <= 24
    assert not np.array_equal(a[0], b[0])
    # one lexicon: a single-concept caption without filler is that concept's
    # word whatever the seed
    one = dict(kw, min_concepts=1, max_concepts=1, p_filler=0.0, n_concepts=1)
    assert np.array_equal(make_flickr8k_mini(**one, seed=5)[0],
                          make_flickr8k_mini(**one, seed=6)[0])


def test_frames_follow_phones_to_frames():
    src, src_len, *_ = make_flickr8k_mini(30, n_concepts=10, min_concepts=2, max_concepts=4,
                                          seed=4)
    nf = frames_per_token(src_len, 4, max_len=40)
    assert nf.sum(axis=1).max() <= 40
    assert set(np.unique(nf[nf > 0])) <= {2, 3, 4}
    x, x_len = frames_on_device(src, nf, 49, 6, 0.0, 4, 40, "cpu")
    gen = torch.Generator().manual_seed(4)
    means = torch.randn((49, 6), generator=gen)
    for i in range(30):
        rows = np.repeat(src[i, : src_len[i]], nf[i, : src_len[i]])
        assert int(x_len[i]) == len(rows)
        assert torch.equal(x[i, : len(rows)], means[torch.as_tensor(rows).long()])
        assert not x[i, len(rows):].any()
    noisy, _ = frames_on_device(src, nf, 49, 6, 0.15, 4, 40, "cpu")
    resid = (noisy - x)[x_len[:, None] > torch.arange(40)]
    assert 0.12 < float(resid.std()) < 0.18


def test_filler_words_give_flickr8k_caption_lengths():
    from portbench.tests.common import BENCHMARK
    from portbench import spec

    params = dict(spec.load_cell("hmm_flickr8k.em", BENCHMARK).config["corpus"],
                  n_utterances=2000)
    src, src_len, trg, trg_len, *_ = make_flickr8k_mini(**params, seed=2147483700)
    assert src.shape == (2000, params["max_src_len"])
    assert 35 <= src_len.mean() <= 45 and src_len.max() <= params["max_src_len"]
    assert set(np.unique(trg_len)) == set(range(3, 7))
    # without fillers a caption is its concepts' words alone, under 20
    # phones on average: the fillers add words, not concepts
    bare = make_flickr8k_mini(**dict(params, filler_words=0), seed=2147483700)
    assert bare[1].mean() < 20 and set(np.unique(bare[3])) == set(range(3, 7))


def test_a_traffic_mix_sets_the_scale_only():
    from portbench import gen

    config = {"corpus": {"n_utterances": 10, "max_src_len": 72}}
    assert gen.corpus_params(config, {"corpus": {"n_utterances": 5}})["n_utterances"] == 5
    with pytest.raises(ValueError, match="max_src_len"):
        gen.corpus_params(config, {"corpus": {"max_src_len": 184}})
