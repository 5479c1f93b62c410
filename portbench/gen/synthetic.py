"""Frozen copy of the port's synthetic caption generator, and the frame
synthesis made on the device.

``make_flickr8k_mini`` draws from ``default_rng(seed)`` in the order of
``multimodalworddiscovery_tpu_torch/data/synthetic.py`` (its lexicon, then
one utterance at a time), so with ``lexicon_seed=None`` and
``max_src_len=None`` it returns the port's arrays for a seed.  Two
additions keep the work of a cell the same from seed to seed:

- ``lexicon_seed`` draws the hidden lexicon (each concept's phone word, so
  the word lengths) from its own generator, fixed in the configuration;
  the captions still come from ``seed``.
- ``max_src_len`` pads every caption to one width and draws again any
  caption that would be longer, so every seed gives the same padded shape.
- ``filler_words``, ``min_words`` and ``max_words`` give a caption its
  words that name no concept of the image ("a", "is", "through the"): a
  filler vocabulary of ``filler_words`` phone words, drawn after the
  concepts' lexicon from the same generator, and a caption of
  ``min_words``-``max_words`` words in all, the image's concept words and
  fillers drawn from that vocabulary, in one shuffled order.  The fillers
  are the NULL state's, as the filler phones are.

``frames_on_device`` makes the stand-in acoustic frames of
``phones_to_frames`` (a random mean per phone id, 2-4 frames a phone token
around it, Gaussian noise) on the device from the seed, in a few large
calls, instead of the port's host loop over every frame.

numpy and torch only: nothing of the port or of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _sample_lexicon(rng, n_concepts, n_phones, min_word_len, max_word_len):
    lexicon = {}
    for c in range(1, n_concepts + 1):
        length = int(rng.integers(min_word_len, max_word_len + 1))
        lexicon[c] = (rng.integers(1, n_phones + 1, size=length)).tolist()
    return lexicon


def _sample_utterance(rng, lexicon, n_concepts, n_phones, min_concepts, max_concepts,
                      p_filler, fillers=None, min_words=0, max_words=0):
    k = int(rng.integers(min_concepts, max_concepts + 1))
    concepts = rng.choice(np.arange(1, n_concepts + 1), size=k, replace=False)
    trg = concepts.astype(np.int32)
    words = [lexicon[int(c)] for c in trg]
    if fillers:
        extra = max(int(rng.integers(min_words, max_words + 1)) - k, 0)
        words += [fillers[int(i)] for i in rng.integers(0, len(fillers), size=extra)]
    spoken_order = rng.permutation(len(words))
    phones = []
    for j in spoken_order:
        if rng.random() < p_filler:
            phones.append(int(rng.integers(1, n_phones + 1)))
        phones.extend(words[j])
    return np.asarray(phones, dtype=np.int32), trg


def make_flickr8k_mini(n_utterances=200, n_concepts=40, n_phones=48, min_word_len=2,
                       max_word_len=5, min_concepts=2, max_concepts=4, p_filler=0.15,
                       seed=0, lexicon_seed=None, max_src_len=None, filler_words=0,
                       min_words=0, max_words=0):
    """The paired phone corpus as padded host arrays: (src [N, Ts] int32,
    src_len [N] int32, trg [N, Tt] int32, trg_len [N] int32, src_vocab,
    trg_vocab).  Ts is ``max_src_len`` where given, else the longest
    caption; Tt is the most concepts any image has."""
    rng = np.random.default_rng(seed)
    lex_rng = rng if lexicon_seed is None else np.random.default_rng(lexicon_seed)
    lexicon = _sample_lexicon(lex_rng, n_concepts, n_phones, min_word_len, max_word_len)
    fillers = list(_sample_lexicon(lex_rng, filler_words, n_phones, min_word_len,
                                   max_word_len).values())
    src_seqs, trg_seqs = [], []
    for _ in range(n_utterances):
        while True:
            phones, trg = _sample_utterance(rng, lexicon, n_concepts, n_phones,
                                            min_concepts, max_concepts, p_filler, fillers,
                                            min_words, max_words)
            if max_src_len is None or len(phones) <= max_src_len:
                break
        src_seqs.append(phones)
        trg_seqs.append(trg)
    src, src_len = _pad(src_seqs, max_src_len)
    trg, trg_len = _pad(trg_seqs, None)
    return src, src_len, trg, trg_len, n_phones + 1, n_concepts + 1


def _pad(seqs, width):
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    t = int(width if width is not None else lengths.max())
    out = np.zeros((len(seqs), t), dtype=np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lengths


def frames_per_token(src_len, seed, min_frames=2, max_frames=4, max_len=None):
    """[N, Ts] int32 frames each phone token emits (0 past the caption),
    drawn from ``seed``; a caption whose frames would pass ``max_len`` draws
    its counts again."""
    rng = np.random.default_rng([seed, 1])
    n, ts = len(src_len), int(src_len.max())
    valid = np.arange(ts)[None, :] < src_len[:, None]
    nf = np.where(valid, rng.integers(min_frames, max_frames + 1, size=(n, ts)), 0)
    if max_len is not None:
        for i in np.flatnonzero(nf.sum(axis=1) > max_len):
            while nf[i].sum() > max_len:
                nf[i] = np.where(valid[i], rng.integers(min_frames, max_frames + 1, size=ts), 0)
    return nf.astype(np.int32)


def frames_on_device(src, nf, src_vocab, feat_dim, noise, seed, width, device):
    """Frames [N, width, D] float32 on ``device`` and their lengths [N]:
    phone id p has the mean ``means[p]`` (standard normal), and each token
    emits ``nf`` frames ``means[p] + noise * standard normal``; zeros past a
    caption's frames.  All draws come from one ``torch.Generator`` on
    ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    means = torch.randn((src_vocab, feat_dim), generator=gen, device=device)
    src_t = torch.as_tensor(src, device=device, dtype=torch.long)
    nf_t = torch.as_tensor(nf, device=device, dtype=torch.long)
    lengths = nf_t.sum(dim=1)
    # token index of every frame: the frame's position against each row's
    # running frame count
    ends = torch.cumsum(nf_t, dim=1)  # [N, Ts]
    pos = torch.arange(width, device=device)
    tok = torch.searchsorted(ends, pos.expand(src_t.shape[0], width).contiguous(), right=True)
    valid = pos[None, :] < lengths[:, None]
    tok = torch.clamp(tok, max=src_t.shape[1] - 1)
    phone = torch.gather(src_t, 1, tok)
    frames = means[phone] + noise * torch.randn(
        (src_t.shape[0], width, feat_dim), generator=gen, device=device)
    frames = torch.where(valid[..., None], frames, 0.0)
    return frames.contiguous(), lengths.to(torch.int32)
