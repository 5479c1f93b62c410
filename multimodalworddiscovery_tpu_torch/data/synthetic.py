"""Deterministic synthetic corpus with known gold alignments.

Counterpart of ``multimodalworddiscovery_tpu/data/synthetic.py``
(``make_flickr8k_mini`` only).  The generator is numpy and consumes its
``default_rng(seed)`` in exactly the reference's order, so the same seed and
settings give identical arrays and gold annotations: each "image" is a bag
of concepts, its spoken caption the concatenation of the concepts' phone
words in a shuffled order, with optional NULL-aligned filler phones.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations


@dataclasses.dataclass
class SyntheticMeta:
    """Generator side-information (the hidden truth EM should recover)."""

    lexicon: dict[int, list[int]]  # concept id -> phone-id word
    n_concepts: int
    n_phones: int
    concept_names: list[str]
    phone_names: list[str]


def _sample_lexicon(
    rng: np.random.Generator, n_concepts: int, n_phones: int,
    min_word_len: int, max_word_len: int,
) -> dict[int, list[int]]:
    """Hidden lexicon: concept -> word (sequence of phone ids)."""
    lexicon: dict[int, list[int]] = {}
    for c in range(1, n_concepts + 1):
        length = int(rng.integers(min_word_len, max_word_len + 1))
        lexicon[c] = (rng.integers(1, n_phones + 1, size=length)).tolist()
    return lexicon


def _sample_utterance(
    rng: np.random.Generator, lexicon: dict[int, list[int]], n_concepts: int,
    n_phones: int, min_concepts: int, max_concepts: int, p_filler: float,
):
    """One (phones, concepts, alignment, segments) draw."""
    k = int(rng.integers(min_concepts, max_concepts + 1))
    concepts = rng.choice(np.arange(1, n_concepts + 1), size=k, replace=False)
    trg = concepts.astype(np.int32)
    spoken_order = rng.permutation(k)

    phones: list[int] = []
    align: list[int] = []
    segs: list[tuple[int, int, int]] = []
    for j in spoken_order:
        # optional NULL-aligned filler phone before the word
        if rng.random() < p_filler:
            phones.append(int(rng.integers(1, n_phones + 1)))
            align.append(0)
        word = lexicon[int(trg[j])]
        start = len(phones)
        phones.extend(word)
        align.extend([int(j) + 1] * len(word))  # 1-based trg position
        segs.append((start, len(phones), int(trg[j])))
    return (
        np.asarray(phones, dtype=np.int32), trg,
        np.asarray(align, dtype=np.int32), segs,
    )


def _meta(lexicon, n_concepts: int, n_phones: int) -> SyntheticMeta:
    return SyntheticMeta(
        lexicon=lexicon,
        n_concepts=n_concepts,
        n_phones=n_phones,
        concept_names=[f"concept_{c}" for c in range(n_concepts + 1)],
        phone_names=[f"ph{p}" for p in range(n_phones + 1)],
    )


def make_flickr8k_mini(
    n_utterances: int = 200,
    n_concepts: int = 40,
    n_phones: int = 48,
    min_word_len: int = 2,
    max_word_len: int = 5,
    min_concepts: int = 2,
    max_concepts: int = 4,
    p_filler: float = 0.15,
    seed: int = 0,
    device=None,
) -> tuple[Corpus, GoldAnnotations, SyntheticMeta]:
    """Build the synthetic paired corpus (tensors on ``device``, default CPU).

    Phone id 0 is reserved as padding; real phones are 1..n_phones.
    Concept id 0 is reserved as padding/NULL; real concepts are 1..n_concepts.
    """
    rng = np.random.default_rng(seed)
    lexicon = _sample_lexicon(rng, n_concepts, n_phones, min_word_len, max_word_len)

    src_seqs, trg_seqs = [], []
    alignments: list[np.ndarray] = []
    segments: list[list[tuple[int, int, int]]] = []
    for _ in range(n_utterances):
        phones, trg, align, segs = _sample_utterance(
            rng, lexicon, n_concepts, n_phones, min_concepts, max_concepts,
            p_filler,
        )
        src_seqs.append(phones)
        trg_seqs.append(trg)
        alignments.append(align)
        segments.append(segs)

    corpus = Corpus.from_ragged(
        src_seqs, trg_seqs, src_vocab=n_phones + 1, trg_vocab=n_concepts + 1,
        device=device,
    )
    gold_align = np.zeros((n_utterances, corpus.max_src_len), dtype=np.int32)
    for i, a in enumerate(alignments):
        gold_align[i, : len(a)] = a
    gold = GoldAnnotations(alignment=gold_align, segments=segments)
    return corpus, gold, _meta(lexicon, n_concepts, n_phones)


def phones_to_frames(
    corpus: Corpus,
    gold: GoldAnnotations,
    feat_dim: int = 16,
    min_frames: int = 2,
    max_frames: int = 4,
    noise: float = 0.15,
    seed: int = 0,
    device=None,
) -> tuple[Corpus, GoldAnnotations, np.ndarray]:
    """Expand a discrete phone corpus into continuous acoustic frames.

    Each phone id gets a random mean vector; each phone token emits 2-4
    noisy frames around it, a stand-in for MFCC frames.  Draws from
    ``default_rng(seed)`` in the reference's order, so frames, frame gold
    and phone means equal the reference's bit for bit.

    Returns (frame corpus on ``device``, frame-level gold, phone means [V, D]).
    """
    rng = np.random.default_rng(seed)
    means = rng.normal(size=(corpus.src_vocab, feat_dim)).astype(np.float32)

    src = corpus.src.cpu().numpy()
    src_len = corpus.src_len.cpu().numpy()
    trg = corpus.trg.cpu().numpy()
    trg_len = corpus.trg_len.cpu().numpy()
    frame_seqs, frame_aligns, frame_segments = [], [], []
    for i in range(corpus.n):
        frames, falign = [], []
        fsegs: list[tuple[int, int, int]] = []
        starts = {s: c for (s, e, c) in gold.segments[i]}
        # the reference scans every gold segment at each phone and closes the
        # open one at the first (in segment order) that ends at this phone
        # with the open concept; index the ends once instead
        ends: dict[int, list[int]] = {}
        for s, (e, c) in {s: (e, c) for (s, e, c) in gold.segments[i]}.items():
            ends.setdefault(e - 1, []).append(c)
        open_start: int | None = None
        open_concept = 0
        for t in range(int(src_len[i])):
            if t in starts:
                open_start = len(frames)
                open_concept = starts[t]
            ph = int(src[i, t])
            nf = int(rng.integers(min_frames, max_frames + 1))
            for _ in range(nf):
                frames.append(means[ph] + noise * rng.normal(size=feat_dim))
                falign.append(int(gold.alignment[i, t]))
            if open_start is not None and open_concept in ends.get(t, ()):
                fsegs.append((open_start, len(frames), open_concept))
                open_start = None
        frame_seqs.append(np.asarray(frames, dtype=np.float32))
        frame_aligns.append(np.asarray(falign, dtype=np.int32))
        frame_segments.append(fsegs)

    trg_ragged = [trg[i, : int(trg_len[i])] for i in range(corpus.n)]
    frame_corpus = Corpus.from_ragged(
        frame_seqs, trg_ragged, src_vocab=0, trg_vocab=corpus.trg_vocab,
        device=device,
    )
    gold_align = np.zeros((corpus.n, frame_corpus.max_src_len), dtype=np.int32)
    for i, a in enumerate(frame_aligns):
        gold_align[i, : len(a)] = a
    frame_gold = GoldAnnotations(alignment=gold_align, segments=frame_segments)
    return frame_corpus, frame_gold, means
