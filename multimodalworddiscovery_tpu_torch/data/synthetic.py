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
