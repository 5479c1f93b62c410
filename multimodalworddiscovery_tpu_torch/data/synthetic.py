"""Deterministic synthetic corpus with known gold alignments.

Counterpart of ``multimodalworddiscovery_tpu/data/synthetic.py``
(``make_flickr8k_mini`` and its batched form, ``phones_to_frames``, the
waveform renderers of config #4's pipeline, and the image side:
``make_boxes_mini``, ``concept_palette`` and ``images_for_corpus``).  The
generators are numpy and consume their ``default_rng(seed)`` in exactly
the reference's order, so the same seed and settings give identical arrays
and gold annotations:
each "image" is a bag of concepts, its spoken caption the concatenation of
the concepts' phone words in a shuffled order, with optional NULL-aligned
filler phones.

Entry points that build tensors put them on ``device``, "cuda" unless the
caller names another; there is no silent CPU default.
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
    device="cuda",
) -> tuple[Corpus, GoldAnnotations, SyntheticMeta]:
    """Build the synthetic paired corpus (tensors on ``device``).

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


def make_flickr8k_mini_batches(
    n_utterances: int,
    batch_size: int,
    n_concepts: int = 40,
    n_phones: int = 48,
    min_word_len: int = 2,
    max_word_len: int = 5,
    min_concepts: int = 2,
    max_concepts: int = 4,
    p_filler: float = 0.15,
    seed: int = 0,
    device="cuda",
):
    """Batched ``make_flickr8k_mini`` for corpora too large to materialize
    -> ``(meta, max_src_len, batches)``: ``batches`` yields ``(Corpus,
    GoldAnnotations)`` of ``batch_size`` rows (the last shorter) on
    ``device``, each padded to the global maxima (``max_concepts *
    (max_word_len + 1)`` phones, ``max_concepts`` concepts), as
    ``data.stream.ShardWriter`` needs.  One lexicon and one rng stream are
    shared across the batches, so the batches concatenated equal
    ``make_flickr8k_mini(n_utterances, ...)`` row for row (up to the
    padding width)."""
    rng = np.random.default_rng(seed)
    lexicon = _sample_lexicon(rng, n_concepts, n_phones, min_word_len, max_word_len)
    # each of <= max_concepts words is <= max_word_len phones plus one filler
    s_max = max_concepts * (max_word_len + 1)
    t_max = max_concepts

    def batches():
        done = 0
        while done < n_utterances:
            b = min(batch_size, n_utterances - done)
            draws = [_sample_utterance(rng, lexicon, n_concepts, n_phones, min_concepts,
                                       max_concepts, p_filler) for _ in range(b)]
            corpus = Corpus.from_ragged(
                [d[0] for d in draws], [d[1] for d in draws], src_vocab=n_phones + 1,
                trg_vocab=n_concepts + 1, max_src_len=s_max, max_trg_len=t_max,
                device=device,
            )
            gold_align = np.zeros((b, s_max), dtype=np.int32)
            for i, d in enumerate(draws):
                gold_align[i, : len(d[2])] = d[2]
            yield corpus, GoldAnnotations(alignment=gold_align,
                                          segments=[d[3] for d in draws])
            done += b

    return _meta(lexicon, n_concepts, n_phones), s_max, batches()


def phones_to_waveforms(
    corpus: Corpus,
    gold: GoldAnnotations,
    sample_rate: int = 16000,
    phone_ms: int = 80,
    noise: float = 0.02,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, GoldAnnotations]:
    """Render the phone corpus as raw audio for end-to-end pipeline runs.

    Each phone id gets a fixed mixture of 2 sinusoids (a crude formant
    pair); each phone token renders ``phone_ms`` of it under a Hann
    envelope, plus noise.  Draws in the reference's order, so the samples
    equal the reference's bit for bit.  Returns (wavs [N, L] float32,
    wav_lens [N] int32, the phone-level gold: frame-level gold comes after
    the frontend from ``expand_gold_to_frames``).
    """
    rng = np.random.default_rng(seed)
    v = corpus.src_vocab
    f1 = rng.uniform(200, 1200, size=v)
    f2 = rng.uniform(1400, 3800, size=v)
    spp = int(sample_rate * phone_ms / 1000)  # samples per phone

    src = corpus.src.cpu().numpy()
    src_len = corpus.src_len.cpu().numpy()
    max_len = int(src_len.max()) * spp
    wavs = np.zeros((corpus.n, max_len), np.float32)
    lens = np.zeros((corpus.n,), np.int32)
    t = np.arange(spp) / sample_rate
    env = np.hanning(spp)  # soften phone boundaries
    for i in range(corpus.n):
        pos = 0
        for k in range(int(src_len[i])):
            ph = int(src[i, k])
            seg = 0.4 * (np.sin(2 * np.pi * f1[ph] * t) + 0.6 * np.sin(2 * np.pi * f2[ph] * t))
            wavs[i, pos : pos + spp] = seg * env
            pos += spp
        wavs[i, :pos] += noise * rng.normal(size=pos)
        lens[i] = pos
    return wavs, lens, gold


def phone_templates(
    src_vocab: int, sample_rate: int = 16000, phone_ms: int = 80, seed: int = 0,
) -> np.ndarray:
    """[V, spp] per-phone-id waveform templates (Hann-enveloped formant
    pairs): the same formant draws as ``phones_to_waveforms`` (one
    ``default_rng(seed)`` consuming f1 then f2).  Row 0 (the padding id) is
    present and masked out by every consumer."""
    rng = np.random.default_rng(seed)
    f1 = rng.uniform(200, 1200, size=src_vocab)
    f2 = rng.uniform(1400, 3800, size=src_vocab)
    spp = int(sample_rate * phone_ms / 1000)
    t = np.arange(spp) / sample_rate
    env = np.hanning(spp)
    return (
        0.4 * (np.sin(2 * np.pi * f1[:, None] * t)
               + 0.6 * np.sin(2 * np.pi * f2[:, None] * t)) * env
    ).astype(np.float32)


def phones_to_waveforms_batched(
    corpus: Corpus,
    sample_rate: int = 16000,
    phone_ms: int = 80,
    noise: float = 0.02,
    seed: int = 0,
    pad_phones: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized ``phones_to_waveforms``: each phone id's waveform is a
    template and a whole batch assembles as one fancy index and reshape.
    Equal to the reference's batched renderer at every setting, and to
    the scalar renderer at ``noise=0``; with noise the draw order differs.

    ``pad_phones`` fixes the output width to ``pad_phones * spp`` samples
    whatever the batch's longest utterance.  Returns (wavs [N, L],
    wav_lens [N]).
    """
    rng = np.random.default_rng(seed)
    # consume f1 / f2 as phone_templates does, so the noise draws below start
    # at the reference's stream position
    templates = phone_templates(corpus.src_vocab, sample_rate, phone_ms, seed)
    spp = int(sample_rate * phone_ms / 1000)
    rng.uniform(200, 1200, size=corpus.src_vocab)
    rng.uniform(1400, 3800, size=corpus.src_vocab)

    src = corpus.src.cpu().numpy()
    src_len = corpus.src_len.cpu().numpy()
    n, s = src.shape
    s_out = int(pad_phones) if pad_phones is not None else int(src_len.max())
    if s_out < s:
        src = src[:, :s_out]
    elif s_out > s:
        src = np.pad(src, ((0, 0), (0, s_out - s)))
    wavs = templates[src].reshape(n, s_out * spp)
    lens = (src_len * spp).astype(np.int32)
    valid = np.arange(s_out * spp)[None, :] < lens[:, None]
    wavs = np.where(valid, wavs, np.float32(0.0))
    if noise:
        wavs += np.float32(noise) * rng.standard_normal(
            wavs.shape, dtype=np.float32
        ) * valid
    return wavs, lens


def expand_gold_to_frames(
    gold: GoldAnnotations,
    src_len: np.ndarray,
    frame_lens: np.ndarray,
    phone_ms: int = 80,
    hop_ms: int = 10,
) -> GoldAnnotations:
    """Phone-level gold -> frame-level gold after the MFCC frontend.

    Frame t (hop h ms) overlaps phone k = floor(t*h / phone_ms) (window-start
    convention).
    """
    n, _ = gold.alignment.shape
    max_f = int(frame_lens.max())
    frames_per_phone = phone_ms // hop_ms
    alignment = np.zeros((n, max_f), np.int32)
    segments: list[list[tuple[int, int, int]]] = []
    for i in range(n):
        fl = int(frame_lens[i])
        ph_idx = np.minimum(np.arange(fl) // frames_per_phone, int(src_len[i]) - 1)
        alignment[i, :fl] = gold.alignment[i, ph_idx]
        segs = [
            (
                int(s * frames_per_phone),
                int(min(e * frames_per_phone, fl)),
                c,
            )
            for (s, e, c) in gold.segments[i]
            if s * frames_per_phone < fl
        ]
        segments.append(segs)
    return GoldAnnotations(alignment=alignment, segments=segments)


def phones_to_frames(
    corpus: Corpus,
    gold: GoldAnnotations,
    feat_dim: int = 16,
    min_frames: int = 2,
    max_frames: int = 4,
    noise: float = 0.15,
    seed: int = 0,
    device="cuda",
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


def make_boxes_mini(
    n_images: int = 64,
    image_size: int = 64,
    max_boxes: int = 3,
    min_frac: float = 0.2,
    max_frac: float = 0.45,
    noise: float = 0.1,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Deterministic synthetic detection set for the learned region-proposal
    path (frontend/detector.py; SURVEY.md §2 C3 "and/or an RCNN detector").

    Each image is a noisy background with 1..max_boxes solid colored
    rectangles ("objects"); the gold boxes are the rectangles.  Returns
    (images [N, H, W, 3] float32 in [0, 1],
     boxes  [N, G, 4] normalized (y1, x1, y2, x2) padded with zeros,
     mask   [N, G] bool).
    """
    rng = np.random.default_rng(seed)
    h = w = image_size
    images = np.clip(
        0.35 + noise * rng.normal(size=(n_images, h, w, 3)), 0.0, 1.0
    ).astype(np.float32)
    boxes = np.zeros((n_images, max_boxes, 4), np.float32)
    mask = np.zeros((n_images, max_boxes), bool)
    for i in range(n_images):
        g = int(rng.integers(1, max_boxes + 1))
        placed: list[tuple[float, float, float, float]] = []
        for b in range(g):
            for _ in range(20):  # rejection-sample low-overlap placements
                bh = rng.uniform(min_frac, max_frac)
                bw = rng.uniform(min_frac, max_frac)
                y1 = rng.uniform(0.0, 1.0 - bh)
                x1 = rng.uniform(0.0, 1.0 - bw)
                cand = (y1, x1, y1 + bh, x1 + bw)
                if all(
                    min(cand[2], p[2]) - max(cand[0], p[0]) < 0.05
                    or min(cand[3], p[3]) - max(cand[1], p[1]) < 0.05
                    for p in placed
                ):
                    break
            placed.append(cand)
            boxes[i, b] = cand
            mask[i, b] = True
            color = rng.uniform(0.6, 1.0, size=3) * (
                rng.integers(0, 2, size=3) * 2 - 1
            ) * 0.5 + 0.5
            ys, ye = int(cand[0] * h), max(int(cand[2] * h), int(cand[0] * h) + 2)
            xs, xe = int(cand[1] * w), max(int(cand[3] * w), int(cand[1] * w) + 2)
            images[i, ys:ye, xs:xe] = color.astype(np.float32)
    return images, boxes, mask


def concept_palette(n_concepts: int, seed: int = 0) -> np.ndarray:
    """Deterministic distinct RGB color per concept id (1..n_concepts).

    Hue wheel + two lightness rings so up to ~40 concepts stay separable;
    index 0 (padding/NULL) is black.  Returns [n_concepts + 1, 3] float32."""
    out = np.zeros((n_concepts + 1, 3), np.float32)
    rng = np.random.default_rng(seed)
    order = rng.permutation(n_concepts)
    for i, c in enumerate(order):
        hue = i / n_concepts
        val = 0.95 if i % 2 == 0 else 0.6
        h6 = hue * 6.0
        k = np.array([(5 + h6) % 6, (3 + h6) % 6, (1 + h6) % 6])
        out[c + 1] = val * (1 - 0.85 * np.clip(np.minimum(k, 4 - k), 0, 1))
    return out


def images_for_corpus(
    corpus: Corpus,
    image_size: int = 64,
    min_frac: float = 0.22,
    max_frac: float = 0.4,
    noise: float = 0.08,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Render IMAGES for a paired phone corpus — the image-side analogue of
    ``phones_to_waveforms``: each utterance's "image" contains one colored
    rectangle per target concept (color = ``concept_palette`` entry), so the
    full image pipeline (detector -> region crops -> embeddings -> aligner)
    can run end-to-end with exact gold (SURVEY.md §3.4 image branch).

    Returns (images [N, H, W, 3] float32 in [0, 1],
             boxes  [N, Tt, 4] normalized (y1, x1, y2, x2),
             mask   [N, Tt] bool — True for real concepts,
             pos    [N, Tt] int32 — 1-based trg position of each box, 0 pad).
    Box order is SHUFFLED per image (spatial order carries no alignment
    information, as in real region annotations).
    """
    rng = np.random.default_rng(seed)
    n, g = corpus.trg.shape[:2]
    trg = corpus.trg.cpu().numpy()
    trg_len = corpus.trg_len.cpu().numpy()
    n_concepts = corpus.trg_vocab - 1
    palette = concept_palette(n_concepts, seed=seed)
    h = w = image_size
    images = np.clip(
        0.3 + noise * rng.normal(size=(n, h, w, 3)), 0.0, 1.0
    ).astype(np.float32)
    boxes = np.zeros((n, g, 4), np.float32)
    mask = np.zeros((n, g), bool)
    pos = np.zeros((n, g), np.int32)
    for i in range(n):
        k = int(trg_len[i])
        order = rng.permutation(k)
        placed: list[tuple[float, float, float, float]] = []
        for slot, j in enumerate(order):
            for _ in range(30):  # rejection-sample low-overlap placements
                bh = rng.uniform(min_frac, max_frac)
                bw = rng.uniform(min_frac, max_frac)
                y1 = rng.uniform(0.0, 1.0 - bh)
                x1 = rng.uniform(0.0, 1.0 - bw)
                cand = (y1, x1, y1 + bh, x1 + bw)
                if all(
                    min(cand[2], p[2]) - max(cand[0], p[0]) < 0.03
                    or min(cand[3], p[3]) - max(cand[1], p[1]) < 0.03
                    for p in placed
                ):
                    break
            placed.append(cand)
            boxes[i, slot] = cand
            mask[i, slot] = True
            pos[i, slot] = j + 1
            ys, ye = int(cand[0] * h), max(int(cand[2] * h), int(cand[0] * h) + 2)
            xs, xe = int(cand[1] * w), max(int(cand[3] * w), int(cand[1] * w) + 2)
            images[i, ys:ye, xs:xe] = palette[int(trg[i, j])]
    return images, boxes, mask, pos
