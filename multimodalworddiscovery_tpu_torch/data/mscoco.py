"""MSCOCO / SpeechCOCO dataset builder.

Counterpart of ``multimodalworddiscovery_tpu/data/mscoco.py`` (SURVEY.md §2
C4): object-instance categories become the image's concept sequence;
captions (text for MSCOCO, spoken for SpeechCOCO) become the source side.

Parses the public annotation formats from a local directory:
  instances_*.json     COCO detection annotations: images / annotations /
                       categories (concepts per image from its instances)
  captions_*.json      COCO caption annotations
  speechcoco manifest  "<wav_path>\\t<image_id>\\t<caption text>" TSV, one
                       spoken caption per line (SpeechCOCO's wav inventory)

Text captions expand to phones via a lexicon exactly like the Flickr8k
builder; SpeechCOCO waveforms go through an MFCC function into a continuous
corpus (``ops.mfcc.extract``: K5 on the card).
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.flickr8k import read_lexicon


def read_instances(path: str | Path) -> tuple[dict[int, list[str]], dict[int, str]]:
    """instances json -> ({image_id: [category names]}, {cat_id: name})."""
    d = json.loads(Path(path).read_text())
    cats = {c["id"]: c["name"] for c in d["categories"]}
    per_image: dict[int, list[str]] = {}
    for ann in d["annotations"]:
        name = cats[ann["category_id"]]
        lst = per_image.setdefault(ann["image_id"], [])
        if name not in lst:
            lst.append(name)
    return per_image, cats


def read_coco_captions(path: str | Path) -> dict[int, list[str]]:
    d = json.loads(Path(path).read_text())
    out: dict[int, list[str]] = {}
    for ann in d["annotations"]:
        out.setdefault(ann["image_id"], []).append(ann["caption"])
    return out


def build_corpus(
    instances_path: str | Path,
    captions_path: str | Path,
    lexicon_path: str | Path,
    max_captions_per_image: int = 5,
    device="cuda",
) -> tuple[Corpus, GoldAnnotations, dict]:
    """Text-caption MSCOCO corpus (phones vs instance-category concepts) on
    ``device``."""
    per_image, _ = read_instances(instances_path)
    caps = read_coco_captions(captions_path)
    lex = read_lexicon(lexicon_path)

    phone_vocab: dict[str, int] = {}
    concept_vocab: dict[str, int] = {}

    def pid(p):
        if p not in phone_vocab:
            phone_vocab[p] = len(phone_vocab) + 1
        return phone_vocab[p]

    def cid(c):
        if c not in concept_vocab:
            concept_vocab[c] = len(concept_vocab) + 1
        return concept_vocab[c]

    src_seqs, trg_seqs, alignments, segments, utt_ids = [], [], [], [], []
    for img_id in sorted(per_image):
        img_concepts = per_image[img_id]
        if img_id not in caps or not img_concepts:
            continue
        trg = np.asarray([cid(c) for c in img_concepts], np.int32)
        for ci, caption in enumerate(caps[img_id][:max_captions_per_image]):
            toks = [t.strip(".,;!?\"'()").lower() for t in caption.split()]
            phones, align = [], []
            segs: list[tuple[int, int, int]] = []
            for w in toks:
                if w not in lex:
                    continue
                ph = [pid(p) for p in lex[w]]
                start = len(phones)
                phones.extend(ph)
                # multiword categories ("traffic light") match on head word
                match = next(
                    (j for j, c in enumerate(img_concepts) if w == c or w == c.split()[-1]),
                    None,
                )
                if match is not None:
                    align.extend([match + 1] * len(ph))
                    segs.append((start, len(phones), int(trg[match])))
                else:
                    align.extend([0] * len(ph))
            if not phones:
                continue
            src_seqs.append(np.asarray(phones, np.int32))
            trg_seqs.append(trg)
            alignments.append(np.asarray(align, np.int32))
            segments.append(segs)
            utt_ids.append(f"{img_id}#{ci}")

    corpus = Corpus.from_ragged(
        src_seqs, trg_seqs,
        src_vocab=len(phone_vocab) + 1, trg_vocab=len(concept_vocab) + 1,
        device=device,
    )
    gold_align = np.zeros((corpus.n, corpus.max_src_len), np.int32)
    for i, a in enumerate(alignments):
        gold_align[i, : len(a)] = a
    gold = GoldAnnotations(alignment=gold_align, segments=segments)
    meta = {
        "phone_vocab": phone_vocab,
        "concept_vocab": concept_vocab,
        "utterance_ids": utt_ids,
    }
    return corpus, gold, meta


def read_speechcoco_manifest(path: str | Path) -> list[tuple[str, int, str]]:
    """TSV manifest -> [(wav_path, image_id, caption text), ...]."""
    out = []
    for line in Path(path).read_text().splitlines():
        parts = line.split("\t")
        if len(parts) >= 3:
            out.append((parts[0], int(parts[1]), parts[2]))
    return out


def build_speech_corpus(
    manifest_path: str | Path,
    instances_path: str | Path,
    wav_loader,
    mfcc_fn,
    device="cuda",
) -> tuple[Corpus, dict]:
    """SpeechCOCO continuous corpus on ``device``: wavs -> MFCC frames vs
    concepts.

    wav_loader: path -> float32 [L] waveform (injected: no audio codec
    dependency).  mfcc_fn: ([N, L] padded wavs, [N] lengths) tensors on
    ``device`` -> ([N, F, D] features, [N] frame lengths), e.g.
    ``ops.mfcc.extract`` (K5 on the card) or ``frontend.speech.extract``.
    """
    per_image, _ = read_instances(instances_path)
    entries = read_speechcoco_manifest(manifest_path)

    concept_vocab: dict[str, int] = {}

    def cid(c):
        if c not in concept_vocab:
            concept_vocab[c] = len(concept_vocab) + 1
        return concept_vocab[c]

    wavs, trg_seqs, utt_ids = [], [], []
    for wav_path, img_id, _text in entries:
        if img_id not in per_image or not per_image[img_id]:
            continue
        wavs.append(np.asarray(wav_loader(wav_path), np.float32))
        trg_seqs.append(np.asarray([cid(c) for c in per_image[img_id]], np.int32))
        utt_ids.append(wav_path)

    max_len = max(len(w) for w in wavs)
    padded = np.zeros((len(wavs), max_len), np.float32)
    lens = np.zeros((len(wavs),), np.int32)
    for i, w in enumerate(wavs):
        padded[i, : len(w)] = w
        lens[i] = len(w)
    feats, frame_lens = mfcc_fn(torch.as_tensor(padded, device=device),
                                torch.as_tensor(lens, device=device))

    feats = feats.cpu().numpy()
    frame_lens = frame_lens.cpu().numpy()
    src_seqs = [feats[i, : frame_lens[i]] for i in range(len(wavs))]
    corpus = Corpus.from_ragged(
        src_seqs, trg_seqs, src_vocab=0, trg_vocab=len(concept_vocab) + 1, device=device
    )
    return corpus, {"concept_vocab": concept_vocab, "utterance_ids": utt_ids}
