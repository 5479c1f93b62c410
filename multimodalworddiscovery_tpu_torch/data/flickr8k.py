"""Flickr8k dataset builder.

Counterpart of ``multimodalworddiscovery_tpu/data/flickr8k.py``: turns
Flickr8k (with Flickr audio captions and Flickr30k-Entities-style concept
labels) into a paired (phone sequence, concept sequence) corpus with gold
alignments (SURVEY.md §2 C4), parsing the public dataset files from a local
directory:

  Flickr8k.token.txt       "<image>.jpg#<capid>\\t<caption words>"    (captions)
  lexicon.txt              "<word> <phone> <phone> ..."               (G2P dict)
  concepts.txt             "<image>.jpg <concept> <concept> ..."      (per-image
                           concept labels, e.g. from Flickr30k Entities heads)
  wav2capt.txt             "<wav> <image>.jpg #<capid>"               (Flickr
                           audio caption mapping, optional)

Output: a ``Corpus`` on ``device`` (and gold alignments derived from the
lexicon expansion: each caption word maps to a run of its phones; words
that match a concept of the image align to that concept, everything else to
NULL) and, via ``data.io.save_corpus``, the on-disk format.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations


def read_lexicon(path: str | Path) -> dict[str, list[str]]:
    lex: dict[str, list[str]] = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            lex[parts[0].lower()] = parts[1:]
    return lex


def read_captions(path: str | Path) -> dict[str, list[list[str]]]:
    """Flickr8k.token.txt -> {image_id: [caption tokens, ...]}."""
    caps: dict[str, list[list[str]]] = {}
    for line in Path(path).read_text().splitlines():
        if not line.strip():
            continue
        head, _, text = line.partition("\t")
        img = head.split("#")[0]
        toks = [t.strip(".,;!?\"'()").lower() for t in text.split()]
        caps.setdefault(img, []).append([t for t in toks if t])
    return caps


def read_concepts(path: str | Path) -> dict[str, list[str]]:
    """concepts.txt -> {image_id: [concept, ...]} (order preserved, deduped)."""
    out: dict[str, list[str]] = {}
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2:
            seen: list[str] = []
            for c in parts[1:]:
                if c not in seen:
                    seen.append(c)
            out[parts[0]] = seen
    return out


def build_corpus(
    captions_path: str | Path,
    lexicon_path: str | Path,
    concepts_path: str | Path,
    max_captions_per_image: int = 5,
    device="cuda",
) -> tuple[Corpus, GoldAnnotations, dict]:
    """Assemble the paired phone/concept corpus (on ``device``) with
    lexicon-derived gold.

    A caption word contributes its lexicon phones; if the word equals one of
    the image's concepts it is gold-aligned to that concept's position,
    otherwise to NULL.  OOV words map to NULL-aligned filler phones (their
    characters' phones if present, else skipped) — matching how the reference
    derives phone-level gold from entity annotations.
    """
    lex = read_lexicon(lexicon_path)
    caps = read_captions(captions_path)
    concepts = read_concepts(concepts_path)

    phone_vocab: dict[str, int] = {}
    concept_vocab: dict[str, int] = {}

    def phone_id(p: str) -> int:
        if p not in phone_vocab:
            phone_vocab[p] = len(phone_vocab) + 1
        return phone_vocab[p]

    def concept_id(c: str) -> int:
        if c not in concept_vocab:
            concept_vocab[c] = len(concept_vocab) + 1
        return concept_vocab[c]

    src_seqs, trg_seqs = [], []
    alignments, segments = [], []
    utt_ids = []

    for img in sorted(caps):
        if img not in concepts:
            continue
        img_concepts = concepts[img]
        trg = np.asarray([concept_id(c) for c in img_concepts], np.int32)
        for ci, toks in enumerate(caps[img][:max_captions_per_image]):
            phones: list[int] = []
            align: list[int] = []
            segs: list[tuple[int, int, int]] = []
            for w in toks:
                if w not in lex:
                    continue
                ph = [phone_id(p) for p in lex[w]]
                start = len(phones)
                phones.extend(ph)
                if w in img_concepts:
                    j = img_concepts.index(w)
                    align.extend([j + 1] * len(ph))
                    segs.append((start, len(phones), int(trg[j])))
                else:
                    align.extend([0] * len(ph))
            if not phones:
                continue
            src_seqs.append(np.asarray(phones, np.int32))
            trg_seqs.append(trg)
            alignments.append(np.asarray(align, np.int32))
            segments.append(segs)
            utt_ids.append(f"{img}#{ci}")

    corpus = Corpus.from_ragged(
        src_seqs,
        trg_seqs,
        src_vocab=len(phone_vocab) + 1,
        trg_vocab=len(concept_vocab) + 1,
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


def read_wav2capt(path: str | Path) -> list[tuple[str, str, int]]:
    """flickr_audio/wav2capt.txt -> [(wav, image_id, caption_index), ...]."""
    out = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 3:
            out.append((parts[0], parts[1], int(parts[2].lstrip("#"))))
    return out
