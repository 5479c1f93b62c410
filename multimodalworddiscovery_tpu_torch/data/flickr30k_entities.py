"""Flickr30k Entities dataset builder.

Counterpart of ``multimodalworddiscovery_tpu/data/flickr30k_entities.py``.
The gold phone-to-concept alignments come from Flickr30k Entities
annotations (SURVEY.md §2 C4): sentence files mark entity mentions inline,

    [/EN#40331/people A woman] looks at [/EN#40332/other a book]

and Annotations/*.xml carries the entity bounding boxes.  This parser turns
those public files into a paired corpus: concepts are the entity categories
(or mention head words), caption words expand to phones via a lexicon, and
words inside a mention align to that mention's concept.
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET
from pathlib import Path

import numpy as np

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.data.flickr8k import read_lexicon

_CHUNK = re.compile(r"\[/EN#(\d+)(?:/(\S+))?\s([^\]]*)\]")


def parse_sentence(line: str) -> tuple[list[str], list[tuple[int, int, str, str]]]:
    """Markup line -> (tokens, [(start, end_exclusive, entity_id, category)]).

    Token indices refer to the cleaned token sequence (markup stripped).
    """
    tokens: list[str] = []
    spans: list[tuple[int, int, str, str]] = []
    pos = 0
    for m in _CHUNK.finditer(line):
        before = line[pos : m.start()].split()
        tokens.extend(t.lower() for t in before)
        ent_id, category, phrase = m.group(1), m.group(2) or "other", m.group(3)
        words = [w.lower() for w in phrase.split()]
        start = len(tokens)
        tokens.extend(words)
        if words and ent_id != "0":  # EN#0 = non-visual
            spans.append((start, len(tokens), ent_id, category))
        pos = m.end()
    tokens.extend(t.lower() for t in line[pos:].split())
    tokens = [t.strip(".,;!?\"'()") for t in tokens]
    return [t for t in tokens if t], spans


def parse_boxes(xml_path: str | Path) -> dict[str, list[list[float]]]:
    """Annotations xml -> {entity_id: [[ymin, xmin, ymax, xmax] normalized]}."""
    root = ET.parse(str(xml_path)).getroot()
    size = root.find("size")
    h = float(size.find("height").text)
    w = float(size.find("width").text)
    out: dict[str, list[list[float]]] = {}
    for obj in root.findall("object"):
        names = [n.text for n in obj.findall("name")]
        box = obj.find("bndbox")
        if box is None:
            continue
        coords = [
            float(box.find("ymin").text) / h,
            float(box.find("xmin").text) / w,
            float(box.find("ymax").text) / h,
            float(box.find("xmax").text) / w,
        ]
        for name in names:
            out.setdefault(name, []).append(coords)
    return out


def build_corpus(
    sentences_dir: str | Path,
    lexicon_path: str | Path,
    concept_from: str = "category",
    max_captions_per_image: int = 5,
    device="cuda",
) -> tuple[Corpus, GoldAnnotations, dict]:
    """Sentences/<image>.txt files -> paired corpus (on ``device``) with
    entity-derived gold.

    concept_from: 'category' (people/animals/...) or 'head' (mention head
    word) — the two granularities the reference experiments with.
    """
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
    for f in sorted(Path(sentences_dir).glob("*.txt")):
        for ci, line in enumerate(f.read_text().splitlines()[:max_captions_per_image]):
            if not line.strip():
                continue
            tokens, spans = parse_sentence(line)
            if not spans:
                continue
            concepts: list[str] = []
            span_concept: list[int] = []  # 1-based trg position per span
            for s, e, ent, cat in spans:
                name = cat if concept_from == "category" else tokens[e - 1]
                if name not in concepts:
                    concepts.append(name)
                span_concept.append(concepts.index(name) + 1)
            trg = np.asarray([cid(c) for c in concepts], np.int32)

            phones: list[int] = []
            align: list[int] = []
            segs: list[tuple[int, int, int]] = []
            for ti, tok in enumerate(tokens):
                if tok not in lex:
                    continue
                ph = [pid(p) for p in lex[tok]]
                start = len(phones)
                phones.extend(ph)
                j = next(
                    (span_concept[k] for k, (s, e, _, _) in enumerate(spans) if s <= ti < e),
                    0,
                )
                align.extend([j] * len(ph))
                if j > 0:
                    # merge adjacent same-concept words into one unit later via
                    # run-length; record word-level spans here
                    segs.append((start, len(phones), int(trg[j - 1])))
            if not phones:
                continue
            # merge adjacent segments of the same concept (multiword mentions)
            merged: list[tuple[int, int, int]] = []
            for s_, e_, c_ in segs:
                if merged and merged[-1][2] == c_ and merged[-1][1] == s_:
                    merged[-1] = (merged[-1][0], e_, c_)
                else:
                    merged.append((s_, e_, c_))
            src_seqs.append(np.asarray(phones, np.int32))
            trg_seqs.append(trg)
            alignments.append(np.asarray(align, np.int32))
            segments.append(merged)
            utt_ids.append(f"{f.stem}#{ci}")

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
