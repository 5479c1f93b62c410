"""On-disk corpus format: load and save.

Counterpart of ``multimodalworddiscovery_tpu/data/io.py``; the files are
the same, so either package reads what the other wrote:

  <name>_src.txt         one utterance per line, space-separated tokens
                         (phone symbols or integer ids)
  <name>_trg.txt         one line of concepts per utterance
  <name>_src_feats.npz   OR continuous features, keys "arr_<i>" ([T_i, D])
  <name>_trg_feats.npz   (likewise for region embeddings)
  <name>_gold.json       [{"index": i, "alignment": [...1-based trg pos, 0=NULL],
                           "segments": [[start, end_exclusive, concept_id], ...]}]

Alignment dumps use the same JSON shape.  Integer token files go through
the port's own packer (``native.pack_token_file``).
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import numpy as np

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus, GoldAnnotations
from multimodalworddiscovery_tpu_torch.native import pack_token_file


def _read_token_lines(path: Path) -> tuple[list[np.ndarray], dict[str, int]]:
    """Whitespace-tokenized lines; integer tokens are used as they are,
    symbolic tokens get ids 1..V in sorted order (0 = pad)."""
    lines = [ln.split() for ln in path.read_text().splitlines() if ln.strip()]
    flat = {tok for ln in lines for tok in ln}
    if all(tok.lstrip("-").isdigit() for tok in flat):
        vocab: dict[str, int] = {}
        seqs = [np.asarray([int(t) for t in ln], dtype=np.int32) for ln in lines]
    else:
        vocab = {tok: i + 1 for i, tok in enumerate(sorted(flat))}
        seqs = [np.asarray([vocab[t] for t in ln], dtype=np.int32) for ln in lines]
    return seqs, vocab


def _load_int_tokens_fast(path: Path):
    """One-pass parse of an all-integer token file -> (seqs, vocab size);
    None if the file holds a sign or a symbolic token (those take the
    vocabulary-building path: the packer treats '-' as a separator)."""
    text = path.read_text()
    if "-" in text or re.search(r"[^0-9\s]", text) is not None:
        return None
    arr, lens, vocab_max = pack_token_file(path)
    return [arr[i, : lens[i]] for i in range(arr.shape[0])], vocab_max + 1


def _load_side(d: Path, name: str, side: str):
    """(sequences, vocab size) of one side: the .npz features if present,
    else the token file."""
    npz, txt = d / f"{name}_{side}_feats.npz", d / f"{name}_{side}.txt"
    if npz.exists():
        with np.load(npz) as z:
            return [z[k] for k in sorted(z.files, key=lambda k: int(k.split("_")[-1]))], 0
    if not txt.exists():
        raise FileNotFoundError(f"no {name}_{side}.txt or {name}_{side}_feats.npz in {d}")
    fast = _load_int_tokens_fast(txt)
    if fast is not None:
        return fast
    seqs, _ = _read_token_lines(txt)
    return seqs, max((int(s.max()) for s in seqs if len(s)), default=0) + 1


def load_corpus(
    directory: str | Path, name: str, device="cuda"
) -> tuple[Corpus, GoldAnnotations | None]:
    """Load a corpus onto ``device`` (and its gold annotations if present)."""
    d = Path(directory)
    src_seqs, src_vocab = _load_side(d, name, "src")
    trg_seqs, trg_vocab = _load_side(d, name, "trg")
    corpus = Corpus.from_ragged(src_seqs, trg_seqs, src_vocab=src_vocab,
                                trg_vocab=trg_vocab, device=device)
    gold = None
    gold_path = d / f"{name}_gold.json"
    if gold_path.exists():
        gold = load_alignment_json(gold_path, corpus.n, corpus.max_src_len)
    return corpus, gold


def save_corpus(
    corpus: Corpus, gold: GoldAnnotations | None, directory: str | Path, name: str
) -> None:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    src, trg = corpus.src.cpu().numpy(), corpus.trg.cpu().numpy()
    src_len, trg_len = corpus.src_len.cpu().numpy(), corpus.trg_len.cpu().numpy()
    for side, x, lens in (("src", src, src_len), ("trg", trg, trg_len)):
        if x.ndim == 2:  # discrete tokens
            lines = [" ".join(str(int(v)) for v in x[i, : lens[i]]) for i in range(corpus.n)]
            (d / f"{name}_{side}.txt").write_text("\n".join(lines) + "\n")
        else:
            np.savez(d / f"{name}_{side}_feats.npz",
                     **{f"arr_{i}": x[i, : lens[i]] for i in range(corpus.n)})
    if gold is not None:
        save_alignment_json(gold.alignment, src_len, d / f"{name}_gold.json",
                            segments=gold.segments)


def save_alignment_json(
    alignment: np.ndarray,
    src_len: np.ndarray,
    path: str | Path,
    segments: list[list[tuple[int, int, int]]] | None = None,
) -> None:
    """Dump alignments (and segments) in the reference's JSON shape."""
    alignment, src_len = np.asarray(alignment), np.asarray(src_len)
    recs = []
    for i in range(alignment.shape[0]):
        rec: dict = {"index": i,
                     "alignment": [int(a) for a in alignment[i, : int(src_len[i])]]}
        if segments is not None:
            rec["segments"] = [[int(s), int(e), int(c)] for (s, e, c) in segments[i]]
        recs.append(rec)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(recs, indent=1))


def load_alignment_json(path: str | Path, n: int, max_src_len: int) -> GoldAnnotations:
    recs = json.loads(Path(path).read_text())
    alignment = np.zeros((n, max_src_len), dtype=np.int32)
    segments: list[list[tuple[int, int, int]]] = [[] for _ in range(n)]
    for rec in recs:
        i = rec["index"]
        a = rec["alignment"][:max_src_len]
        alignment[i, : len(a)] = a
        segments[i] = [tuple(s) for s in rec.get("segments", [])]
    return GoldAnnotations(alignment=alignment, segments=segments)
