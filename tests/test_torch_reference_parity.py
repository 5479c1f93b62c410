"""The port's reference_parity against the root scripts/reference_parity.py
(loaded by importlib, as tests/test_reference_parity.py loads it), on the
CPU: the adapters parse every dump form the same, and ``run_parity`` reaches
"parity" on a reference mocked by the JAX package's discrete HMM (20 EM
iterations on 30 utterances) and "diverged" on the same dump shifted by one
target position; an empty reference directory reports
"reference-mount-empty".
"""

import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.models import hmm
from multimodalworddiscovery_tpu_torch.scripts import reference_parity as trp

_spec = importlib.util.spec_from_file_location(
    "root_reference_parity",
    Path(__file__).parent.parent / "scripts" / "reference_parity.py",
)
rp = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(rp)

FORMATS = ("records", "bare", "dict", "jsonl")


@pytest.fixture(scope="module")
def mock(tmp_path_factory):
    """A reference-style output directory from the JAX package: captions,
    concept labels, and a converged discrete HMM's alignments."""
    corpus, _, _ = make_flickr8k_mini(n_utterances=30, seed=21)
    ref = tmp_path_factory.mktemp("reference_out")
    src, trg = np.asarray(corpus.src), np.asarray(corpus.trg)
    sl, tl = np.asarray(corpus.src_len), np.asarray(corpus.trg_len)
    (ref / "phone_captions.txt").write_text(
        "\n".join(" ".join(str(int(x)) for x in src[i, : sl[i]]) for i in range(corpus.n)) + "\n")
    (ref / "concept_labels.txt").write_text(
        "\n".join(" ".join(str(int(x)) for x in trg[i, : tl[i]]) for i in range(corpus.n)) + "\n")
    p, _ = jax.jit(lambda q: hmm.train(q, corpus, 20))(hmm.init(corpus))
    al = np.asarray(hmm.align(p, corpus))
    return ref, [[int(a) for a in al[i, : sl[i]]] for i in range(corpus.n)]


def _write_dump(path: Path, fmt: str, alignments) -> None:
    recs = [{"index": i, "alignment": a} for i, a in enumerate(alignments)]
    if fmt == "records":
        path.write_text(json.dumps(recs))
    elif fmt == "bare":
        path.write_text(json.dumps(alignments))
    elif fmt == "dict":
        path.write_text(json.dumps({"alignments": alignments}))
    else:  # JSONL, out of index order
        path.write_text("\n".join(json.dumps(r) for r in reversed(recs)) + "\n")


@pytest.mark.parametrize("fmt", FORMATS)
def test_adapters_parse_as_the_root_script(tmp_path, mock, fmt):
    _, alignments = mock
    dump = tmp_path / "alignment_dump.json"
    _write_dump(dump, fmt, alignments)
    got = trp.read_alignment_dump(dump)
    assert got == rp.read_alignment_dump(dump) == alignments


def test_artifact_scan_as_the_root_script(mock):
    ref, _ = mock
    found = trp.find_artifacts(ref)
    assert found == rp.find_artifacts(ref)
    assert trp.pair_captions(found["captions"]) == rp.pair_captions(found["captions"])


def _reference_with(tmp_path, mock, alignments) -> Path:
    ref, _ = mock
    out = tmp_path / "ref"
    out.mkdir()
    for name in ("phone_captions.txt", "concept_labels.txt"):
        (out / name).write_text((ref / name).read_text())
    _write_dump(out / "alignment_dump.json", "records", alignments)
    return out


def test_parity_on_a_reference_mocked_by_the_jax_hmm(tmp_path, mock):
    ref = _reference_with(tmp_path, mock, mock[1])
    report = trp.run_parity(ref, tmp_path / "wd", "hmm", 20, threshold=0.9, device="cpu")
    assert report["status"] == "parity", report
    assert report["best_f1"] >= 0.9 and report["corpus"]["n"] == 30
    (dump,) = report["dumps"].values()
    assert dump["token_agreement"] >= 0.95


def test_parity_detects_divergence(tmp_path, mock):
    shifted = [[(a % 4) + 1 for a in al] for al in mock[1]]
    ref = _reference_with(tmp_path, mock, shifted)
    report = trp.run_parity(ref, tmp_path / "wd", "hmm", 20, threshold=0.9, device="cpu")
    assert report["status"] == "diverged", report


def test_empty_reference_reports_cleanly(tmp_path, capsys):
    empty = tmp_path / "empty"
    empty.mkdir()
    report = trp.main(["--reference", str(empty)])
    assert report["status"] == "reference-mount-empty"
    assert "reference-mount-empty" in trp.OK_STATUSES
    assert json.loads(capsys.readouterr().out)["status"] == "reference-mount-empty"


def test_defaults_to_the_card(tmp_path, mock, monkeypatch):
    """Without --device the harness trains on the card, and refuses a host
    without one rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        trp.main(["--reference", str(mock[0]), "--workdir", str(tmp_path / "wd")])
