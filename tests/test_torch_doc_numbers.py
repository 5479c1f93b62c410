"""The port's doc-number checker (scripts/check_doc_numbers.py of the port):
it passes on the tree, and on a copy of the documents with one claim broken
it fails naming that claim.  Pure file parsing."""

import shutil
from pathlib import Path

import pytest

from multimodalworddiscovery_tpu_torch.scripts import check_doc_numbers as cdn

ROOT = Path(__file__).resolve().parents[1]


def test_the_tree_passes(capsys):
    assert cdn.main([]) == 0, capsys.readouterr().out


@pytest.fixture()
def copy(tmp_path):
    for name in ("README.md", "PERF.md"):
        shutil.copy(ROOT / name, tmp_path / name)
    assert cdn.main(["--root", str(tmp_path)]) == 0
    return tmp_path


def _edit(path: Path, old: str, new: str) -> None:
    text = path.read_text()
    assert old in text
    path.write_text(text.replace(old, new, 1))


def test_a_changed_quote_fails_naming_its_claim(copy, capsys):
    readme = (copy / "README.md").read_text()
    claim, pattern, _, _ = cdn.CLAIMS[0]
    quoted = cdn.doc_num(cdn.port_section(readme), pattern)
    text = cdn.port_section(readme)
    old = next(line for line in text.splitlines() if "chip_smoke.py` takes about" in line)
    _edit(copy / "README.md", old, old.replace(f"{quoted:g}", f"{quoted * 1.5:g}", 1))
    capsys.readouterr()
    assert cdn.main(["--root", str(copy)]) == 1
    assert claim in capsys.readouterr().out


def test_a_section_without_the_card_fails(copy, capsys):
    with open(copy / "PERF.md", "a") as f:
        f.write("\n## 8. A new section\n\nThe headline took 1.5 ms an iteration.\n")
    capsys.readouterr()
    assert cdn.main(["--root", str(copy)]) == 1
    assert "'## 8. A new section'" in capsys.readouterr().out


def test_a_tpu_time_fails(copy, capsys):
    _edit(copy / "README.md", cdn.PORT_SECTION,
          cdn.PORT_SECTION + "\n\nA made-up line: 9.99 ms a step on one TPU chip.\n")
    capsys.readouterr()
    assert cdn.main(["--root", str(copy)]) == 1
    assert "quotes a TPU time" in capsys.readouterr().out
