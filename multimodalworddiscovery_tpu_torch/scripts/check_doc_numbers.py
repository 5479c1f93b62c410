"""Doc-truth checker for the port's documents.

Counterpart of ``scripts/check_doc_numbers.py``, applied to the PyTorch /
CUDA port: a number quoted in a document, parsed by regex, is held to its
source with a relative tolerance that covers rounding only (a measurement
that moves a number must update the quote, not the tolerance).  Three
checks:

  1. every card number that README.md's "PyTorch / CUDA port (H100)"
     section quotes equals its value in PERF.md, which is authoritative
     (its §5 and §6, and the header's final-run times);
  2. every section of PERF.md that states a time, rate or memory size
     names the card and its power limit;
  3. no line of the README's port section, of PERF.md or of the port's
     package names a TPU beside a time, rate or memory size.

Pure file parsing: no device, no network.  Exit 0 when every claim holds;
exit 1 printing every mismatch.

    python -m multimodalworddiscovery_tpu_torch.scripts.check_doc_numbers [--root DIR]
"""

from __future__ import annotations

import argparse
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PACKAGE = "multimodalworddiscovery_tpu_torch"
PORT_SECTION = "## PyTorch / CUDA port (H100)"
CARD = ("H100", "700")  # the card's name and power limit, as PERF.md writes them
# a number with a unit of time, rate or memory size
MEASURE = re.compile(
    r"(?<![\w.])\d[\d,]*(?:\.\d+)?\s?(?:ms|s|min|µs|GB|GiB|MB|MiB|KB|KiB|TB/s|GB/s|"
    r"TFLOP/s|steps/s|utt·iter/s|utt\*iter/s|utt/s)(?![\w/])")
TPU = re.compile(r"TPU|v5 lite|v5e")

# (claim, pattern in README's port section, pattern in PERF.md, rtol): each
# pattern's one group is the number
CLAIMS = [
    ("chip_smoke.py wall time, final run",
     r"`python3 chip_smoke\.py` takes about ([\d.]+) s",
     r"\(PR 15: ([\d.]+) s, build", 0.01),
    ("chip_smoke.py kernel build, final run",
     r"the kernels' build \(([\d.]+) s in that run\)",
     r"\(PR 15: [\d.]+ s, build ([\d.]+) s", 0.01),
    ("path 21 wall time, final run",
     r"path 21 \(the studies\) about ([\d.]+) s of it",
     r"\(PR 15: [\d.]+ s, build [\d.]+ s, path 21 ([\d.]+) s", 0.01),
    ("headline EM ms per iteration",
     r"headline EM \(K1 \+ K2\) takes ([\d.]+) ms an iteration",
     r"\*\*Headline EM\*\* \(K1 \+ K2\): ([\d.]+) ms an iteration", 0.01),
    ("self_train at 40k: round 0 teacher",
     r"at 40,000 utterances: teacher ([\d.]+) →",
     r"40k `self_train`: ([\d.]+) →", 0.005),
    ("self_train at 40k: round 0 student",
     r"at 40,000 utterances: teacher [\d.]+ → student ([\d.]+) →",
     r"40k `self_train`: [\d.]+ → ([\d.]+) →", 0.005),
    ("self_train at 40k: re-seeded teacher",
     r"at 40,000 utterances: teacher [\d.]+ → student [\d.]+ → re-seeded ([\d.]+)",
     r"40k `self_train`: [\d.]+ → [\d.]+ → ([\d.]+)", 0.005),
    ("self_train at 40k: round 1 student",
     r"→ re-seeded [\d.]+ → student ([\d.]+) \(",
     r"40k `self_train`: [\d.]+ → [\d.]+ → [\d.]+ → ([\d.]+)", 0.005),
    ("exp_crf40k em_trans accuracy",
     r"exp_crf40k: em_trans ([\d.]+) at",
     r"21c em_trans, e2e_trans accuracy; ms a step \| [^|]* \| ([\d.]+),", 0.005),
    ("exp_crf40k em_trans ms per step",
     r"exp_crf40k: em_trans [\d.]+ at ([\d.]+) ms a step",
     r"21c em_trans, e2e_trans accuracy; ms a step \| [^|]* \| [\d.]+, [\d.]+; ([\d.]+),",
     0.01),
    ("exp_crf40k e2e_trans accuracy",
     r"e2e_trans ([\d.]+) at [\d.]+ ms",
     r"21c em_trans, e2e_trans accuracy; ms a step \| [^|]* \| [\d.]+, ([\d.]+);", 0.005),
    ("exp_crf40k e2e_trans ms per step",
     r"e2e_trans [\d.]+ at ([\d.]+) ms",
     r"21c em_trans, e2e_trans accuracy; ms a step \| [^|]* \| [\d.]+, [\d.]+; [\d.]+, "
     r"([\d.]+)", 0.01),
]


def doc_num(text: str, pattern: str) -> float | None:
    """The single capture group of ``pattern`` in ``text`` as a float
    (commas stripped), None when the pattern is not found."""
    m = re.search(pattern, text)
    return None if m is None else float(m.group(1).replace(",", ""))


def port_section(readme: str) -> str:
    """README's port section: from its heading to the next level-2 heading."""
    start = readme.find(PORT_SECTION)
    if start < 0:
        return ""
    nxt = re.search(r"^## ", readme[start + len(PORT_SECTION):], re.M)
    return readme[start:] if nxt is None else readme[start: start + len(PORT_SECTION)
                                                       + nxt.start()]


def sections(markdown: str) -> list[tuple[str, str]]:
    """(heading, body) of each level-2 section, the preamble as ("", ...)."""
    parts = re.split(r"^(## .*)$", markdown, flags=re.M)
    out = [("", parts[0])]
    out += [(parts[i], parts[i + 1]) for i in range(1, len(parts) - 1, 2)]
    return out


def check(root: Path) -> list[str]:
    """Every mismatch, as a line naming the claim."""
    failures: list[str] = []
    readme = (root / "README.md").read_text()
    perf = (root / "PERF.md").read_text()
    port = port_section(readme)
    if not port:
        return [f"  README.md has no {PORT_SECTION!r} section"]

    # 1. the README's card numbers against PERF.md (line breaks read as spaces)
    flat_port, flat_perf = " ".join(port.split()), " ".join(perf.split())
    for claim, doc_pat, src_pat, rtol in CLAIMS:
        got, want = doc_num(flat_port, doc_pat), doc_num(flat_perf, src_pat)
        if got is None or want is None:
            where = "README.md's port section" if got is None else "PERF.md"
            failures.append(f"  {claim}: pattern not found in {where}")
        elif abs(got - want) > rtol * abs(want):
            failures.append(f"  {claim}: README says {got}, PERF.md says {want} "
                            f"(rel err {abs(got - want) / max(abs(want), 1e-12):.2%} "
                            f"> rtol {rtol:.2%})")

    # 2. a PERF.md section with a time, rate or size names the card
    card_named = all(c in sections(perf)[0][1] for c in CARD)
    for heading, body in sections(perf)[1:]:
        if MEASURE.search(body) and not all(c in body for c in CARD):
            failures.append(f"  PERF.md section {heading.strip()!r} states a time, rate or "
                            f"memory size without the card's name and power limit "
                            f"({' and '.join(CARD)})")
    if not card_named:
        failures.append("  PERF.md's header does not name the card and its power limit")

    # 3. no TPU time in the port's documents and package
    texts = [("README.md (port section)", port), ("PERF.md", perf)]
    texts += [(str(p.relative_to(root)), p.read_text())
              for p in sorted((root / PACKAGE).rglob("*.py")) if p.name != Path(__file__).name]
    for name, text in texts:
        for i, line in enumerate(text.splitlines(), 1):
            if TPU.search(line) and MEASURE.search(line):
                failures.append(f"  {name}:{i} quotes a TPU time, rate or size: "
                                f"{line.strip()[:120]}")
    return failures


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(ROOT),
                    help="the repository whose README.md and PERF.md to check")
    args = ap.parse_args(argv)
    failures = check(Path(args.root))
    if failures:
        print("doc-number check FAILED:")
        print("\n".join(failures))
        return 1
    print("doc-number check OK (the port's quoted numbers match PERF.md; no TPU time)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
