"""Native (C) corpus packer with a pure-Python fallback.

Counterpart of ``multimodalworddiscovery_tpu/native`` with its own copy of
``packer.c`` (built by setup.py as
``multimodalworddiscovery_tpu_torch.native._packer``), so the port imports
nothing of the JAX package.  ``pack_token_file`` parses an integer-token
caption file in one pass into a padded [N, T] int32 array and lengths; the
fallback is the line-by-line Python parser.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

try:
    from multimodalworddiscovery_tpu_torch.native import _packer  # type: ignore

    HAVE_NATIVE = True
except ImportError:  # extension not built: pure-Python fallback
    _packer = None
    HAVE_NATIVE = False


def _pack_python(path: str | Path, pad_multiple: int = 1):
    seqs = []
    for line in Path(path).read_text().splitlines():
        toks = line.split()
        if toks:
            seqs.append(np.asarray([int(t) for t in toks], np.int32))
    n = len(seqs)
    max_len = max((len(s) for s in seqs), default=0)
    max_len = ((max_len + pad_multiple - 1) // pad_multiple) * pad_multiple
    max_len = max(max_len, pad_multiple)
    out = np.zeros((n, max_len), np.int32)
    lens = np.zeros((n,), np.int32)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
        lens[i] = len(s)
    vocab_max = int(max((int(s.max()) for s in seqs if len(s)), default=0))
    return out, lens, vocab_max


def pack_token_file(
    path: str | Path, pad_multiple: int = 1, force_python: bool = False
) -> tuple[np.ndarray, np.ndarray, int]:
    """Returns (padded [N, T] int32, lengths [N] int32, vocab_max).  Blank
    lines are skipped; T is padded up to a multiple of ``pad_multiple``."""
    if not HAVE_NATIVE or force_python:
        return _pack_python(path, pad_multiple)
    padded, n, max_len, lengths, vocab_max = _packer.pack_tokens(str(path), pad_multiple)
    arr = np.frombuffer(padded, dtype=np.int32).reshape(n, max_len).copy()
    lens = np.frombuffer(lengths, dtype=np.int32).copy()
    return arr, lens, int(vocab_max)
