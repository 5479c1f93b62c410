"""Per-utterance float64 NumPy Model-1 EM — the parity/throughput oracle.

Written in the reference's style: ragged utterance lists, a
Python loop per utterance inside every EM iteration, dense NumPy inner math.
"""

from __future__ import annotations

import numpy as np


class NumpyModel1:
    """IBM Model-1 / mixture word discoverer, per-utterance EM."""

    def __init__(self, src_seqs, trg_seqs, v_src: int, v_trg: int):
        # Ragged lists of int arrays; concept id 0 = NULL (prepended here).
        self.src = [np.asarray(s, dtype=np.int64) for s in src_seqs]
        self.trg = [
            np.concatenate([[0], np.asarray(t, dtype=np.int64)]) for t in trg_seqs
        ]
        self.v_src, self.v_trg = v_src, v_trg
        self.t = np.full((v_src, v_trg), 1.0 / v_src, dtype=np.float64)

    def em_iteration(self, smoothing: float = 1e-8) -> float:
        counts = np.zeros_like(self.t)
        ll = 0.0
        for src, trg in zip(self.src, self.trg):
            probs = self.t[np.ix_(src, trg)]  # [Ts, 1+Tt]
            denom = probs.sum(axis=1, keepdims=True)
            ll += float(np.log(denom).sum()) - len(src) * np.log(len(trg))
            gamma = probs / denom
            np.add.at(counts, (src[:, None], trg[None, :]), gamma)
        counts += smoothing
        self.t = counts / counts.sum(axis=0, keepdims=True)
        return ll

    def train(self, num_iterations: int, smoothing: float = 1e-8) -> list[float]:
        return [self.em_iteration(smoothing) for _ in range(num_iterations)]

    def align(self) -> list[np.ndarray]:
        """Per utterance: argmax_j t(f_i | e_j); 0 = NULL position."""
        out = []
        for src, trg in zip(self.src, self.trg):
            probs = self.t[np.ix_(src, trg)]
            out.append(np.argmax(probs, axis=1).astype(np.int32))
        return out

    def loglik(self) -> float:
        ll = 0.0
        for src, trg in zip(self.src, self.trg):
            probs = self.t[np.ix_(src, trg)]
            ll += float(np.log(probs.sum(axis=1)).sum()) - len(src) * np.log(len(trg))
        return ll
