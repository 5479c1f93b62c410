"""Per-utterance float64 NumPy HMM aligner — parity/throughput oracle.

Same model semantics as ``models/hmm.py`` (paired-NULL Vogel HMM), written
the reference's way: a Python loop over utterances inside
every EM iteration, log-space forward/backward/Viterbi per utterance.
"""

from __future__ import annotations

import numpy as np
from scipy.special import logsumexp

NEG_INF = -1e30


class NumpyHMM:
    def __init__(self, src_seqs, trg_seqs, v_src: int, v_trg: int, max_jump: int = 3):
        self.src = [np.asarray(x, dtype=np.int64) for x in src_seqs]
        self.trg = [np.asarray(x, dtype=np.int64) for x in trg_seqs]
        self.v_src, self.v_trg = v_src, v_trg
        self.max_jump = max_jump
        W = 2 * max_jump + 1
        self.log_emit = np.full((v_src, v_trg), -np.log(v_src))
        self.log_jump = -0.5 * np.abs(np.arange(W) - max_jump - 1.0)
        self.log_p0 = np.log(0.2)

    # --- per-utterance machinery ---
    def _utt(self, trg):
        tt = len(trg)
        s = 2 * tt
        pos = np.arange(s) % tt
        is_null = np.arange(s) >= tt
        concepts = np.where(is_null, 0, trg[pos])
        # transitions
        W = 2 * self.max_jump + 1
        w = np.clip(pos[None, :] - pos[:, None], -self.max_jump, self.max_jump) + self.max_jump
        logw = self.log_jump[w]
        to_null = is_null[None, :]
        same = pos[None, :] == pos[:, None]
        logw = np.where(to_null, np.where(same, self.log_p0, NEG_INF), logw)
        log_trans = logw - logsumexp(logw, axis=1, keepdims=True)
        # init
        iw = np.where(is_null, self.log_p0, 0.0)
        log_init = iw - logsumexp(iw)
        return pos, is_null, concepts, log_trans, log_init

    def _fb(self, src, trg):
        pos, is_null, concepts, log_trans, log_init = self._utt(trg)
        T, S = len(src), len(pos)
        log_emit = self.log_emit[np.ix_(src, concepts)]  # [T, S]
        alpha = np.zeros((T, S))
        alpha[0] = log_init + log_emit[0]
        for t in range(1, T):
            alpha[t] = logsumexp(alpha[t - 1][:, None] + log_trans, axis=0) + log_emit[t]
        beta = np.zeros((T, S))
        for t in range(T - 2, -1, -1):
            beta[t] = logsumexp(log_trans + (log_emit[t + 1] + beta[t + 1])[None, :], axis=1)
        logz = logsumexp(alpha[-1])
        return alpha, beta, logz, log_emit, log_trans, concepts, pos, is_null

    def em_iteration(self, smoothing: float = 1e-8) -> float:
        W = 2 * self.max_jump + 1
        emit_counts = np.zeros((self.v_src, self.v_trg))
        width_counts = np.zeros(W)
        p0_count = 0.0
        total_ll = 0.0
        for src, trg in zip(self.src, self.trg):
            alpha, beta, logz, log_emit, log_trans, concepts, pos, is_null = self._fb(src, trg)
            total_ll += logz
            T, S = alpha.shape
            gamma = np.exp(alpha + beta - logz)
            for t in range(T):
                np.add.at(emit_counts, (src[t], concepts), gamma[t])
            for t in range(T - 1):
                xi = np.exp(
                    alpha[t][:, None] + log_trans + (log_emit[t + 1] + beta[t + 1])[None, :] - logz
                )
                for sp in range(S):
                    for sn in range(S):
                        if is_null[sn]:
                            if pos[sn] == pos[sp]:
                                p0_count += xi[sp, sn]
                        else:
                            w = int(np.clip(pos[sn] - pos[sp], -self.max_jump, self.max_jump)) + self.max_jump
                            width_counts[w] += xi[sp, sn]
        emit_counts += smoothing
        self.log_emit = np.log(emit_counts) - np.log(emit_counts.sum(axis=0, keepdims=True))
        self.log_jump = np.log(width_counts + smoothing)
        self.log_p0 = np.log(p0_count + smoothing)
        return float(total_ll)

    def train(self, num_iterations: int, smoothing: float = 1e-8) -> list[float]:
        return [self.em_iteration(smoothing) for _ in range(num_iterations)]

    def loglik(self) -> float:
        return float(sum(self._fb(src, trg)[2] for src, trg in zip(self.src, self.trg)))

    def align(self) -> list[np.ndarray]:
        """Per-utterance Viterbi -> alignment (0 = NULL, else 1-based pos)."""
        out = []
        for src, trg in zip(self.src, self.trg):
            pos, is_null, concepts, log_trans, log_init = self._utt(trg)
            T, S = len(src), len(pos)
            log_emit = self.log_emit[np.ix_(src, concepts)]
            delta = log_init + log_emit[0]
            bps = np.zeros((T, S), dtype=np.int64)
            for t in range(1, T):
                x = delta[:, None] + log_trans
                bps[t] = np.argmax(x, axis=0)
                delta = x.max(axis=0) + log_emit[t]
            path = np.zeros(T, dtype=np.int64)
            path[-1] = int(np.argmax(delta))
            for t in range(T - 1, 0, -1):
                path[t - 1] = bps[t, path[t]]
            a = np.where(is_null[path], 0, pos[path] + 1)
            out.append(a.astype(np.int32))
        return out
