"""Per-utterance float64 NumPy GMM-HMM aligner — parity oracle for
models/hmm_gaussian.py (same paired-NULL Vogel skeleton as numpy_hmm, with
per-concept diagonal Gaussian mixture emissions; reference-style
loops)."""

from __future__ import annotations

import numpy as np
from scipy.special import logsumexp

NEG_INF = -1e30
_LOG_2PI = 1.8378770664093453


class NumpyGaussianHMM:
    def __init__(
        self,
        feat_seqs,  # ragged [T_i, D] float arrays
        trg_seqs,
        v_trg: int,
        max_jump: int = 3,
        n_components: int = 1,
        seed: int = 0,
    ):
        self.x = [np.asarray(f, np.float64) for f in feat_seqs]
        self.trg = [np.asarray(t, np.int64) for t in trg_seqs]
        self.v_trg = v_trg
        self.max_jump = max_jump
        self.k = n_components
        d = self.x[0].shape[1]

        allx = np.concatenate(self.x, axis=0)
        mean, var = allx.mean(0), allx.var(0)
        self.gvar = var.copy()
        # mirror models/hmm_gaussian.init exactly (same keys impossible —
        # oracle parity tests pass explicit params instead of matching RNG)
        rng = np.random.default_rng(seed)
        self.means = mean[None, None, :] + 0.1 * np.sqrt(var) * rng.normal(
            size=(v_trg, n_components, d)
        )
        self.log_vars = np.broadcast_to(np.log(var + 1e-6), (v_trg, n_components, d)).copy()
        self.log_mix = np.full((v_trg, n_components), -np.log(n_components))
        W = 2 * max_jump + 1
        self.log_jump = -0.5 * np.abs(np.arange(W) - max_jump - 1.0)
        self.log_p0 = np.log(0.2)

    def set_params(self, means, log_vars, log_mix, log_jump, log_p0):
        self.means = np.asarray(means, np.float64)
        self.log_vars = np.asarray(log_vars, np.float64)
        self.log_mix = np.asarray(log_mix, np.float64)
        self.log_jump = np.asarray(log_jump, np.float64)
        self.log_p0 = float(log_p0)

    def _utt_trans(self, trg):
        tt = len(trg)
        s = 2 * tt
        pos = np.arange(s) % tt
        is_null = np.arange(s) >= tt
        concepts = np.where(is_null, 0, trg[pos])
        w = np.clip(pos[None, :] - pos[:, None], -self.max_jump, self.max_jump) + self.max_jump
        logw = self.log_jump[w]
        same = pos[None, :] == pos[:, None]
        logw = np.where(is_null[None, :], np.where(same, self.log_p0, NEG_INF), logw)
        log_trans = logw - logsumexp(logw, axis=1, keepdims=True)
        iw = np.where(is_null, self.log_p0, 0.0)
        log_init = iw - logsumexp(iw)
        return pos, is_null, concepts, log_trans, log_init

    def _logb(self, x):
        """[T, C] mixture log-densities."""
        t, d = x.shape
        comp = np.zeros((t, self.v_trg, self.k))
        for c in range(self.v_trg):
            for k in range(self.k):
                var = np.exp(self.log_vars[c, k])
                diff = x - self.means[c, k]
                comp[:, c, k] = -0.5 * (
                    (diff**2 / var).sum(-1) + self.log_vars[c, k].sum() + d * _LOG_2PI
                )
        logw = self.log_mix - logsumexp(self.log_mix, axis=-1, keepdims=True)
        return logsumexp(comp + logw[None], axis=-1), comp, logw

    def loglik(self) -> float:
        total = 0.0
        for x, trg in zip(self.x, self.trg):
            pos, is_null, concepts, log_trans, log_init = self._utt_trans(trg)
            logb, _, _ = self._logb(x)
            le = logb[:, concepts]  # [T, S]
            alpha = log_init + le[0]
            for t in range(1, len(x)):
                alpha = logsumexp(alpha[:, None] + log_trans, axis=0) + le[t]
            total += logsumexp(alpha)
        return float(total)

    def em_iteration(self, smoothing=1e-6, var_floor=1e-4, var_floor_rel=1e-3) -> float:
        d = self.x[0].shape[1]
        c0 = np.zeros((self.v_trg, self.k))
        c1 = np.zeros((self.v_trg, self.k, d))
        c2 = np.zeros((self.v_trg, self.k, d))
        W = 2 * self.max_jump + 1
        width_counts = np.zeros(W)
        p0_count = 0.0
        total_ll = 0.0
        for x, trg in zip(self.x, self.trg):
            pos, is_null, concepts, log_trans, log_init = self._utt_trans(trg)
            logb, comp, logw = self._logb(x)
            le = logb[:, concepts]
            T, S = le.shape
            alpha = np.zeros((T, S))
            alpha[0] = log_init + le[0]
            for t in range(1, T):
                alpha[t] = logsumexp(alpha[t - 1][:, None] + log_trans, axis=0) + le[t]
            beta = np.zeros((T, S))
            for t in range(T - 2, -1, -1):
                beta[t] = logsumexp(log_trans + (le[t + 1] + beta[t + 1])[None, :], axis=1)
            logz = logsumexp(alpha[-1])
            total_ll += logz
            gamma = np.exp(alpha + beta - logz)  # [T, S]
            # concept posteriors
            r = np.zeros((T, self.v_trg))
            for s in range(S):
                r[:, concepts[s]] += gamma[:, s]
            # component responsibilities
            u = np.exp(comp + logw[None] - logsumexp(comp + logw[None], axis=-1, keepdims=True))
            comb = r[:, :, None] * u  # [T, C, K]
            c0 += comb.sum(0)
            c1 += np.einsum("tck,td->ckd", comb, x)
            c2 += np.einsum("tck,td->ckd", comb, x**2)
            for t in range(T - 1):
                xi = np.exp(alpha[t][:, None] + log_trans + (le[t + 1] + beta[t + 1])[None, :] - logz)
                for sp in range(S):
                    for sn in range(S):
                        if is_null[sn]:
                            if pos[sn] == pos[sp]:
                                p0_count += xi[sp, sn]
                        else:
                            w_ = int(np.clip(pos[sn] - pos[sp], -self.max_jump, self.max_jump)) + self.max_jump
                            width_counts[w_] += xi[sp, sn]
        c0s = c0 + smoothing
        self.means = c1 / c0s[..., None]
        floor = np.maximum(var_floor, var_floor_rel * self.gvar)[None, None, :]
        self.log_vars = np.log(np.maximum(c2 / c0s[..., None] - self.means**2, floor))
        self.log_mix = np.log(c0s) - np.log(c0s.sum(-1, keepdims=True))
        self.log_jump = np.log(width_counts + smoothing)
        self.log_p0 = np.log(p0_count + smoothing)
        return float(total_ll)

    def supervised_iteration(
        self, gold_seqs, smoothing=1e-6, var_floor=1e-4, var_floor_rel=1e-3
    ) -> None:
        """Oracle-assignment M-step — parity oracle for
        models/hmm_gaussian.supervised_counts + m_step.  gold_seqs: ragged
        [T_i] int arrays, 0 = NULL, else 1-based target position.  Gamma is
        the gold one-hot (NULL frames -> concept 0); component
        responsibilities come from the CURRENT params; jump widths are
        measured from the last REAL position (NULL states hold their
        predecessor's underlying position — hmm_core.jump_width_ids)."""
        d = self.x[0].shape[1]
        c0 = np.zeros((self.v_trg, self.k))
        c1 = np.zeros((self.v_trg, self.k, d))
        c2 = np.zeros((self.v_trg, self.k, d))
        W = 2 * self.max_jump + 1
        width_counts = np.zeros(W)
        p0_count = 0.0
        for x, trg, a in zip(self.x, self.trg, gold_seqs):
            a = np.asarray(a, np.int64)
            T = len(x)
            _, comp, logw = self._logb(x)
            u = np.exp(
                comp + logw[None]
                - logsumexp(comp + logw[None], axis=-1, keepdims=True)
            )  # [T, C, K]
            r = np.zeros((T, self.v_trg))
            for t in range(T):
                c = trg[a[t] - 1] if a[t] > 0 else 0
                r[t, c] = 1.0
            comb = r[:, :, None] * u
            c0 += comb.sum(0)
            c1 += np.einsum("tck,td->ckd", comb, x)
            c2 += np.einsum("tck,td->ckd", comb, x**2)
            last_real = -1
            for t in range(T):
                if t > 0:
                    if a[t] == 0:
                        p0_count += 1.0
                    elif last_real > 0:
                        w_ = int(
                            np.clip(a[t] - last_real, -self.max_jump, self.max_jump)
                        ) + self.max_jump
                        width_counts[w_] += 1.0
                if a[t] > 0:
                    last_real = int(a[t])
        c0s = c0 + smoothing
        self.means = c1 / c0s[..., None]
        floor = np.maximum(var_floor, var_floor_rel * self.gvar)[None, None, :]
        self.log_vars = np.log(np.maximum(c2 / c0s[..., None] - self.means**2, floor))
        self.log_mix = np.log(c0s) - np.log(c0s.sum(-1, keepdims=True))
        self.log_jump = np.log(width_counts + smoothing)
        self.log_p0 = np.log(p0_count + smoothing)
