"""Per-utterance float64 NumPy segmental embedded k-means — parity oracle
for models/segmental_kmeans.py (Kamper-style ES-KMeans comparison baseline;
reference-style per-utterance loops).

Semantics mirrored exactly (see the module's docstrings):
  - candidate segment (end t inclusive, length l) embedded by linear
    interpolation at rel = (i + 0.5)/n_samples positions over [start, end];
  - cluster cost = min squared distance to a centroid, first-index ties;
  - DP cost[t+1] = min_l cost[t+1-l] + segcost[t, l] with l >= min_len,
    first (shortest-l) tie winner;
  - hard centroid update over the chosen segments; empty clusters keep
    their previous centroid.
"""

from __future__ import annotations

import numpy as np

_BIG = 1e30


class NumpySegKMeans:
    def __init__(
        self,
        feat_seqs,  # ragged [T_i, D] float arrays
        centroids,  # [K, n_samples * D]
        n_samples: int = 4,
        max_seg_len: int = 8,
        min_seg_len: int = 1,
    ):
        self.x = [np.asarray(f, np.float64) for f in feat_seqs]
        self.centroids = np.asarray(centroids, np.float64)
        self.n_samples = n_samples
        self.max_seg_len = max_seg_len
        self.min_seg_len = min_seg_len

    def _embed(self, x, start, end):
        """Downsampled segment embedding, [n_samples * D]."""
        l = end - start + 1
        rel = (np.arange(self.n_samples) + 0.5) / self.n_samples
        pos = start + rel * (l - 1)
        p0 = np.floor(pos).astype(int)
        p1 = np.minimum(p0 + 1, x.shape[0] - 1)
        w = (pos - p0)[:, None]
        return (x[p0] * (1 - w) + x[p1] * w).reshape(-1)

    def _segment_one(self, x):
        """DP segmentation of one utterance.

        Returns (segments [(start, end_excl, label)], total_cost) where cost
        is the chosen segments' min-distance sum.
        """
        T = x.shape[0]
        L = self.max_seg_len
        segc = np.full((T, L), _BIG)
        lab = np.zeros((T, L), dtype=int)
        for t in range(T):
            for l in range(1, L + 1):
                s = t - l + 1
                if s < 0 or l < self.min_seg_len:
                    continue
                e = self._embed(x, s, t)
                d = ((e[None, :] - self.centroids) ** 2).sum(-1)
                segc[t, l - 1] = d.min()
                lab[t, l - 1] = int(d.argmin())

        cost = np.full(T + 1, _BIG)
        cost[0] = 0.0
        best_len = np.zeros(T, dtype=int)
        for t in range(T):
            totals = np.full(L, _BIG)
            for l in range(1, L + 1):
                if t + 1 - l < 0 or l < self.min_seg_len:
                    continue
                totals[l - 1] = cost[t + 1 - l] + segc[t, l - 1]
            best_len[t] = int(totals.argmin()) + 1
            cost[t + 1] = totals.min()

        segments = []
        total = 0.0
        end = T - 1
        while end >= 0:
            l = best_len[end]
            segments.append((end - l + 1, end + 1, lab[end, l - 1]))
            total += segc[end, l - 1]
            end -= l
        return list(reversed(segments)), total

    def discover(self):
        """[(start, end_excl, label + 1)] per utterance (the batched
        module's shifted label convention: 0 = not a word unit)."""
        return [
            [(s, e, c + 1) for (s, e, c) in self._segment_one(x)[0]]
            for x in self.x
        ]

    def em_iteration(self) -> tuple[float, int]:
        """One ES-KMeans iteration; returns (total distortion, #segments)."""
        k, e_dim = self.centroids.shape
        sums = np.zeros((k, e_dim))
        counts = np.zeros(k)
        total = 0.0
        n_seg = 0
        for x in self.x:
            segments, cost = self._segment_one(x)
            total += cost
            n_seg += len(segments)
            for (s, e, c) in segments:
                sums[c] += self._embed(x, s, e - 1)
                counts[c] += 1.0
        nz = counts > 0
        self.centroids[nz] = sums[nz] / counts[nz, None]
        return float(total), n_seg


class NumpySegGMM(NumpySegKMeans):
    """GMM softening (models/segmental_kmeans.em_step_gmm): segment cost =
    soft-min -logsumexp_k(-d2/2var); soft responsibilities update centroids
    and a shared spherical variance."""

    def __init__(self, feat_seqs, centroids, log_var=0.0, **kw):
        super().__init__(feat_seqs, centroids, **kw)
        self.log_var = float(log_var)

    def em_iteration(self) -> tuple[float, int]:
        k, e_dim = self.centroids.shape
        var = np.exp(self.log_var)
        sums = np.zeros((k, e_dim))
        counts = np.zeros(k)
        d2_sum = 0.0
        total = 0.0
        n_seg = 0
        for x in self.x:
            T = x.shape[0]
            L = self.max_seg_len
            segc = np.full((T, L), _BIG)
            segd2 = np.full((T, L, k), _BIG)
            for t in range(T):
                for l in range(1, L + 1):
                    s = t - l + 1
                    if s < 0 or l < self.min_seg_len:
                        continue
                    e = self._embed(x, s, t)
                    d2 = ((e[None, :] - self.centroids) ** 2).sum(-1)
                    segd2[t, l - 1] = d2
                    logp = -d2 / (2 * var)
                    m = logp.max()
                    segc[t, l - 1] = -(m + np.log(np.exp(logp - m).sum() + 1e-38))
            cost = np.full(T + 1, _BIG)
            cost[0] = 0.0
            best_len = np.zeros(T, dtype=int)
            for t in range(T):
                totals = np.full(L, _BIG)
                for l in range(1, L + 1):
                    if t + 1 - l < 0 or l < self.min_seg_len:
                        continue
                    totals[l - 1] = cost[t + 1 - l] + segc[t, l - 1]
                best_len[t] = int(totals.argmin()) + 1
                cost[t + 1] = totals.min()
            end = T - 1
            while end >= 0:
                l = best_len[end]
                total += segc[end, l - 1]
                n_seg += 1
                d2 = segd2[end, l - 1]
                logp = -d2 / (2 * var)
                resp = np.exp(logp - logp.max())
                resp /= resp.sum()
                emb = self._embed(x, end - l + 1, end)
                sums += resp[:, None] * emb[None, :]
                counts += resp
                d2_sum += (resp * d2).sum()
                end -= l
        nz = counts > 1e-6
        self.centroids[nz] = sums[nz] / np.maximum(counts[nz, None], 1e-6)
        var_new = d2_sum / max(counts.sum() * e_dim, 1e-6)
        self.log_var = float(np.log(max(var_new, 1e-6)))
        return float(total), n_seg
