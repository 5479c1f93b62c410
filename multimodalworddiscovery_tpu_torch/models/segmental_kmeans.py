"""Segmental embedded k-means / GMM word discoverers (audio-only baselines).

Counterpart of ``multimodalworddiscovery_tpu/models/segmental_kmeans.py``:
Kamper-style segmental embedded k-means and its GMM softening, batched over
the corpus.

  embed       every candidate segment (end t, length l <= L) at once: a
              fixed linear-resampling gather -> [N, T, L, n_samples*D]
  assign      one product against the centroid matrix -> min distance and
              argmin (ties to the first centroid) [N, T, L]
  re-segment  the DP cost[t] = min_l cost[t-l] + segcost[t, l], one loop
              over time batched over the corpus, then the backtrace, one
              loop over time backwards
  update      the centroid sums and counts over the winning segments,
              scatter-added (``index_add_``)

The cluster ids are unsupervised word classes (evaluated by boundary F1 and
purity).  Keep ``torch.backends.cuda.matmul.allow_tf32`` off: the distances
come from a product.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.data.corpus import Corpus

_BIG = 1e30


@dataclasses.dataclass(frozen=True)
class SegKMeansParams:
    centroids: torch.Tensor  # [K, n_samples * D]
    n_samples: int = 4
    max_seg_len: int = 8
    min_seg_len: int = 1


@dataclasses.dataclass(frozen=True)
class SegGMMParams:
    centroids: torch.Tensor  # [K, E] means
    log_var: torch.Tensor  # scalar, the shared spherical variance
    n_samples: int = 4
    max_seg_len: int = 8
    min_seg_len: int = 1


def params_from_numpy(
    centroids, n_samples: int = 4, max_seg_len: int = 8, min_seg_len: int = 1,
    log_var=None, device="cuda",
) -> SegKMeansParams | SegGMMParams:
    """Carry centroids across from a host array onto ``device``: k-means
    parameters, or the GMM's where ``log_var`` is given."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    static = dict(n_samples=int(n_samples), max_seg_len=int(max_seg_len),
                  min_seg_len=int(min_seg_len))
    if log_var is None:
        return SegKMeansParams(centroids=t(centroids), **static)
    return SegGMMParams(centroids=t(centroids), log_var=t(log_var).reshape(()), **static)


def embed_all_segments(x: torch.Tensor, n_samples: int, max_seg_len: int) -> torch.Tensor:
    """All candidate segment embeddings: x [N, T, D] -> [N, T, L, n_samples*D],
    slot (t, l) embedding the segment that ends AT frame t with length l+1,
    resampled to n_samples frames by linear interpolation."""
    n, t_len, d = x.shape
    dev = x.device
    lengths = torch.arange(1, max_seg_len + 1, device=dev)  # [L]
    t_end = torch.arange(t_len, device=dev)
    rel = (torch.arange(n_samples, device=dev, dtype=torch.float32) + 0.5) / n_samples
    start = t_end[:, None] - lengths[None, :] + 1  # [T, L]
    pos = start[:, :, None] + rel[None, None, :] * (lengths[:, None] - 1)  # [T, L, S]
    pos = torch.clamp(pos, 0.0, t_len - 1.0)
    p0 = torch.floor(pos).long()
    p1 = torch.clamp(p0 + 1, max=t_len - 1)
    w = (pos - p0)[None, :, :, :, None]  # [1, T, L, S, 1]
    emb = x[:, p0] * (1 - w) + x[:, p1] * w  # [N, T, L, S, D]
    return emb.reshape(n, t_len, max_seg_len, n_samples * d)


def _sq_dists(emb: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """||e - c||^2 = ||e||^2 - 2 e.c + ||c||^2 -> [N, T, L, K]."""
    e2 = torch.sum(emb**2, dim=-1, keepdim=True)
    c2 = torch.sum(c**2, dim=-1)
    return e2 - 2 * torch.einsum("ntle,ke->ntlk", emb, c) + c2


def _seg_costs(params, emb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Min squared distance to a centroid and its argmin per candidate
    segment: (cost [N, T, L], label [N, T, L] int32)."""
    d2 = _sq_dists(emb, params.centroids)
    return torch.amin(d2, dim=-1), torch.argmin(d2, dim=-1).to(torch.int32)


def _valid_candidates(corpus: Corpus, t_len: int, max_l: int) -> torch.Tensor:
    """[N, T, L] candidates that end inside the utterance and start >= 0."""
    dev = corpus.device
    t_idx = torch.arange(t_len, device=dev)[None, :, None]
    l_idx = torch.arange(1, max_l + 1, device=dev)[None, None, :]
    return (t_idx < corpus.src_len[:, None, None]) & (t_idx - l_idx + 1 >= 0)


def _resegment(seg_cost: torch.Tensor, min_len: int) -> torch.Tensor:
    """The DP over every utterance at once: seg_cost [N, T, L] (cost of the
    segment ending at t with length l+1) -> best_len [N, T] int32, each end
    position's optimal segment length (ties to the shortest)."""
    n, t_len, max_l = seg_cost.shape
    dev = seg_cost.device
    ls = torch.arange(1, max_l + 1, device=dev)
    cost_hist = torch.full((n, t_len + 1), _BIG, dtype=seg_cost.dtype, device=dev)
    cost_hist[:, 0] = 0.0
    best_len = torch.empty((n, t_len), dtype=torch.int32, device=dev)
    for t in range(t_len):
        prev = t + 1 - ls  # segment [prev, t]
        valid = (prev >= 0) & (ls >= min_len)
        prior = torch.where(valid, cost_hist[:, torch.clamp(prev, min=0)], _BIG)
        total = prior + torch.where(valid, seg_cost[:, t], _BIG)
        cost_hist[:, t + 1] = torch.amin(total, dim=1)
        best_len[:, t] = torch.argmin(total, dim=1).to(torch.int32) + 1
    return best_len


def _backtrace(best_len: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """best_len [N, T] -> is_end [N, T]: True where a chosen segment ends,
    walking back from each utterance's last frame."""
    n, t_len = best_len.shape
    cur_end = torch.clamp(length.long() - 1, 0, t_len - 1)
    is_end = torch.empty((n, t_len), dtype=torch.bool, device=best_len.device)
    for t in range(t_len - 1, -1, -1):
        hit = cur_end == t
        l = best_len.gather(1, torch.clamp(cur_end, 0, t_len - 1)[:, None])[:, 0]
        cur_end = torch.where(hit, cur_end - l, cur_end)
        is_end[:, t] = hit
    return is_end


def _segmentation(seg_cost: torch.Tensor, corpus: Corpus, min_len: int):
    """Mask the invalid candidates, re-segment and backtrace -> (masked
    seg_cost, best_len, is_end, chosen length slot [N, T])."""
    n, t_len, max_l = seg_cost.shape
    seg_cost = torch.where(_valid_candidates(corpus, t_len, max_l), seg_cost, _BIG)
    best_len = _resegment(seg_cost, min_len)
    is_end = _backtrace(best_len, corpus.src_len) & corpus.src_mask()
    chosen_l = torch.clamp(best_len.long() - 1, 0, max_l - 1)
    return seg_cost, best_len, is_end, chosen_l


def _take_l(x: torch.Tensor, chosen_l: torch.Tensor) -> torch.Tensor:
    """x [N, T, L, ...] at each (n, t)'s chosen length slot -> [N, T, ...]."""
    idx = chosen_l.reshape(*chosen_l.shape, 1, *([1] * (x.ndim - 3)))
    idx = idx.expand(*chosen_l.shape, 1, *x.shape[3:])
    return torch.gather(x, 2, idx).squeeze(2)


def init(
    corpus: Corpus,
    n_clusters: int = 64,
    n_samples: int = 4,
    max_seg_len: int = 8,
    min_seg_len: int = 1,
    generator: torch.Generator | None = None,
) -> SegKMeansParams:
    """Centroids from distinct candidate segments drawn uniformly among the
    valid ones, from ``generator`` (a CPU generator seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    emb = embed_all_segments(corpus.src, n_samples, max_seg_len)
    n, t_len, max_l, e = emb.shape
    probs = _valid_candidates(corpus, t_len, max_l).reshape(-1).to(torch.float32)
    idx = torch.multinomial(probs.to(generator.device), n_clusters, replacement=False,
                            generator=generator)
    return SegKMeansParams(
        centroids=emb.reshape(-1, e)[idx.to(corpus.device)], n_samples=n_samples,
        max_seg_len=max_seg_len, min_seg_len=min_seg_len,
    )


def expected_counts(
    params: SegKMeansParams, corpus: Corpus
) -> tuple[tuple[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """E-step of one ES-KMeans iteration: re-segment (DP) and re-assign ->
    ((per-cluster embedding sums [K, E], per-cluster counts [K], number of
    segments), -total distortion).  All three statistics are additive
    across corpus shards."""
    emb = embed_all_segments(corpus.src, params.n_samples, params.max_seg_len)
    seg_cost, seg_label = _seg_costs(params, emb)
    seg_cost, _, is_end, chosen_l = _segmentation(seg_cost, corpus, params.min_seg_len)
    chosen_emb = _take_l(emb, chosen_l)  # [N, T, E]
    chosen_label = _take_l(seg_label, chosen_l)  # [N, T]
    k, e = params.centroids.shape
    ends = is_end.reshape(-1)
    lbl = chosen_label.reshape(-1)[ends].long()
    sums = torch.zeros((k, e), dtype=emb.dtype, device=emb.device)
    sums.index_add_(0, lbl, chosen_emb.reshape(-1, e)[ends])
    counts = torch.zeros(k, dtype=emb.dtype, device=emb.device)
    counts.index_add_(0, lbl, torch.ones_like(lbl, dtype=emb.dtype))
    total_cost = torch.sum(torch.where(is_end, _take_l(seg_cost, chosen_l), 0.0))
    # 'loglik' = negative distortion, for uniform monotonicity displays
    return (sums, counts, is_end.sum()), -total_cost


def m_step(
    params: SegKMeansParams, counts: tuple[torch.Tensor, torch.Tensor, torch.Tensor]
) -> SegKMeansParams:
    """Centroid update from the (possibly shard-summed) statistics; empty
    clusters keep their previous centroid."""
    sums, cnt, _ = counts
    new = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt[:, None], min=1),
                      params.centroids)
    return dataclasses.replace(params, centroids=new.to(params.centroids.dtype))


def em_step(
    params: SegKMeansParams, corpus: Corpus
) -> tuple[SegKMeansParams, dict[str, torch.Tensor]]:
    """One ES-KMeans iteration: re-segment (DP) + re-assign + centroid update."""
    counts, ll = expected_counts(params, corpus)
    return m_step(params, counts), {"loglik": ll, "n_segments": counts[2]}


def discover(params, corpus: Corpus) -> tuple[torch.Tensor, torch.Tensor]:
    """Final segmentation and word classes -> (segments [N, T, 3] int32 of
    (start, end_excl, cluster_id + 1), seg_mask [N, T]); cluster ids are
    shifted by one so 0 stays 'not a word unit'."""
    emb = embed_all_segments(corpus.src, params.n_samples, params.max_seg_len)
    seg_cost, seg_label = _seg_costs(params, emb)
    _, best_len, is_end, chosen_l = _segmentation(seg_cost, corpus, params.min_seg_len)
    chosen_label = _take_l(seg_label, chosen_l)
    t_pos = torch.arange(corpus.max_src_len, device=corpus.device)[None, :]
    starts = torch.where(is_end, t_pos - best_len + 1, 0)
    ends = torch.where(is_end, t_pos + 1, 0)
    labels = torch.where(is_end, chosen_label + 1, 0)
    return torch.stack([starts, ends, labels], dim=-1).to(torch.int32), is_end


def train(
    params: SegKMeansParams, corpus: Corpus, num_iterations: int
) -> tuple[SegKMeansParams, torch.Tensor]:
    """``num_iterations`` ES-KMeans iterations -> (params, -distortion per
    iteration, stacked on the device once at the end)."""
    lls = []
    for _ in range(num_iterations):
        params, stats = em_step(params, corpus)
        lls.append(stats["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)


# ---------------------------------------------------------------------------
# GMM softening: the same candidate embeddings and DP re-segmentation, with
# soft responsibilities under spherical Gaussians for the cluster update.
# ---------------------------------------------------------------------------


def init_gmm(
    corpus: Corpus,
    n_clusters: int = 64,
    n_samples: int = 4,
    max_seg_len: int = 8,
    min_seg_len: int = 1,
    generator: torch.Generator | None = None,
) -> SegGMMParams:
    km = init(corpus, n_clusters, n_samples, max_seg_len, min_seg_len, generator)
    return SegGMMParams(
        centroids=km.centroids, log_var=torch.zeros((), device=corpus.device),
        n_samples=n_samples, max_seg_len=max_seg_len, min_seg_len=min_seg_len,
    )


def em_step_gmm(
    params: SegGMMParams, corpus: Corpus
) -> tuple[SegGMMParams, dict[str, torch.Tensor]]:
    """Segmentation by DP on expected (soft-min) costs; soft cluster update."""
    emb = embed_all_segments(corpus.src, params.n_samples, params.max_seg_len)
    e = emb.shape[-1]
    d2 = _sq_dists(emb, params.centroids)  # [N, T, L, K]
    var = torch.exp(params.log_var)
    # segment cost = -log sum_k exp(-d2 / 2 var): soft-min over clusters
    logp = -d2 / (2 * var)
    m = torch.amax(logp, dim=-1)
    seg_cost = -(m + torch.log(torch.sum(torch.exp(logp - m[..., None]), dim=-1) + 1e-38))
    seg_cost, _, is_end, chosen_l = _segmentation(seg_cost, corpus, params.min_seg_len)

    chosen_emb = _take_l(emb, chosen_l)
    resp = torch.softmax(_take_l(logp, chosen_l), dim=-1) * is_end.to(emb.dtype)[..., None]
    sums = torch.einsum("ntk,nte->ke", resp, chosen_emb)
    counts = torch.sum(resp, dim=(0, 1))
    new_centroids = torch.where(counts[:, None] > 1e-6,
                                sums / torch.clamp(counts[:, None], min=1e-6), params.centroids)
    # the shared spherical variance from the soft assignments
    var_new = torch.sum(resp * _take_l(d2, chosen_l)) / torch.clamp(torch.sum(counts) * e,
                                                                     min=1e-6)
    total_cost = torch.sum(torch.where(is_end, _take_l(seg_cost, chosen_l), 0.0))
    new = dataclasses.replace(params, centroids=new_centroids.to(params.centroids.dtype),
                              log_var=torch.log(torch.clamp(var_new, min=1e-6)))
    return new, {"loglik": -total_cost, "n_segments": is_end.sum()}


def discover_gmm(params: SegGMMParams, corpus: Corpus):
    """Hard decode with the GMM's centroids (nearest centroid)."""
    return discover(params, corpus)
