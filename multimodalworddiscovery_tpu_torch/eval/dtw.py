"""Batched DTW on the device.

Counterpart of ``multimodalworddiscovery_tpu/eval/dtw.py``.  The DP runs as
one loop over rows, batched over pairs, with the in-row dependency resolved
by a min-plus prefix scan:

  D[i,j] = c[i,j] + min(D[i-1,j], D[i-1,j-1], D[i,j-1])

With E[j] = min(D[i-1,j], D[i-1,j-1]) and S = cumsum(c[i]), unrolling the
in-row recursion gives D[i,j] = S[j] + cummin_j(E - shift(S)), so each row
is a few vector operations over the batch (``torch.cummin``).  Columns past
a segment's length carry ``_BIG``.

The segment-level scores (``segment_dtw_matrix``, ``cluster_dtw_coherence``,
``dtw_to_gold``) run DTW only on the pairs whose result they keep (both
segments valid; for ``dtw_to_gold``, the same utterance), in chunks of at
most ``PAIR_CHUNK_BYTES`` of frame differences.
"""

from __future__ import annotations

import torch

_BIG = 1e30
PAIR_CHUNK_BYTES = 1 << 28


def _pairwise_cost(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """[B, T1, D] x [B, T2, D] -> [B, T1, T2] frame distances."""
    if metric == "sqeuclidean":
        return torch.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, dim=-1)
    if metric == "euclidean":
        return torch.sqrt(torch.sum((x[:, :, None, :] - y[:, None, :, :]) ** 2, dim=-1) + 1e-12)
    if metric == "cosine":
        xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)
        yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=-1, keepdim=True), min=1e-12)
        return 1.0 - xn @ yn.transpose(1, 2)
    raise ValueError(f"unknown metric {metric!r}")


def _dtw(cost: torch.Tensor, len_x: torch.Tensor, len_y: torch.Tensor) -> torch.Tensor:
    """DTW distances of a batch of padded cost matrices [B, T1, T2] with true
    lengths -> [B], read at (len_x - 1, len_y - 1) (clipped)."""
    b, t1, t2 = cost.shape
    col_ok = torch.arange(t2, device=cost.device)[None, :] < len_y[:, None]
    cost = torch.where(col_ok[:, None, :], cost, _BIG)
    big = torch.full((b, 1), _BIG, dtype=cost.dtype, device=cost.device)
    zero = torch.zeros((b, 1), dtype=cost.dtype, device=cost.device)
    row_x = torch.clamp(len_x - 1, 0, t1 - 1)
    prev = torch.where(col_ok, torch.cumsum(cost[:, 0], dim=1), _BIG)  # D[0, :]
    out = prev
    for i in range(1, t1):
        e = torch.minimum(prev, torch.cat([big, prev[:, :-1]], dim=1))
        s = torch.cumsum(cost[:, i], dim=1)
        s_shift = torch.cat([zero, s[:, :-1]], dim=1)
        prev = s + torch.cummin(e - s_shift, dim=1).values
        out = torch.where((row_x == i)[:, None], prev, out)
    col_y = torch.clamp(len_y - 1, 0, t2 - 1).long()
    return out.gather(1, col_y[:, None])[:, 0]


def dtw_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    len_x: torch.Tensor,
    len_y: torch.Tensor,
    metric: str = "sqeuclidean",
    normalize: bool = False,
) -> torch.Tensor:
    """Batched DTW distances: x [B, T1, D], y [B, T2, D], len_x / len_y [B]
    true lengths -> [B] (optionally normalized by len_x + len_y)."""
    d = _dtw(_pairwise_cost(x, y, metric), len_x, len_y)
    if normalize:
        d = d / torch.clamp(len_x + len_y, min=1).to(d.dtype)
    return d


def _chunk_pairs(fa, fb) -> int:
    """Pairs a chunk may hold: their frame differences within PAIR_CHUNK_BYTES."""
    return max(1, PAIR_CHUNK_BYTES // (4 * fa.shape[1] * fb.shape[1] * max(fa.shape[2], 1)))


def _pairs_dtw(fa, la, fb, lb, ia, ib, metric: str) -> torch.Tensor:
    """Normalized DTW of the pairs (fa[ia[p]], fb[ib[p]]) -> [P], in chunks."""
    chunk = _chunk_pairs(fa, fb)
    out = torch.empty(ia.shape[0], dtype=fa.dtype, device=fa.device)
    for i in range(0, ia.shape[0], chunk):
        a, b = ia[i:i + chunk], ib[i:i + chunk]
        out[i:i + chunk] = dtw_distance(fa[a], fb[b], la[a], lb[b], metric, normalize=True)
    return out


def _all_pairs_dtw(f, lens, metric: str) -> torch.Tensor:
    """Normalized DTW of every ordered pair of segments [M, L, D] -> [M, M],
    a block of rows at a time."""
    m, dev = f.shape[0], f.device
    out = torch.empty((m, m), dtype=f.dtype, device=dev)
    rows = max(1, _chunk_pairs(f, f) // max(m, 1))
    for i in range(0, m, rows):
        r = torch.arange(i, min(i + rows, m), device=dev)
        ia = r.repeat_interleave(m)
        ib = torch.arange(m, device=dev).repeat(len(r))
        out[i:i + len(r)] = _pairs_dtw(f, lens, f, lens, ia, ib, metric).reshape(len(r), m)
    return out


def _extract_segments(
    feats: torch.Tensor, segments: torch.Tensor, seg_mask: torch.Tensor, max_seg_len: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flatten per-utterance segments into a fixed [M, L, D] buffer (M = N * S).

    Returns (seg_feats [M, L, D], lens [M], labels [M], utt [M]); invalid
    slots have len 0 and label -1."""
    n, t, _ = feats.shape
    s = segments.shape[1]
    dev = feats.device
    starts = segments[..., 0].reshape(-1).long()
    ends = segments[..., 1].reshape(-1).long()
    valid = seg_mask.reshape(-1)
    lens = torch.where(valid, torch.clamp(ends - starts, 0, max_seg_len), 0)
    labels = torch.where(valid, segments[..., 2].reshape(-1).long(), -1)
    utt = torch.arange(n, device=dev).repeat_interleave(s)
    idx = torch.clamp(starts[:, None] + torch.arange(max_seg_len, device=dev)[None, :], 0, t - 1)
    return feats[utt[:, None], idx], lens, labels, utt


def segment_dtw_matrix(
    feats: torch.Tensor,
    segments: torch.Tensor,
    seg_mask: torch.Tensor,
    max_seg_len: int = 32,
    metric: str = "sqeuclidean",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pairwise normalized DTW distances between ALL word segments.

    feats [N, T, D]; segments [N, S, 3]; seg_mask [N, S].  Every segment is
    cut to ``max_seg_len`` frames.  Returns (dist [M, M], flat index ->
    (n, s) [M, 2]) for M = N * S; pairs with an invalid segment carry _BIG.
    """
    n, s = segments.shape[:2]
    seg_feats, lens, _, utt = _extract_segments(feats, segments, seg_mask, max_seg_len)
    valid = torch.nonzero(seg_mask.reshape(-1))[:, 0]
    m = n * s
    dist = torch.full((m, m), _BIG, dtype=feats.dtype, device=feats.device)
    dist[valid[:, None], valid[None, :]] = _all_pairs_dtw(seg_feats[valid], lens[valid], metric)
    index = torch.stack([utt, torch.arange(s, device=feats.device).repeat(n)], dim=-1)
    return dist, index


def cluster_dtw_coherence(
    feats: torch.Tensor,
    segments: torch.Tensor,
    seg_mask: torch.Tensor,
    max_seg_len: int = 32,
    metric: str = "sqeuclidean",
) -> dict[str, torch.Tensor]:
    """Within- vs across-cluster mean DTW distance of discovered word units:
    units of the same concept should be closer to each other (within) than
    to units of other concepts (across); ratio < 1 = coherent.  Returns
    {"within", "across", "ratio"}."""
    seg_feats, lens, labels, _ = _extract_segments(feats, segments, seg_mask, max_seg_len)
    valid = torch.nonzero(labels >= 0)[:, 0]
    mv, lab = valid.shape[0], labels[valid]
    dist = _all_pairs_dtw(seg_feats[valid], lens[valid], metric)
    off = ~torch.eye(mv, dtype=torch.bool, device=feats.device)
    same = off & (lab[:, None] == lab[None, :])
    diff = off & (lab[:, None] != lab[None, :])
    d0 = torch.where(dist < _BIG / 2, dist, 0.0)
    within = torch.sum(torch.where(same, d0, 0.0)) / torch.clamp(same.sum(), min=1)
    across = torch.sum(torch.where(diff, d0, 0.0)) / torch.clamp(diff.sum(), min=1)
    return {"within": within, "across": across,
            "ratio": within / torch.clamp(across, min=1e-9)}


def dtw_to_gold(
    feats: torch.Tensor,
    pred_segments: torch.Tensor,
    pred_mask: torch.Tensor,
    gold_segments: torch.Tensor,
    gold_mask: torch.Tensor,
    max_seg_len: int = 32,
    metric: str = "sqeuclidean",
) -> torch.Tensor:
    """Mean (over predicted units) of the normalized DTW distance to the
    CLOSEST gold unit in the same utterance: 0 when every discovered unit
    coincides with a gold word."""
    pf, plen, _, putt = _extract_segments(feats, pred_segments, pred_mask, max_seg_len)
    gf, glen, _, gutt = _extract_segments(feats, gold_segments, gold_mask, max_seg_len)
    ok = (plen[:, None] > 0) & (glen[None, :] > 0) & (putt[:, None] == gutt[None, :])
    ia, ib = torch.nonzero(ok, as_tuple=True)
    cross = torch.full(ok.shape, _BIG, dtype=feats.dtype, device=feats.device)
    cross[ia, ib] = _pairs_dtw(pf, plen, gf, glen, ia, ib, metric)
    best = torch.amin(cross, dim=1)
    has_match = ok.any(dim=1) & (plen > 0)
    return torch.sum(torch.where(has_match, best, 0.0)) / torch.clamp(has_match.sum(), min=1)
