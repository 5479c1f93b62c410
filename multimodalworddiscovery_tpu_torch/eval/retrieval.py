"""Cross-modal retrieval: image search / annotation from alignment scores.

Counterpart of ``multimodalworddiscovery_tpu/eval/retrieval.py``.  Every
scorer pairs rows with candidates into one paired corpus a chunk at a time
(as many pairs as ``PAIR_CHUNK_BYTES`` allows) and scores the whole chunk in
one batched call: Model-1's pair log-probs come from K1 (``ops/counts``,
``use_kernels``; None: on a CUDA corpus) with one launch per chunk, the HMM
family's pair logliks from ``hmm_core.forward`` on the chunk.  The full
N x N scores are the pooled scores with every image as a candidate.

direction="c2i" (image search) scores caption i against its candidate
images; "i2c" (image annotation) scores image i against its candidate
captions.  Both rank by the same statistic, p(caption | image's concepts);
only which side the pool re-pairs flips.
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.logsemiring import masked_logsumexp
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import model1
from multimodalworddiscovery_tpu_torch.models.model1 import Model1Params

# Bytes of the largest per-pair tensor one chunk of pairs may build
# (Model-1's [P, Ts, 1+Tt] log-probs; the HMM forward's [Ts, P, S] alphas).
PAIR_CHUNK_BYTES = 1 << 28
# The exact (no-replacement) pool protocol's largest corpus, as the reference.
EXACT_POOL_MAX_N = 16384


def _check_direction(direction: str) -> None:
    if direction not in ("c2i", "i2c"):
        raise ValueError(f"direction must be c2i|i2c, got {direction!r}")


def _paired(corpus: Corpus, rows: torch.Tensor, cand: torch.Tensor, direction: str) -> Corpus:
    """The corpus of (row, candidate) pairs, row-major: [R * C] utterances."""
    c = cand.shape[1]
    rep = rows.repeat_interleave(c)
    flat = cand.reshape(-1)
    src_idx, trg_idx = (rep, flat) if direction == "c2i" else (flat, rep)
    return Corpus(
        src=corpus.src[src_idx], src_len=corpus.src_len[src_idx],
        trg=corpus.trg[trg_idx], trg_len=corpus.trg_len[trg_idx],
        src_vocab=corpus.src_vocab, trg_vocab=corpus.trg_vocab,
    )


def _pooled(score_chunk, corpus: Corpus, candidates: torch.Tensor, direction: str,
            pair_bytes: int) -> torch.Tensor:
    """[N, C] scores: ``score_chunk(paired corpus) -> [R * C]`` over chunks
    of rows, each of at most PAIR_CHUNK_BYTES / ``pair_bytes`` pairs."""
    _check_direction(direction)
    candidates = candidates.to(corpus.device).long()
    n, c = candidates.shape
    out = torch.empty((n, c), dtype=torch.float32, device=corpus.device)
    rows = max(1, PAIR_CHUNK_BYTES // max(1, pair_bytes * c))
    for i in range(0, n, rows):
        r = torch.arange(i, min(i + rows, n), device=corpus.device)
        out[i:i + len(r)] = score_chunk(_paired(corpus, r, candidates[r], direction)).reshape(
            len(r), c)
    return out


def _all_images(n: int, device) -> torch.Tensor:
    """Candidates [N, N]: every image for every caption, in image order."""
    return torch.arange(n, device=device).expand(n, n)


def _model1_pair_scores(params: Model1Params, paired: Corpus,
                        use_kernels: bool | None) -> torch.Tensor:
    """Model-1 loglik of every pair of ``paired`` (its utterances), with the
    uniform 1/(1+Tt) alignment prior; the pair log-probs in one K1 launch."""
    logp, _ = model1._pair_logprobs(params, paired, use_kernels)  # [P, Ts, 1+Tt]
    per_pos = masked_logsumexp(logp, dim=-1)  # [P, Ts]
    ll = torch.sum(torch.where(paired.src_mask(), per_pos, 0.0), dim=1)
    prior = -torch.log1p(paired.trg_len.to(ll.dtype))
    return ll + paired.src_len.to(ll.dtype) * prior


def _model1_pair_bytes(corpus: Corpus) -> int:
    return 4 * corpus.max_src_len * (1 + corpus.max_trg_len)


def retrieval_scores_model1(
    params: Model1Params, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """Model-1 log-likelihood of every (caption i, image j) pair -> [N, N];
    the true pairing is the diagonal."""
    return _pooled(lambda p: _model1_pair_scores(params, p, use_kernels), corpus,
                   _all_images(corpus.n, corpus.device), "c2i", _model1_pair_bytes(corpus))


def retrieval_scores_model1_pooled(
    params: Model1Params, corpus: Corpus, candidates: torch.Tensor,
    direction: str = "c2i", use_kernels: bool | None = None,
) -> torch.Tensor:
    """Model-1 pooled pair logliks -> [N, C] (column 0 the true pairing)."""
    return _pooled(lambda p: _model1_pair_scores(params, p, use_kernels), corpus, candidates,
                   direction, _model1_pair_bytes(corpus))


def _hmm_pair_scores(mod, params, paired: Corpus) -> torch.Tensor:
    from multimodalworddiscovery_tpu_torch.models import hmm_core

    log_init, log_trans, log_emit = mod._machinery(params, paired)
    return hmm_core.forward(log_init, log_trans, log_emit, paired.src_len)[1]


def _hmm_pair_bytes(corpus: Corpus) -> int:
    s = 2 * corpus.max_trg_len
    return 4 * s * (2 * corpus.max_src_len + s)


def retrieval_scores_hmm_family(mod, params, corpus: Corpus) -> torch.Tensor:
    """Forward log-likelihood of every (caption i, image j) pair -> [N, N]
    for any Vogel-HMM aligner module (hmm / hmm_gaussian / hmm_dnn / hmm_crf:
    anything exposing ``_machinery``).  O(N^2) forwards: for
    evaluation-sized corpora."""
    return _pooled(lambda p: _hmm_pair_scores(mod, params, p), corpus,
                   _all_images(corpus.n, corpus.device), "c2i", _hmm_pair_bytes(corpus))


def retrieval_scores_hmm(params, corpus: Corpus) -> torch.Tensor:
    """Discrete-HMM pair logliks (see retrieval_scores_hmm_family)."""
    from multimodalworddiscovery_tpu_torch.models import hmm

    return retrieval_scores_hmm_family(hmm, params, corpus)


def retrieval_scores_hmm_family_pooled(
    mod, params, corpus: Corpus, candidates: torch.Tensor, direction: str = "c2i",
) -> torch.Tensor:
    """Pooled forward logliks for any Vogel-HMM module -> [N, C]."""
    return _pooled(lambda p: _hmm_pair_scores(mod, params, p), corpus, candidates, direction,
                   _hmm_pair_bytes(corpus))


def retrieval_scores_hmm_pooled(
    params, corpus: Corpus, candidates: torch.Tensor
) -> torch.Tensor:
    """Discrete-HMM forward loglik of caption i vs its candidate images -> [N, C]."""
    from multimodalworddiscovery_tpu_torch.models import hmm

    return retrieval_scores_hmm_family_pooled(hmm, params, corpus, candidates, "c2i")


def sample_candidate_pools(
    n: int, pool_size: int, generator: torch.Generator | None = None, device="cuda",
) -> torch.Tensor:
    """[N, C] int64 candidate image indices per caption on ``device``; column
    0 is the true image.

    Up to EXACT_POOL_MAX_N rows each pool's distractors are distinct (the
    first C-1 of a uniform random order of the other N-1 images: the top
    C-1 of N-1 uniform keys); above it they are iid draws, whose expected
    duplicates per pool, ~C^2 / 2N, are negligible there.  The draws come
    from ``generator`` (a CPU generator seeded 0 when None) on its device.
    """
    if pool_size > n:
        raise ValueError(f"pool_size {pool_size} > corpus size {n}")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    gdev = generator.device
    true = torch.arange(n, device=gdev)[:, None]
    if n <= EXACT_POOL_MAX_N:
        rows = max(1, (1 << 24) // max(1, n - 1))
        draws = torch.cat([
            torch.rand((min(rows, n - i), n - 1), generator=generator, device=gdev)
            .topk(pool_size - 1, dim=1).indices
            for i in range(0, n, rows)
        ])
    else:
        draws = torch.randint(0, n - 1, (n, pool_size - 1), generator=generator, device=gdev)
    draws = torch.where(draws >= true, draws + 1, draws)  # never the true image
    return torch.cat([true, draws], dim=1).to(device)


def ranks_from_pooled(pool_scores: torch.Tensor) -> torch.Tensor:
    """[N, C] pooled scores (column 0 = the true pairing) -> [N] ranks: the
    number of distractors scoring strictly higher.  Recall@k and the median
    rank are functions of the concatenated rank vector."""
    return torch.sum(pool_scores[:, 1:] > pool_scores[:, :1], dim=1)


def _share(hits: torch.Tensor) -> torch.Tensor:
    """Mean of a boolean vector in float32, as XLA computes a mean: the
    count times the float32 reciprocal of the length."""
    return torch.sum(hits, dtype=torch.float32) * (1.0 / hits.numel())


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values of an even count."""
    v = torch.sort(x.to(torch.float32).reshape(-1)).values
    k = v.numel()
    if k == 0:
        return torch.tensor(float("nan"), device=x.device)
    return (v[(k - 1) // 2] + v[k // 2]) / 2


def recall_from_ranks(
    ranks, pool_size: int, ks: tuple[int, ...] = (1, 5, 10), direction: str = "c2i",
) -> dict[str, torch.Tensor]:
    """Recall@k and the median rank from a 1-D rank vector."""
    ranks = torch.as_tensor(ranks)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        out[f"recall@{k}_{direction}"] = _share(ranks < k)
    out[f"median_rank_{direction}"] = _median(ranks + 1)
    out["pool_size"] = torch.tensor(float(pool_size))
    return out


def recall_at_k_pooled(
    pool_scores: torch.Tensor, ks: tuple[int, ...] = (1, 5, 10), direction: str = "c2i",
) -> dict[str, torch.Tensor]:
    """Recall@k from [N, C] pooled scores (column 0 = the true pairing)."""
    return recall_from_ranks(ranks_from_pooled(pool_scores), pool_scores.shape[1], ks,
                             direction)


def dense_candidate_pools(n: int, device="cuda") -> torch.Tensor:
    """[N, N] exhaustive pools: row i = [i, i+1, ..., i-1] (mod n), every
    other row a distractor, the true pairing in column 0."""
    i = torch.arange(n, device=device)
    return (i[:, None] + i[None, :]) % n


def recall_at_k(scores: torch.Tensor, ks: tuple[int, ...] = (1, 5, 10)) -> dict[str, torch.Tensor]:
    """Recall@k both directions from an [N, N] score matrix (diagonal =
    true): caption->image ranks images per caption (rows), image->caption
    ranks captions per image (columns)."""
    diag = torch.diagonal(scores)
    rank_c2i = torch.sum(scores > diag[:, None], dim=1)
    rank_i2c = torch.sum(scores > diag[None, :], dim=0)
    out: dict[str, torch.Tensor] = {}
    for k in ks:
        out[f"recall@{k}_c2i"] = _share(rank_c2i < k)
        out[f"recall@{k}_i2c"] = _share(rank_i2c < k)
    out["median_rank_c2i"] = _median(rank_c2i + 1)
    out["median_rank_i2c"] = _median(rank_i2c + 1)
    return out
