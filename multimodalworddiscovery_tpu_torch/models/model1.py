"""Batched IBM Model-1 / mixture aligner EM.

Counterpart of ``multimodalworddiscovery_tpu/models/model1.py``: EM over
translation probabilities t(phone | concept) with a NULL concept, one batched
call over the whole padded corpus per EM step.

  E-step  Model-1 factorizes over source positions, so it depends on the
          corpus only through the per-utterance phone histograms H [N, V_src]
          and concept multiplicities C [N, V_trg] (``_count_stats``, exact
          counts by ``index_add_``): two float32 products give the expected
          (phone, concept) counts and the loglik.
  M-step  normalize the counts over phones per concept.

The per-position outputs (``posteriors``, ``align``) need the pair
log-probs log t[src_i, e_j] for every (utterance, source position, extended
target slot): that is the emission-table lookup, K1 (``ops/counts``) with
``use_kernels=True`` (None: on a CUDA corpus), the plain gather otherwise.

Target slot j=0 is the NULL concept (concept id 0); j>=1 is the j-th concept
of the paired image.  Keep ``torch.backends.cuda.matmul.allow_tf32`` off:
the E-step's products feed logs.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.counts import table_lookup
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF, masked_logsumexp
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.ops import counts as counts_ops
from multimodalworddiscovery_tpu_torch.ops import kernels_for


@dataclasses.dataclass(frozen=True)
class Model1Params:
    """log t(phone f | concept e): [V_src, V_trg]; column 0 is NULL."""

    log_t: torch.Tensor


def init(corpus: Corpus, dtype=torch.float32) -> Model1Params:
    """Uniform translation table on the corpus's device."""
    if corpus.src.ndim != 2:
        raise ValueError(
            "model1 has DISCRETE emissions (src must be [N, Ts] token ids, "
            f"got src shape {tuple(corpus.src.shape)}); quantize continuous "
            "frames first (frontend.vq) or use hmm_gaussian"
        )
    v_src, v_trg = corpus.src_vocab, corpus.trg_vocab
    log_v = torch.log(torch.tensor(float(v_src), dtype=dtype))
    return Model1Params(log_t=(-log_v).expand(v_src, v_trg).contiguous().to(corpus.device))


def params_from_numpy(log_t, device="cuda") -> Model1Params:
    """Carry a translation table across from a host array (e.g. the JAX
    reference's) onto ``device``."""
    return Model1Params(
        log_t=torch.as_tensor(np.array(log_t, dtype=np.float32), device=device).contiguous()
    )


def _extended_targets(corpus: Corpus) -> tuple[torch.Tensor, torch.Tensor]:
    """Prepend the NULL concept: trg_ext [N, 1+Tt] int32 ids, ext mask [N, 1+Tt]."""
    n, dev = corpus.n, corpus.device
    trg_ext = torch.cat(
        [torch.zeros((n, 1), dtype=torch.int32, device=dev), corpus.trg.to(torch.int32)], dim=1
    )
    ext_mask = torch.cat(
        [torch.ones((n, 1), dtype=torch.bool, device=dev), corpus.trg_mask()], dim=1
    )
    return trg_ext, ext_mask


def _pair_logprobs(
    params: Model1Params, corpus: Corpus, use_kernels: bool | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """log t[src_i, e_j] for every (utterance, src pos, ext trg pos).

    Returns (logp [N, Ts, 1+Tt], joint mask [N, Ts, 1+Tt]).  The gather is
    K1 with ``use_kernels`` (None: on a CUDA corpus), else its plain
    version; every id lies inside the table (padding carries concept 0 /
    phone 0), as K1 needs.
    """
    trg_ext, ext_mask = _extended_targets(corpus)
    gather = counts_ops.table_lookup if kernels_for(use_kernels, corpus.device) else table_lookup
    logp = gather(params.log_t, corpus.src.to(torch.int32).contiguous(), trg_ext)
    mask = corpus.src_mask()[:, :, None] & ext_mask[:, None, :]
    return torch.where(mask, logp, NEG_INF), mask


def posteriors(
    params: Model1Params, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """E-step alignment posteriors gamma [N, Ts, 1+Tt]; rows sum to 1 on valid
    source positions and are all-zero on padding."""
    logp, mask = _pair_logprobs(params, corpus, use_kernels)
    lse = masked_logsumexp(logp, dim=-1, keepdim=True)
    lse = torch.where(lse > NEG_INF / 2, lse, 0.0)
    return torch.where(mask, torch.exp(logp - lse), 0.0)


def _count_stats(
    corpus: Corpus, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Corpus-constant sufficient statistics of Model-1 EM, exact counts.

    H [N, V_src]: per-utterance phone histograms over valid positions;
    C [N, V_trg]: per-utterance concept multiplicities over the EXTENDED
    target (NULL included).  ``train`` computes them once.
    """
    n, dev = corpus.n, corpus.device
    rows = torch.arange(n, device=dev)[:, None]
    v_src, v_trg = corpus.src_vocab, corpus.trg_vocab
    # The scatters add only 0s and 1s: their float sums are exact integers,
    # the same in any order, so the atomics on the card cannot change a bit.
    h = torch.zeros(n * v_src, dtype=dtype, device=dev)
    h.index_add_(0, (rows * v_src + corpus.src.long()).reshape(-1),
                 corpus.src_mask().to(dtype).reshape(-1))
    trg_ext, ext_mask = _extended_targets(corpus)
    c = torch.zeros(n * v_trg, dtype=dtype, device=dev)
    c.index_add_(0, (rows * v_trg + trg_ext.long()).reshape(-1), ext_mask.to(dtype).reshape(-1))
    return h.reshape(n, v_src), c.reshape(n, v_trg)


def _loglik_from(h: torch.Tensor, r_safe: torch.Tensor, corpus: Corpus) -> torch.Tensor:
    prior = -torch.log1p(corpus.trg_len.to(h.dtype))  # log 1/(1+Tt)
    ll = torch.sum(torch.where(h > 0, h * torch.log(r_safe), 0.0))
    return ll + torch.sum(corpus.src_len.to(h.dtype) * prior)


def loglik(params: Model1Params, corpus: Corpus) -> torch.Tensor:
    """Corpus log-likelihood incl. the uniform 1/(1+Tt) alignment prior, in
    ``expected_counts``' sufficient-statistic form."""
    h, c = _count_stats(corpus, dtype=params.log_t.dtype)
    r = c @ torch.exp(params.log_t).T
    return _loglik_from(h, torch.clamp(r, min=1e-38), corpus)


def expected_counts(
    params: Model1Params,
    corpus: Corpus,
    stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """E-step only: expected (phone, concept) counts [V_src, V_trg] + loglik.

        R[n, f]     = sum_e C[n, e] t(f | e)           (per-utterance evidence)
        counts[f,e] = t(f | e) sum_n H[n, f] C[n, e] / R[n, f]
        loglik      = sum_{n, f} H[n, f] log R[n, f] + prior

    Counts are additive across corpus shards.  ``stats`` is ``_count_stats``
    of the corpus, when the caller already has it.
    """
    h, c = _count_stats(corpus, dtype=params.log_t.dtype) if stats is None else stats
    t_exp = torch.exp(params.log_t)  # [F, E]
    r = c @ t_exp.T  # [N, F]
    r_safe = torch.clamp(r, min=1e-38)
    # a phone whose total probability underflows contributes zero counts:
    # h / r_safe alone can overflow float32 to inf and poison the M-step
    a = torch.where(r > 1e-30, h / r_safe, 0.0)  # [N, F]
    counts = t_exp * (a.T @ c)
    return counts, _loglik_from(h, r_safe, corpus)


def m_step(
    params: Model1Params, counts: torch.Tensor, smoothing: float = 1e-8
) -> Model1Params:
    counts = counts + smoothing
    totals = torch.sum(counts, dim=0, keepdim=True)  # over phones, per concept
    return Model1Params(log_t=(torch.log(counts) - torch.log(totals)).to(params.log_t.dtype))


def em_step(
    params: Model1Params,
    corpus: Corpus,
    smoothing: float = 1e-8,
    stats: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[Model1Params, dict[str, torch.Tensor]]:
    """One full EM iteration over the corpus (E + M)."""
    counts, ll = expected_counts(params, corpus, stats)
    return m_step(params, counts, smoothing), {"loglik": ll}


def train(
    params: Model1Params,
    corpus: Corpus,
    num_iterations: int,
    smoothing: float = 1e-8,
) -> tuple[Model1Params, torch.Tensor]:
    """``num_iterations`` EM steps -> (params, logliks [num_iterations]).

    The sufficient statistics are counted once; the logliks stay on the
    device and are stacked once at the end, so the loop never waits on it."""
    stats = _count_stats(corpus, dtype=params.log_t.dtype)
    lls = []
    for _ in range(num_iterations):
        params, out = em_step(params, corpus, smoothing, stats)
        lls.append(out["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)


def align(
    params: Model1Params, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """Decode: argmax_j t(f_i | e_j) per source token -> [N, Ts] int32
    (0 = NULL, j >= 1 = 1-based trg position; padding 0).  The dense
    argmax over the pair log-probs from K1 (``use_kernels``; None: on a
    CUDA corpus), as the reference's production path."""
    return _align_dense(params, corpus, use_kernels)


def _align_dense(
    params: Model1Params, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """argmax over the materialized [N, Ts, 1+Tt] pair log-probs (the first
    slot attaining the maximum)."""
    logp, _ = _pair_logprobs(params, corpus, use_kernels)
    a = torch.argmax(logp, dim=-1).to(torch.int32)
    return torch.where(corpus.src_mask(), a, 0).to(torch.int32)


def _align_concept_space(params: Model1Params, corpus: Corpus) -> torch.Tensor:
    """The same decode in concept-vocabulary space: the maximum of
    log t[src, e] over the utterance's present concepts, then the first
    target slot whose concept attains it (bit-equality against the maximum,
    so tied concept columns resolve as in the dense decode)."""
    rows = params.log_t[corpus.src.long()]  # [N, Ts, E]
    _, c = _count_stats(corpus, dtype=params.log_t.dtype)
    masked = torch.where(c[:, None, :] > 0, rows, NEG_INF)
    m = torch.amax(masked, dim=-1, keepdim=True)
    attains = masked >= m  # [N, Ts, E]
    trg_ext, ext_mask = _extended_targets(corpus)
    n, ts, _ = attains.shape
    idx = trg_ext.long()[:, None, :].expand(n, ts, trg_ext.shape[1])
    hit = torch.gather(attains, 2, idx) & ext_mask[:, None, :]  # [N, Ts, 1+Tt]
    a = torch.argmax(hit.to(torch.uint8), dim=-1).to(torch.int32)
    return torch.where(corpus.src_mask(), a, 0).to(torch.int32)
