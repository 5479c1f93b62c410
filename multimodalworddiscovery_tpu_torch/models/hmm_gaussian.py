"""Gaussian / GMM-emission HMM aligner: continuous acoustic frames.

Counterpart of ``multimodalworddiscovery_tpu/models/hmm_gaussian.py``: the
resident aligner and, at the end, its streaming half (the reservoir
codebook, the quantized code shards and the out-of-core VQ teacher over
``data/stream`` shards).  Same Vogel alignment skeleton as the discrete HMM, with emissions that are
per-concept diagonal Gaussian mixtures over frames (``n_components=1`` is
the single-Gaussian model).

All (concept, component) log-densities come from two matrix products over
the flattened [C*K, D] parameter matrices,

  log N(x | mu, diag(var)) = x @ (mu/var).T - x^2 @ (.5/var).T + const,

then a logsumexp over components with the mixture weights.  The M-step's
sufficient statistics are the transposed products of the combined (HMM
gamma x component responsibility) posteriors.  These products are plain
float32 matmuls (the reference leaves them to XLA); the E-step itself runs
through K4 and decode through K3 with ``use_kernels=True``, the default
(None) on a CUDA corpus.  Keep
``torch.backends.cuda.matmul.allow_tf32`` off (its default): the products
feed logs and exps.

Random draws (initial jitter, the k-means seed frames) come from a
``torch.Generator`` on the CPU and are then moved to the corpus's device,
so one seed gives the same draws on every machine.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
from pathlib import Path

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.counts import pool_columns, segment_sum, select_columns
from multimodalworddiscovery_tpu_torch.core.logsemiring import masked_logsumexp
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import hmm as dhmm
from multimodalworddiscovery_tpu_torch.models import hmm_core
from multimodalworddiscovery_tpu_torch.ops import kernels_for
from multimodalworddiscovery_tpu_torch.utils.profiling import span

_LOG_2PI = 1.8378770664093453


@dataclasses.dataclass(frozen=True)
class GaussianHMMParams:
    """Diagonal-GMM emissions per concept + Vogel transitions.

    means/log_vars: [C, K, D]; log_mix: [C, K] (log mixture weights);
    log_jump [2*max_jump+1]; log_p0 scalar.
    """

    means: torch.Tensor
    log_vars: torch.Tensor
    log_mix: torch.Tensor
    log_jump: torch.Tensor
    log_p0: torch.Tensor
    max_jump: int = 3


def params_from_numpy(
    means, log_vars, log_mix, log_jump, log_p0, max_jump: int = 3, device="cuda"
) -> GaussianHMMParams:
    """Carry parameters across from host arrays (e.g. the JAX reference's)
    onto ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return GaussianHMMParams(
        means=t(means), log_vars=t(log_vars), log_mix=t(log_mix),
        log_jump=t(log_jump), log_p0=t(log_p0).reshape(()), max_jump=int(max_jump),
    )


def _generator(generator: torch.Generator | None) -> torch.Generator:
    return generator if generator is not None else torch.Generator().manual_seed(0)


def _randn(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard normals drawn on the CPU, then moved to ``device``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32).to(device)


def _take(corpus: Corpus, sl: slice) -> Corpus:
    """Utterances ``sl`` of a corpus."""
    return dataclasses.replace(
        corpus, src=corpus.src[sl], src_len=corpus.src_len[sl],
        trg=corpus.trg[sl], trg_len=corpus.trg_len[sl],
    )


def feature_shift(corpus: Corpus) -> torch.Tensor:
    """Masked per-dim feature mean [D]: the shift point for ``init_moments``'
    squared sums (any value close to the corpus mean keeps them stable)."""
    mask = corpus.src_mask()[..., None]
    xm = torch.where(mask, corpus.src, 0.0)
    return xm.sum(dim=(0, 1)) / torch.clamp(mask.sum().float(), min=1.0)


def init_moments(
    corpus: Corpus, shift: torch.Tensor | float = 0.0, with_diagonal: bool = True
) -> dict[str, torch.Tensor]:
    """Seeding statistics, additive across corpus shards:

      fsum [D], fcnt []      raw feature sums / frame count
      fsq [D]                sum of (x - shift)^2 (pass ``feature_shift``:
                             a one-pass E[x^2] - mean^2 cancels in float32)
      csum [E, D], ccnt [E]  per-concept sums under the uniform DIAGONAL
                             alignment (slot j = floor(t * Tt / Ts)), the
                             flat-start evidence of ``init_diagonal``; zeros
                             when ``with_diagonal=False``.
    """
    x = corpus.src  # [N, Ts, D]
    tmask = corpus.src_mask()
    mask = tmask[..., None]
    xm = torch.where(mask, x, 0.0)
    xc = torch.where(mask, x - shift, 0.0)
    d = x.shape[-1]
    e = corpus.trg_vocab
    if with_diagonal:
        t_idx = torch.arange(corpus.max_src_len, device=x.device)[None, :]
        slen = torch.clamp(corpus.src_len[:, None].long(), min=1)
        tlen = corpus.trg_len[:, None].long()
        slot = (t_idx * tlen) // slen
        slot = torch.minimum(torch.clamp(slot, min=0), torch.clamp(tlen - 1, min=0))
        concept = corpus.trg.long().gather(1, slot).reshape(-1)  # [N*Ts]
        w = tmask.reshape(-1).float()
        csum = segment_sum(xm.reshape(-1, d), concept, e)
        ccnt = segment_sum(w, concept, e)
    else:
        csum = torch.zeros((e, d), device=x.device)
        ccnt = torch.zeros((e,), device=x.device)
    return {
        "fsum": xm.sum(dim=(0, 1)),
        "fsq": (xc * xc).sum(dim=(0, 1)),
        "fcnt": mask.sum().float(),
        "csum": csum,
        "ccnt": ccnt,
    }


def init_from_moments(
    moments: dict[str, torch.Tensor],
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
    mode: str = "global",
    shift: torch.Tensor | float = 0.0,
) -> GaussianHMMParams:
    """Build params from (possibly shard-summed) ``init_moments``.

    ``shift`` must be the value the moments were taken with.  mode="global"
    is ``init`` (corpus mean + jitter), mode="diagonal" is
    ``init_diagonal`` (per-concept diagonal flat-start means; concepts the
    diagonal never sees keep the jittered global mean)."""
    if mode not in ("global", "diagonal"):
        raise ValueError(f"mode must be global|diagonal, got {mode!r}")
    gen = _generator(generator)
    v_trg, d = moments["csum"].shape
    dev = moments["csum"].device
    total = torch.clamp(moments["fcnt"], min=1.0)
    mean = moments["fsum"] / total
    var = torch.clamp(moments["fsq"] / total - (mean - shift) ** 2, min=0.0)
    sd = torch.sqrt(var)
    # 0.1x concept jitter (K=1-stable); extra spread only across components
    jitter = 0.1 * sd * _randn(gen, (v_trg, 1, d), dev)
    if n_components > 1:
        jitter = jitter + 0.3 * sd * _randn(gen, (v_trg, n_components, d), dev)
    else:
        jitter = jitter.expand(v_trg, n_components, d)
    w = 2 * max_jump + 1
    f32 = dict(dtype=torch.float32, device=dev)
    means = mean[None, None, :] + jitter
    if mode == "diagonal":
        seen = moments["ccnt"] > 0
        cmean = moments["csum"] / torch.clamp(moments["ccnt"], min=1.0)[:, None]
        means = torch.where(seen[:, None, None], cmean[:, None, :], means)
        if n_components > 1:
            means = means + 0.3 * sd * _randn(gen, (v_trg, n_components, d), dev)
    return GaussianHMMParams(
        means=means.contiguous(),
        log_vars=torch.log(var + 1e-6).expand(v_trg, n_components, d).contiguous(),
        log_mix=torch.full((v_trg, n_components), -math.log(n_components), **f32),
        log_jump=-0.5 * torch.abs(torch.arange(w, **f32) - max_jump - 1),
        log_p0=torch.log(torch.tensor(0.2, **f32)),
        max_jump=max_jump,
    )


def init(
    corpus: Corpus,
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
) -> GaussianHMMParams:
    """Means = corpus mean + per-(concept, component) jitter, vars = corpus var."""
    shift = feature_shift(corpus)
    return init_from_moments(
        init_moments(corpus, shift, with_diagonal=False), max_jump=max_jump,
        n_components=n_components, generator=generator, mode="global", shift=shift,
    )


def init_diagonal(
    corpus: Corpus,
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
) -> GaussianHMMParams:
    """Flat start from the uniform DIAGONAL alignment: each concept's mean
    comes from the frames the diagonal segmentation (slot j = floor(t*Tt/Ts))
    assigns to it, which breaks the concept symmetry of ``init`` with corpus
    evidence."""
    shift = feature_shift(corpus)
    return init_from_moments(
        init_moments(corpus, shift), max_jump=max_jump,
        n_components=n_components, generator=generator, mode="diagonal", shift=shift,
    )


def _component_logdensity(params: GaussianHMMParams, corpus: Corpus) -> torch.Tensor:
    """[N, Ts, C, K] per-component log-densities via two matmuls (computed
    in place on the first product's output to hold one [N, Ts, C*K] buffer)."""
    x = corpus.src  # [N, Ts, D]
    c, k, d = params.means.shape
    means = params.means.reshape(c * k, d)
    log_vars = params.log_vars.reshape(c * k, d)
    inv_var = torch.exp(-log_vars)
    const = -0.5 * (
        log_vars.sum(dim=-1) + (means**2 * inv_var).sum(dim=-1) + d * _LOG_2PI
    )  # [C*K]
    out = x @ (means * inv_var).T
    out -= (x * x) @ (0.5 * inv_var).T
    out += const
    return out.reshape(*x.shape[:2], c, k)


def _mixture(comp: torch.Tensor, params: GaussianHMMParams) -> torch.Tensor:
    """[N, Ts, C] logsumexp_k(log w_ck + comp[..., k])."""
    logw = torch.log_softmax(params.log_mix, dim=-1)
    return masked_logsumexp(comp + logw, dim=-1)


def _concept_logdensity(params: GaussianHMMParams, corpus: Corpus) -> torch.Tensor:
    """[N, Ts, C] log p(x_t | concept c)."""
    return _mixture(_component_logdensity(params, corpus), params)


def _log_emissions(params: GaussianHMMParams, corpus: Corpus) -> torch.Tensor:
    """[N, Ts, S] state emission log-probs (each state's concept column)."""
    return select_columns(
        _concept_logdensity(params, corpus), hmm_core.state_concepts(corpus)
    )


def _machinery(params: GaussianHMMParams, corpus: Corpus):
    log_trans = hmm_core.build_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return log_init, log_trans, _log_emissions(params, corpus)


def loglik(params: GaussianHMMParams, corpus: Corpus) -> torch.Tensor:
    log_init, log_trans, log_emit = _machinery(params, corpus)
    _, logz = hmm_core.forward(log_init, log_trans, log_emit, corpus.src_len)
    return logz.sum()


def _sufficient_stats(
    params: GaussianHMMParams,
    corpus: Corpus,
    comp: torch.Tensor,   # [N, Ts, C, K] component log-densities
    r: torch.Tensor,      # [N, Ts, C] concept responsibilities
    width: torch.Tensor,  # [W+2] jump-width counts, passed through
) -> dict[str, torch.Tensor]:
    """M-step statistics from concept responsibilities and the component
    responsibilities within each concept."""
    logw = torch.log_softmax(params.log_mix, dim=-1)
    comb = r[..., None] * torch.softmax(comp + logw, dim=-1)  # [N, Ts, C, K]
    c, k = params.log_mix.shape
    x = corpus.src
    d = x.shape[-1]
    comb2 = comb.reshape(-1, c * k)
    xf = x.reshape(-1, d)
    w_feat = corpus.src_mask().to(x.dtype)[..., None]
    return {
        "c0": comb.sum(dim=(0, 1)),
        "c1": (comb2.T @ xf).reshape(c, k, d),
        "c2": (comb2.T @ (xf * xf)).reshape(c, k, d),
        "width": width,
        "fsum": (x * w_feat).sum(dim=(0, 1)),
        "fsq": (x * x * w_feat).sum(dim=(0, 1)),
        "fcnt": w_feat.sum(),
    }


def expected_counts(
    params: GaussianHMMParams,
    corpus: Corpus,
    use_kernels: bool | None = None,
    emit_scale: float = 1.0,
    dot_dtype: str = "float32",
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """E-step sufficient statistics, all additive across corpus shards:

      c0 [C,K], c1/c2 [C,K,D]   combined (gamma x responsibility) moments
      width [W+2]               expected jump counts
      fsum/fsq [D], fcnt []     global feature moments (for the var floor)

    ``use_kernels=True`` runs the forward-backward through K4 (None: on a
    CUDA corpus), in ``dot_dtype`` ("bfloat16": K4-bf16).
    ``emit_scale`` < 1 is a deterministic-annealing E-step: the emission
    log-likelihoods are scaled by beta (``train``'s ``anneal`` ramps it).
    """
    comp = _component_logdensity(params, corpus)  # [N, Ts, C, K]
    with span("mwd.gauss.mixture"):
        log_emit = select_columns(_mixture(comp, params), hmm_core.state_concepts(corpus))
        if emit_scale != 1.0:
            log_emit = log_emit * emit_scale
    gamma, width_counts, logz = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump, log_emit, corpus,
        use_kernels=use_kernels, dot_dtype=dot_dtype,
    )
    r = teacher_responsibilities(gamma, corpus)
    with span("mwd.gauss.stats"):
        stats = _sufficient_stats(params, corpus, comp, r, width_counts)
    return stats, logz.sum()


def m_step(
    params: GaussianHMMParams,
    counts: dict[str, torch.Tensor],
    smoothing: float = 1e-6,
    var_floor: float = 1e-4,
    var_floor_rel: float = 1e-3,
) -> GaussianHMMParams:
    """Variances are floored at max(var_floor, var_floor_rel * global
    feature variance) per dimension, so near-noiseless data cannot collapse
    a component onto single frames."""
    with span("mwd.gauss.m_step"):
        c0 = counts["c0"] + smoothing
        new_means = counts["c1"] / c0[..., None]
        tot = torch.clamp(counts["fcnt"], min=1.0)
        gmean = counts["fsum"] / tot
        gvar = counts["fsq"] / tot - gmean**2  # [D]
        floor = torch.clamp(var_floor_rel * gvar, min=var_floor)[None, None, :]
        new_vars = torch.maximum(counts["c2"] / c0[..., None] - new_means**2, floor)
        new_log_mix = torch.log(c0) - torch.log(c0.sum(dim=-1, keepdim=True))
        width_counts = counts["width"]
        w = 2 * params.max_jump + 1
        return GaussianHMMParams(
            means=new_means,
            log_vars=torch.log(new_vars),
            log_mix=new_log_mix,
            log_jump=torch.log(width_counts[:w] + smoothing),
            log_p0=torch.log(width_counts[w] + smoothing),
            max_jump=params.max_jump,
        )


def em_step(
    params: GaussianHMMParams,
    corpus: Corpus,
    smoothing: float = 1e-6,
    var_floor: float = 1e-4,
    var_floor_rel: float = 1e-3,
    use_kernels: bool | None = None,
    emit_scale: float = 1.0,
    dot_dtype: str = "float32",
) -> tuple[GaussianHMMParams, dict[str, torch.Tensor]]:
    """One EM iteration (expected_counts + m_step)."""
    counts, ll = expected_counts(
        params, corpus, use_kernels=use_kernels, emit_scale=emit_scale,
        dot_dtype=dot_dtype,
    )
    return m_step(params, counts, smoothing, var_floor, var_floor_rel), {"loglik": ll}


def anneal_scales(
    num_iterations: int, anneal: tuple[float, int] | None = None
) -> list[float]:
    """Emission temperature per iteration: 1 throughout, or with
    ``anneal=(beta0, n_ramp)`` a linear ramp beta0 -> 1 over the first
    n_ramp iterations, then 1."""
    if anneal is None:
        return [1.0] * num_iterations
    beta0, n_ramp = anneal
    ramp = np.linspace(beta0, 1.0, max(n_ramp, 1)).astype(np.float32)
    ones = np.ones(max(num_iterations - n_ramp, 0), np.float32)
    return [float(v) for v in np.concatenate([ramp, ones])[:num_iterations]]


def train(
    params: GaussianHMMParams,
    corpus: Corpus,
    num_iterations: int,
    use_kernels: bool | None = None,
    anneal: tuple[float, int] | None = None,
    dot_dtype: str = "float32",
) -> tuple[GaussianHMMParams, torch.Tensor]:
    """``num_iterations`` EM steps -> (params, per-iteration logliks).
    ``anneal=(beta0, n_ramp)`` runs deterministic annealing (``anneal_scales``).
    The logliks stay on the device and are stacked once at the end."""
    lls = []
    for scale in anneal_scales(num_iterations, anneal):
        params, stats = em_step(params, corpus, use_kernels=use_kernels, emit_scale=scale,
                                dot_dtype=dot_dtype)
        lls.append(stats["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)


def align(
    params: GaussianHMMParams, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """Viterbi decode -> [N, Ts] int32 alignment (0 = NULL, else 1-based
    trg position), through K3 with ``use_kernels=True`` (None: on a CUDA
    corpus)."""
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    path = hmm_core.viterbi_factored(
        log_init, base, rowz, colmask, _log_emissions(params, corpus),
        corpus.src_len, use_kernels=use_kernels,
    )
    return hmm_core.path_to_alignment(path, corpus)


def posteriors(
    params: GaussianHMMParams, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """State posteriors [N, Ts, S]: with ``use_kernels=True`` (None: on a
    CUDA corpus) K4's gamma (``hmm_core.estep``), else the plain
    forward-backward, as in the reference."""
    log_emit = _log_emissions(params, corpus)
    if kernels_for(use_kernels, corpus.device):
        return hmm_core.estep(params.log_jump, params.log_p0, params.max_jump, log_emit,
                              corpus, use_kernels=True)[0]
    log_trans = hmm_core.build_log_trans(params.log_jump, params.log_p0, corpus,
                                         params.max_jump)
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return hmm_core.posteriors_from(log_init, log_trans, log_emit, corpus)


def counts_from_responsibilities(
    params: GaussianHMMParams,
    corpus: Corpus,
    r: torch.Tensor,      # [N, Ts, C] concept responsibilities (masked frames 0)
    width: torch.Tensor,  # [2*max_jump+3] jump-width counts to pass through
) -> dict[str, torch.Tensor]:
    """``expected_counts``-shaped statistics with an EXTERNAL concept
    responsibility (gold one-hots, a discrete teacher's posteriors, ...);
    component responsibilities still come from ``params``."""
    return _sufficient_stats(
        params, corpus, _component_logdensity(params, corpus), r, width
    )


def supervised_counts(
    params: GaussianHMMParams, corpus: Corpus, gold_alignment: torch.Tensor
) -> dict[str, torch.Tensor]:
    """Oracle-assignment statistics: the state posterior is replaced by the
    GOLD frame alignment [N, Ts] (0 = NULL, else 1-based target position;
    NULL frames feed the NULL concept).  Jump widths are measured from the
    last REAL position, since a NULL state holds its predecessor's
    underlying position (hmm_core.jump_width_ids)."""
    a = gold_alignment.long()
    tmask = corpus.src_mask()
    pos = torch.clamp(a - 1, 0, corpus.max_trg_len - 1)
    conc = corpus.trg.long().gather(1, pos)
    conc = torch.where(a > 0, conc, 0)
    r = torch.nn.functional.one_hot(conc, corpus.trg_vocab).to(params.means.dtype)
    r = r * tmask[..., None]  # [N, Ts, C]

    both = tmask[:, 1:] & tmask[:, :-1]
    mj = params.max_jump
    w = 2 * mj + 1
    tpos = torch.arange(a.shape[1], device=a.device)[None, :]
    seen = torch.cummax(torch.where(a > 0, tpos, -1), dim=1).values
    last_real = a.gather(1, torch.clamp(seen, min=0))
    from_pos = last_real[:, :-1]
    has_from = seen[:, :-1] >= 0  # leading NULL runs have no source position
    w_id = torch.clamp(a[:, 1:] - from_pos, -mj, mj) + mj
    w_id = torch.where(
        both & (a[:, 1:] > 0),
        torch.where(has_from, w_id, w + 1),
        torch.where(both & (a[:, 1:] == 0), w, w + 1),
    )
    width = segment_sum(both.reshape(-1).to(params.means.dtype), w_id.reshape(-1), w + 2)
    return counts_from_responsibilities(params, corpus, r, width)


def supervised_fit(
    params: GaussianHMMParams,
    corpus: Corpus,
    gold_alignment: torch.Tensor,
    num_iterations: int = 5,
) -> GaussianHMMParams:
    """Supervised GMM fit from gold alignments (the oracle ceiling model)."""
    for _ in range(num_iterations):
        params = m_step(params, supervised_counts(params, corpus, gold_alignment))
    return params


def teacher_responsibilities(teacher_gamma: torch.Tensor, corpus: Corpus) -> torch.Tensor:
    """Pool state posteriors [N, Ts, S] onto concept responsibilities
    [N, Ts, C] (the sum over each concept's states, ``pool_columns``)."""
    return pool_columns(teacher_gamma, hmm_core.state_concepts(corpus), corpus.trg_vocab)


def _kmeans_assign(cb: torch.Tensor, fl: torch.Tensor) -> torch.Tensor:
    """argmin_m ||x - c_m||^2 == argmin_m (|c_m|^2 - 2 x.c_m): one matmul."""
    score = -2.0 * (fl @ cb.T) + (cb**2).sum(dim=-1)[None, :]
    return torch.argmin(score, dim=-1)


def _kmeans_fit(
    cb0: torch.Tensor, flat: torch.Tensor, wflat: torch.Tensor, num_iterations: int
) -> torch.Tensor:
    """Lloyd's sweeps over [NT, D] frames weighted by ``wflat`` (0 on
    padding), from the initial codebook ``cb0`` -> fitted codebook.  Empty
    codes keep their old centroid."""
    cb = cb0
    n_codes, d = cb0.shape
    for _ in range(num_iterations):
        a = _kmeans_assign(cb, flat)
        stats = segment_sum(torch.cat([flat * wflat[:, None], wflat[:, None]], dim=1), a,
                            n_codes)
        sums, cnt = stats[:, :d], stats[:, d]
        cb = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None], cb)
    return cb


def fit_frame_codebook(
    corpus: Corpus,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
) -> torch.Tensor:
    """The resident codebook fit (shared by ``quantize_frames`` and
    ``frontend.vq.fit_codebook``): Lloyd's sweeps over the masked frames,
    started from n_codes distinct REAL frames drawn on the CPU generator.
    Refuses corpora with fewer real frames than codes."""
    x = corpus.src
    flat = x.reshape(-1, x.shape[-1])
    wflat = corpus.src_mask().reshape(-1).float()
    n_real = int(wflat.sum())
    if n_real < n_codes:
        raise ValueError(f"corpus has only {n_real} real frames < {n_codes} codes")
    p = wflat.cpu().double()
    idx0 = torch.multinomial(p / p.sum(), n_codes, replacement=False,
                             generator=_generator(generator))
    return _kmeans_fit(flat[idx0.to(flat.device)], flat, wflat, num_iterations)


def quantize_frames(
    corpus: Corpus,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
) -> Corpus:
    """Vector-quantize the frame corpus: fit a codebook
    (``fit_frame_codebook``), then replace each frame with its code id.
    Returns the DISCRETE corpus (``src`` = int32 code ids, ``src_vocab`` =
    n_codes; targets and lengths unchanged)."""
    cb = fit_frame_codebook(corpus, n_codes, num_iterations, generator)
    x = corpus.src
    codes = _kmeans_assign(cb, x.reshape(-1, x.shape[-1]))
    return dataclasses.replace(
        corpus, src=codes.reshape(x.shape[:2]).to(torch.int32), src_vocab=n_codes
    )


def init_vq_teacher(
    corpus: Corpus,
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
    *,
    n_codes: int = 64,
    teacher_iters: int = 10,
    seed_rounds: int = 3,
    use_kernels: bool | None = None,
    chunks: int = 1,
) -> GaussianHMMParams:
    """Seed the Gaussian HMM from a VQ + discrete-HMM teacher:

      1. ``quantize_frames``: k-means codebook over frames -> code corpus;
      2. discrete-HMM EM on the code sequences (``models.hmm``; through K1
         and K2 with ``use_kernels=True``);
      3. ``seed_rounds`` rounds of (teacher-posterior responsibility counts
         -> ``m_step``), the Gaussian emissions fit against the teacher's
         concept posteriors (through K1 and K4 with ``use_kernels=True``);
      4. the teacher's transitions (log_jump / log_p0) are copied over.

    Follow with annealed EM (``train(anneal=...)``).  ``chunks`` > 1 bounds
    the seeding's activation memory (per-chunk posteriors, additive counts).
    The generator draws the initial jitter first, then the codebook's seed
    frames.
    """
    gen = _generator(generator)
    base = init(corpus, max_jump=max_jump, n_components=n_components, generator=gen)
    code_corpus = quantize_frames(corpus, n_codes=n_codes, generator=gen)
    tp, _ = dhmm.train(
        dhmm.init(code_corpus, max_jump=max_jump), code_corpus, teacher_iters,
        use_kernels=use_kernels,
    )
    return seed_from_teacher(
        base, corpus, code_corpus, tp, seed_rounds=seed_rounds, chunks=chunks,
        use_kernels=use_kernels,
    )


def seed_from_teacher(
    base: GaussianHMMParams,
    corpus: Corpus,
    code_corpus: Corpus,
    teacher: dhmm.HMMParams,
    seed_rounds: int = 3,
    chunks: int = 1,
    use_kernels: bool | None = None,
) -> GaussianHMMParams:
    """Fit the Gaussian emissions against a discrete-HMM ``teacher``'s
    concept posteriors over ``code_corpus`` (``seed_rounds`` rounds of
    pinned-assignment GMM EM; the posteriors through K1 and K4 with
    ``use_kernels``, None: on a CUDA corpus), then copy the teacher's
    transitions."""
    nchunk = max(int(chunks), 1)
    csz = -(-corpus.n // nchunk)
    zero_w = torch.zeros(2 * base.max_jump + 3, device=base.means.device)
    gp = base
    for _ in range(max(int(seed_rounds), 1)):
        total = None
        for i in range(nchunk):
            sl = slice(i * csz, (i + 1) * csz)
            sub_fc, sub_cc = _take(corpus, sl), _take(code_corpus, sl)
            gamma = dhmm.posteriors(teacher, sub_cc, use_kernels=use_kernels)
            r = teacher_responsibilities(gamma, sub_fc)
            cts = counts_from_responsibilities(gp, sub_fc, r, zero_w)
            total = cts if total is None else {k: total[k] + v for k, v in cts.items()}
        gp = m_step(gp, total)
    return dataclasses.replace(gp, log_jump=teacher.log_jump, log_p0=teacher.log_p0)


# ---------------------------------------------------------------------------
# The streaming half: the codebook, the quantized code shards and the VQ
# teacher over a ``data.stream.ShardedCorpusReader`` corpus, no resident
# corpus anywhere.
# ---------------------------------------------------------------------------


def _reservoir_frames(
    reader, n_sample: int, seed: int = 0, shards=None, return_keys: bool = False
):
    """Uniform sample of up to ``n_sample`` masked frames across the shards
    of a ``ShardedCorpusReader`` corpus, without the frame matrix: every
    frame gets an iid uniform sort key and the ``n_sample`` smallest keys
    win (exactly uniform, one pass, O(n_sample + shard) host memory).

    The keys of shard k come from ``np.random.default_rng([seed, k])`` and
    the result is in ascending-key order, so the sample is a function of
    (shards, seed) alone, the JAX package's numbers bit for bit, and
    partial reservoirs over shard subsets merge by key.  ``shards``: the
    shard indices to scan (default: all).  Returns a [M, D] float32 numpy
    array, M <= n_sample (and the [M] keys with ``return_keys``)."""
    keys = buf = None
    for k in range(reader.num_shards) if shards is None else shards:
        rng = np.random.default_rng([seed, int(k)])
        src = np.load(reader.directory / f"src_{k}.npy", mmap_mode="r")
        slen = np.load(reader.directory / f"src_len_{k}.npy", mmap_mode="r")
        t = src.shape[1]
        mask = np.arange(t)[None, :] < np.asarray(slen)[:, None]
        # float32 whatever the storage dtype, so float16 shards give the
        # reservoir (and merge layout) of float32 ones
        flat = np.asarray(src)[mask].astype(np.float32, copy=False)
        u = rng.random(flat.shape[0])
        ck = u if keys is None else np.concatenate([keys, u])
        cb = flat if buf is None else np.concatenate([buf, flat])
        if ck.shape[0] > n_sample:
            top = np.argpartition(ck, n_sample - 1)[:n_sample]
            keys, buf = ck[top], cb[top]
        else:
            keys, buf = ck, cb
    if buf is None:  # no shard scanned
        d = int(np.load(reader.directory / "src_0.npy", mmap_mode="r").shape[-1])
        keys, buf = np.zeros((0,)), np.zeros((0, d), np.float32)
    order = np.argsort(keys, kind="stable")
    keys, buf = keys[order], buf[order]
    return (buf, keys) if return_keys else buf


def fit_codebook_reservoir(
    reader,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
    n_sample: int = 65536,
    frames=None,
) -> torch.Tensor:
    """The streaming codebook fit (shared by the VQ teacher's seeding and
    ``frontend.vq.fit_codebook_streaming``, so their code spaces cannot
    drift): Lloyd's sweeps on a cross-shard uniform frame reservoir
    (``_reservoir_frames``), started from n_codes distinct reservoir frames
    drawn on the CPU generator.  ``frames``: a reservoir drawn already, in
    ``_reservoir_frames``' ascending-key order.  [n_codes, D] on the
    reader's device."""
    if frames is None:
        frames = _reservoir_frames(reader, n_sample)
    if frames.shape[0] < n_codes:
        raise ValueError(f"corpus has only {frames.shape[0]} real frames < {n_codes} codes")
    flat = torch.as_tensor(np.ascontiguousarray(frames, np.float32), device=reader.device)
    uniform = torch.ones(flat.shape[0], dtype=torch.float64)
    idx0 = torch.multinomial(uniform, n_codes, replacement=False,
                             generator=_generator(generator))
    ones = torch.ones(flat.shape[0], device=flat.device)
    return _kmeans_fit(flat[idx0.to(flat.device)], flat, ones, num_iterations)


def quantize_shards_streaming(
    reader,
    out_dir,
    n_codes: int = 64,
    num_iterations: int = 10,
    generator: torch.Generator | None = None,
    n_sample: int = 65536,
    codebook: torch.Tensor | None = None,
    shard_ids=None,
    write_manifest: bool = True,
) -> torch.Tensor:
    """Out-of-core ``quantize_frames``: fit the codebook on a cross-shard
    frame reservoir (``fit_codebook_reservoir``; or take ``codebook`` as
    fitted), assign every shard's frames on the reader's device and write a
    parallel DISCRETE shard directory (``src`` = int32 code ids,
    ``src_vocab`` = n_codes; lengths, targets and gold copied).  Returns the
    [n_codes, D] codebook.

    ``shard_ids`` / ``write_manifest`` are the multi-rank hooks: each rank
    writes only its own shards into a shared ``out_dir`` and only one
    writes the manifest and gold
    (``parallel.multihost.init_vq_teacher_streaming_multihost``)."""
    if codebook is None:
        codebook = fit_codebook_reservoir(reader, n_codes, num_iterations, generator, n_sample)
    cb = codebook.to(reader.device)
    n_codes = int(cb.shape[0])
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for k in range(reader.num_shards) if shard_ids is None else shard_ids:
        src = reader.read_host(k, "src")
        # float16 storage crosses compact and is upcast on the device
        x = torch.from_numpy(src).to(reader.device).float()
        codes = _kmeans_assign(cb, x.reshape(-1, x.shape[-1])).reshape(x.shape[:2])
        np.save(out / f"src_{k}.npy", codes.to(torch.int32).cpu().numpy())
        for field in ("src_len", "trg", "trg_len"):
            shutil.copyfile(reader.directory / f"{field}_{k}.npy", out / f"{field}_{k}.npy")
    if write_manifest:
        manifest = json.loads((reader.directory / "manifest.json").read_text())
        manifest["src_vocab"] = n_codes
        manifest["name"] = manifest.get("name", "corpus") + "-vqcodes"
        (out / "manifest.json").write_text(json.dumps(manifest))
        if (reader.directory / "gold.json").exists():
            shutil.copyfile(reader.directory / "gold.json", out / "gold.json")
    return codebook


def init_vq_teacher_streaming(
    reader,
    code_dir,
    max_jump: int = 3,
    n_components: int = 1,
    generator: torch.Generator | None = None,
    *,
    n_codes: int = 64,
    teacher_iters: int = 10,
    seed_rounds: int = 3,
    use_kernels: bool | None = None,
    prefetch: int = 1,
    n_sample: int = 65536,
) -> GaussianHMMParams:
    """Out-of-core ``init_vq_teacher``, no resident corpus anywhere:

      1. base parameters from whole-corpus moments summed over the shards
         (``init``'s protocol: shard 0's feature mean as the shift);
      2. a codebook from a cross-shard frame reservoir, and every shard
         quantized into a parallel discrete shard directory ``code_dir``
         (``quantize_shards_streaming``);
      3. the discrete-HMM teacher trained by exact streamed EM over the
         code shards (``data.stream.train_streaming``; K1 + K2 on the card);
      4. ``seed_rounds`` rounds of streamed pinned-assignment GMM EM: the
         teacher's posteriors over each code shard (K1 + K4) paired with the
         same rows' frame shard, counts summed across shards, one m_step a
         round;
      5. the teacher's transitions copied over.

    Every stage is additive across shards, so this is the resident recipe
    up to float addition order and a codebook fitted on a ``n_sample``
    frame sample instead of all frames.  The generator draws the initial
    jitter first, then the codebook's seed frames.
    """
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        tree_sum_bounded,
    )

    gen = _generator(generator)
    shift = feature_shift(reader.load_shard(0))
    moments = tree_sum_bounded(init_moments(s, shift, with_diagonal=False)
                               for s in reader.shards(prefetch))
    base = init_from_moments(moments, max_jump=max_jump, n_components=n_components,
                             generator=gen, mode="global", shift=shift)
    quantize_shards_streaming(reader, code_dir, n_codes=n_codes, generator=gen,
                              n_sample=n_sample)
    code_reader = ShardedCorpusReader(code_dir, device=reader.device)
    tp = dhmm.init(code_reader.load_shard(0), max_jump=max_jump)  # vocabularies only
    tp, _ = train_streaming(dhmm, tp, code_reader, teacher_iters, prefetch=prefetch,
                            use_kernels=use_kernels)
    zero_w = torch.zeros(2 * max_jump + 3, device=base.means.device)

    def seed_counts(gp, fshard, cshard):
        gamma = dhmm.posteriors(tp, cshard, use_kernels=use_kernels)
        r = teacher_responsibilities(gamma, fshard)
        return counts_from_responsibilities(gp, fshard, r, zero_w)

    gp = base
    for _ in range(max(int(seed_rounds), 1)):
        total = tree_sum_bounded(
            seed_counts(gp, f, c)
            for f, c in zip(reader.shards(prefetch), code_reader.shards(prefetch)))
        gp = m_step(gp, total)
    return dataclasses.replace(gp, log_jump=tp.log_jump, log_p0=tp.log_p0)
