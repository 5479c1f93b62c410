"""K2 and K4: the HMM E-step kernels over factored transitions, and their
plain versions.

K2 ``hmm_estep_counts``: the fused discrete-HMM E-step (forward, then
backward with the (phone, concept) count accumulation fused in).  Replaces
``multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
hmm_estep_counts_pallas`` (``_fwd_kernel`` then ``_bwd_counts_kernel``, step
math ``_bwd_math``), float32 only.

K4 ``hmm_estep``: the general E-step that hands back the state posteriors
gamma [N, Ts, S], for every aligner whose emissions are not a table lookup
(Gaussian, DNN, CRF) and for the discrete HMM outside K2's gate.  Replaces
``hmm_fwdbwd_pallas.py:hmm_estep_pallas`` (``_fwd_kernel`` then
``_bwd_kernel``), float32, without the remat variant (K6).

CUDA source of both: ``csrc/hmm_fwdbwd.cu`` (one forward kernel, one
backward kernel instantiated with either consumer of gamma).

Transitions come factored (``models/hmm_core.factor_log_trans``):
trans[n, s, s'] = base[s, s'] - rowz[n, s] + colmask[n, s'].  Each step's
log-semiring product is an ordinary product on max-rescaled exponentials
(all <= 1 because base0 = base - max(base)).  What bounds it on the H100 is
latency: the recursion is sequential in time with S <= 160 states, so the
kernels run one block per utterance and one thread per state and keep
exp(base0) in shared memory; K2 sends gamma straight into the [F, E] counts
with atomics, so gamma never reaches device memory, and K4 writes it once
(see the CUDA source's header for the rest of the design).
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.counts import pair_counts
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.ops import _build

MAX_STATES = 64  # csrc/common.cuh MWD_MAX_S: K2, the fused route's gate
# csrc/common.cuh MWD_MAX_S_GENERAL: K4's [S, S+1] exp(base0) and [S, S] xi
# tables in one block's shared memory (206,848 of 232,448 bytes at S = 160)
MAX_STATES_GENERAL = 160


def _safe(x: torch.Tensor) -> torch.Tensor:
    """0 where x is NEG_INF-like (the kernels' m_safe / logz_safe guard)."""
    return torch.where(x > NEG_INF / 2, x, 0.0)


def hmm_estep_plain(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    emit: torch.Tensor,      # [N, Ts, S]
    src_len: torch.Tensor,   # [N] int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' math batched over utterances, one torch step per time
    step: (gamma [N, Ts, S], xi_pooled [S, S], logz [N])."""
    n, ts, s = emit.shape
    maxbase = base.max()
    bexp = torch.exp(torch.clamp(base - maxbase, min=NEG_INF))
    rowz0 = rowz - maxbase
    lens = src_len[:, None]

    alpha = log_init + emit[:, 0]
    alphas = [alpha]
    for t in range(1, ts):
        a2 = alpha - rowz0
        m = _safe(a2.amax(dim=1, keepdim=True))
        p = torch.exp(a2 - m) @ bexp  # p[n, s'] = sum_s e[n, s] bexp[s, s']
        upd = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)) + m, NEG_INF)
        upd = upd + emit[:, t] + colmask
        alpha = torch.where(t < lens, upd, alpha)
        alphas.append(alpha)

    m = alpha.amax(dim=1)
    z = torch.log(torch.exp(alpha - _safe(m)[:, None]).sum(dim=1) + 1e-38)
    z = torch.where(m > NEG_INF / 2, z + _safe(m), NEG_INF)
    logz = torch.where(src_len > 0, z, 0.0)
    logz_safe = _safe(logz)[:, None]

    eb = torch.full_like(alpha, NEG_INF)  # emit[t + 1] + beta[t + 1]
    gamma = torch.empty_like(emit)
    xi = torch.zeros_like(base)
    for t in range(ts - 1, -1, -1):
        ebm = eb + colmask
        m2 = _safe(ebm.amax(dim=1, keepdim=True))
        f = torch.exp(ebm - m2)
        q = f @ bexp.T  # q[n, s] = sum_s' bexp[s, s'] f[n, s']
        upd = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-38)) + m2, NEG_INF)
        beta = torch.where(t + 1 >= lens, 0.0, upd - rowz0)
        lg = alphas[t] + beta - logz_safe
        gamma[:, t] = torch.where(t < lens, torch.exp(torch.clamp(lg, max=0.0)), 0.0)
        ea = torch.exp(torch.clamp(alphas[t] - rowz0 - logz_safe + m2, max=80.0))
        ea = torch.where(t + 1 < lens, ea, 0.0)
        xi = xi + bexp * (ea.T @ f)
        eb = emit[:, t] + beta
    return gamma, xi, logz


def hmm_estep_counts_plain(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    emit: torch.Tensor,      # [N, Ts, S]
    src: torch.Tensor,       # [N, Ts] int
    concepts: torch.Tensor,  # [N, S] int
    src_len: torch.Tensor,   # [N] int
    n_rows: int,
    n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hmm_estep_plain`` followed by the count scatter: (counts
    [n_rows, n_cols], xi_pooled [S, S], logz [N])."""
    gamma, xi, logz = hmm_estep_plain(log_init, base, rowz, colmask, emit, src_len)
    return pair_counts(gamma, src, concepts, n_rows, n_cols), xi, logz


def _forward(
    name: str,
    max_states: int,
    log_init: torch.Tensor,
    base: torch.Tensor,
    rowz: torch.Tensor,
    colmask: torch.Tensor,
    emit: torch.Tensor,
    src_len: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor] | None:
    """Checks shared by K2 and K4, then the forward kernel -> (alphas
    [N, Ts, S], logz [N]), or None on a CUDA batch of no utterances."""
    if emit.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {emit.device}")
    dev = emit.device
    n, ts, s = emit.shape
    if not 1 <= s <= max_states or ts < 1:
        raise ValueError(
            f"{name} takes 1 <= S <= {max_states} states (its tables share one "
            f"block's shared memory) and Ts >= 1, got S={s}, Ts={ts}"
        )
    f32 = torch.float32
    _build.require(log_init, "log_init", f32, (n, s), dev)
    _build.require(base, "base", f32, (s, s), dev)
    _build.require(rowz, "rowz", f32, (n, s), dev)
    _build.require(colmask, "colmask", f32, (n, s), dev)
    _build.require(emit, "emit", f32, (n, ts, s), dev)
    _build.require(src_len, "src_len", torch.int32, (n,), dev)
    if n == 0:
        return None
    alphas = torch.empty((n, ts, s), dtype=f32, device=dev)
    logz = torch.empty((n,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        status = _build.load().mwd_hmm_fwd(
            base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(),
            colmask.data_ptr(), emit.data_ptr(), src_len.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), n, ts, s,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_hmm_fwd")
    return alphas, logz


def hmm_estep_counts(
    log_init: torch.Tensor,  # [N, S] float32
    base: torch.Tensor,      # [S, S] float32
    rowz: torch.Tensor,      # [N, S] float32
    colmask: torch.Tensor,   # [N, S] float32
    emit: torch.Tensor,      # [N, Ts, S] float32
    src: torch.Tensor,       # [N, Ts] int32
    concepts: torch.Tensor,  # [N, S] int32
    src_len: torch.Tensor,   # [N] int32
    n_rows: int,
    n_cols: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(emission counts [n_rows, n_cols], pooled xi [S, S], logz [N]).

    CPU tensors take ``hmm_estep_counts_plain``; CUDA tensors launch the
    forward and the backward-counts kernels (S <= 64)."""
    if emit.device.type == "cpu":
        return hmm_estep_counts_plain(
            log_init, base, rowz, colmask, emit, src, concepts, src_len,
            n_rows, n_cols,
        )
    fwd = _forward("hmm_estep_counts", MAX_STATES, log_init, base, rowz, colmask,
                   emit, src_len)
    dev = emit.device
    n, ts, s = emit.shape
    _build.require(src, "src", torch.int32, (n, ts), dev)
    _build.require(concepts, "concepts", torch.int32, (n, s), dev)
    counts = torch.zeros((n_rows, n_cols), dtype=torch.float32, device=dev)
    xi = torch.zeros((s, s), dtype=torch.float32, device=dev)
    if fwd is None:
        return counts, xi, torch.empty((0,), dtype=torch.float32, device=dev)
    alphas, logz = fwd
    with torch.cuda.device(dev):
        status = _build.load().mwd_hmm_bwd_counts(
            base.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
            emit.data_ptr(), alphas.data_ptr(), logz.data_ptr(),
            src.data_ptr(), concepts.data_ptr(), src_len.data_ptr(),
            counts.data_ptr(), xi.data_ptr(), n, ts, s, n_rows, n_cols,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_hmm_bwd_counts")
    hmm_estep_counts.launches += 1
    return counts, xi, logz


hmm_estep_counts.launches = 0


def hmm_estep(
    log_init: torch.Tensor,  # [N, S] float32
    base: torch.Tensor,      # [S, S] float32
    rowz: torch.Tensor,      # [N, S] float32
    colmask: torch.Tensor,   # [N, S] float32
    log_emit: torch.Tensor,  # [N, Ts, S] float32
    src_len: torch.Tensor,   # [N] int32
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gamma [N, Ts, S], pooled xi [S, S], logz [N]).

    CPU tensors take ``hmm_estep_plain``; CUDA tensors launch the forward
    and the backward-gamma kernels (S <= 160)."""
    if log_emit.device.type == "cpu":
        return hmm_estep_plain(log_init, base, rowz, colmask, log_emit, src_len)
    fwd = _forward("the general E-step kernel", MAX_STATES_GENERAL, log_init, base,
                   rowz, colmask, log_emit, src_len)
    dev = log_emit.device
    n, ts, s = log_emit.shape
    gamma = torch.empty((n, ts, s), dtype=torch.float32, device=dev)
    xi = torch.zeros((s, s), dtype=torch.float32, device=dev)
    if fwd is None:
        return gamma, xi, torch.empty((0,), dtype=torch.float32, device=dev)
    alphas, logz = fwd
    with torch.cuda.device(dev):
        status = _build.load().mwd_hmm_bwd_gamma(
            base.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
            log_emit.data_ptr(), alphas.data_ptr(), logz.data_ptr(),
            src_len.data_ptr(), gamma.data_ptr(), xi.data_ptr(), n, ts, s,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_hmm_bwd_gamma")
    hmm_estep.launches += 1
    return gamma, xi, logz


hmm_estep.launches = 0
