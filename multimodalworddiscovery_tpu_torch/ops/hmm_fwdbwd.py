"""K2, K4 and K6: the HMM E-step kernels over factored transitions, and
their plain versions.

K2 ``hmm_estep_counts``: the fused discrete-HMM E-step (forward, then
backward with the (phone, concept) count accumulation fused in).  Replaces
``multimodalworddiscovery_tpu/ops/hmm_fwdbwd_pallas.py:
hmm_estep_counts_pallas`` (``_fwd_kernel`` then ``_bwd_counts_kernel``, step
math ``_bwd_math``).

K4 ``hmm_estep``: the general E-step that hands back the state posteriors
gamma [N, Ts, S], for every aligner whose emissions are not a table lookup
(Gaussian, DNN, CRF) and for the discrete HMM outside K2's gate.  Replaces
``hmm_fwdbwd_pallas.py:hmm_estep_pallas`` (``_fwd_kernel`` then
``_bwd_kernel``).

K6 ``hmm_estep(..., remat=True)``: K4 with the alphas rematerialized.  The
forward keeps only the alpha entering each ``chunk_t``-step chunk, and the
backward recomputes each chunk's alphas from it.  Replaces
``hmm_estep_pallas(remat=True)`` (``_fwd_ckpt_kernel`` then
``_bwd_remat_kernel``).

``dot_dtype="bfloat16"`` (K2-bf16, K4-bf16, and K6 in bf16) is the TPU
kernels' bf16 variant: the operands of each step's products are rounded to
bfloat16 and the products and sums stay float32.

CUDA source of all three: ``csrc/hmm_fwdbwd.cu`` (forward kernels, and
backward kernels instantiated with each consumer of gamma and each dtype).

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
# K6: csrc/hmm_fwdbwd.cu MWD_REMAT_MAX_TC, the longest chunk each thread
# holds in its local array, and the chunk length when none is given
MAX_CHUNK = 64
DEFAULT_CHUNK = 32
DOT_DTYPES = ("float32", "bfloat16")


def _is_bf16(dot_dtype: str) -> bool:
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f"dot_dtype must be one of {DOT_DTYPES}, got {dot_dtype!r}")
    return dot_dtype == "bfloat16"


def _safe(x: torch.Tensor) -> torch.Tensor:
    """0 where x is NEG_INF-like (the kernels' m_safe / logz_safe guard)."""
    return torch.where(x > NEG_INF / 2, x, 0.0)


def _dot_in(x: torch.Tensor, bf16: bool) -> torch.Tensor:
    """A product's operand as the bf16 variant reads it: rounded to bfloat16
    (nearest even) and widened back, so the float32 product is exact."""
    return x.to(torch.bfloat16).float() if bf16 else x


def _prep(base: torch.Tensor, rowz: torch.Tensor, bf16: bool):
    """(exp(base0) [S, S] in float32, the same as the products read it,
    rowz0 = rowz - max(base))."""
    maxbase = base.max()
    bexp = torch.exp(torch.clamp(base - maxbase, min=NEG_INF))
    return bexp, _dot_in(bexp, bf16), rowz - maxbase


def _fwd_step(alpha, bexp_d, rowz0, colmask, emit_t, alive, bf16):
    """alpha [N, S] -> alpha at the next step (carried where not alive)."""
    a2 = alpha - rowz0
    m = _safe(a2.amax(dim=1, keepdim=True))
    p = _dot_in(torch.exp(a2 - m), bf16) @ bexp_d  # p[n, s'] = sum_s e[n, s] bexp[s, s']
    upd = torch.where(p > 0, torch.log(torch.clamp(p, min=1e-38)) + m, NEG_INF)
    upd = upd + emit_t + colmask
    return torch.where(alive, upd, alpha)


def _logz(alpha: torch.Tensor, src_len: torch.Tensor) -> torch.Tensor:
    m = alpha.amax(dim=1)
    z = torch.log(torch.exp(alpha - _safe(m)[:, None]).sum(dim=1) + 1e-38)
    z = torch.where(m > NEG_INF / 2, z + _safe(m), NEG_INF)
    return torch.where(src_len > 0, z, 0.0)


def _bwd_step(eb, alpha_t, t, lens, bexp, bexp_d, rowz0, colmask, emit_t, logz_safe, bf16):
    """One backward step from the carry eb = emit[t + 1] + beta[t + 1]:
    (emit[t] + beta[t], gamma[t] [N, S], this step's xi [S, S])."""
    ebm = eb + colmask
    m2 = _safe(ebm.amax(dim=1, keepdim=True))
    f = _dot_in(torch.exp(ebm - m2), bf16)
    q = f @ bexp_d.T  # q[n, s] = sum_s' bexp[s, s'] f[n, s']
    upd = torch.where(q > 0, torch.log(torch.clamp(q, min=1e-38)) + m2, NEG_INF)
    beta = torch.where(t + 1 >= lens, 0.0, upd - rowz0)
    lg = alpha_t + beta - logz_safe
    gamma_t = torch.where(t < lens, torch.exp(torch.clamp(lg, max=0.0)), 0.0)
    ea = torch.exp(torch.clamp(alpha_t - rowz0 - logz_safe + m2, max=80.0))
    ea = _dot_in(torch.where(t + 1 < lens, ea, 0.0), bf16)
    return emit_t + beta, gamma_t, bexp * (ea.T @ f)


def hmm_estep_plain(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    emit: torch.Tensor,      # [N, Ts, S]
    src_len: torch.Tensor,   # [N] int
    dot_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernels' math batched over utterances, one torch step per time
    step: (gamma [N, Ts, S], xi_pooled [S, S], logz [N])."""
    bf16 = _is_bf16(dot_dtype)
    n, ts, s = emit.shape
    bexp, bexp_d, rowz0 = _prep(base, rowz, bf16)
    lens = src_len[:, None]

    alpha = log_init + emit[:, 0]
    alphas = [alpha]
    for t in range(1, ts):
        alpha = _fwd_step(alpha, bexp_d, rowz0, colmask, emit[:, t], t < lens, bf16)
        alphas.append(alpha)
    logz = _logz(alpha, src_len)
    logz_safe = _safe(logz)[:, None]

    eb = torch.full_like(alpha, NEG_INF)  # emit[t + 1] + beta[t + 1]
    gamma = torch.empty_like(emit)
    xi = torch.zeros_like(base)
    for t in range(ts - 1, -1, -1):
        eb, gamma[:, t], xi_t = _bwd_step(eb, alphas[t], t, lens, bexp, bexp_d, rowz0,
                                          colmask, emit[:, t], logz_safe, bf16)
        xi = xi + xi_t
    return gamma, xi, logz


def _chunk(chunk_t: int | None) -> int:
    tc = DEFAULT_CHUNK if chunk_t is None else int(chunk_t)
    if not 1 <= tc <= MAX_CHUNK:
        raise ValueError(f"chunk_t must be in [1, {MAX_CHUNK}], got {chunk_t}")
    return tc


def hmm_estep_remat_plain(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    emit: torch.Tensor,      # [N, Ts, S]
    src_len: torch.Tensor,   # [N] int
    dot_dtype: str = "float32",
    chunk_t: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K6's math with K6's chunk bookkeeping: the forward keeps only the
    alpha entering each chunk, the backward recomputes each chunk's alphas
    (t = 0 from log_init + emit[0]) before its steps.  Same outputs as
    ``hmm_estep_plain``; the last chunk may be shorter than ``chunk_t``."""
    bf16 = _is_bf16(dot_dtype)
    tc = _chunk(chunk_t)
    n, ts, s = emit.shape
    bexp, bexp_d, rowz0 = _prep(base, rowz, bf16)
    lens = src_len[:, None]
    n_chunks = -(-ts // tc)

    first = log_init + emit[:, 0]
    alpha = first
    ckpt = [first] + [None] * (n_chunks - 1)  # alpha entering chunk c (c >= 1)
    for t in range(1, ts):
        if t % tc == 0:
            ckpt[t // tc] = alpha
        alpha = _fwd_step(alpha, bexp_d, rowz0, colmask, emit[:, t], t < lens, bf16)
    logz = _logz(alpha, src_len)
    logz_safe = _safe(logz)[:, None]

    eb = torch.full_like(alpha, NEG_INF)
    gamma = torch.empty_like(emit)
    xi = torch.zeros_like(base)
    for c in range(n_chunks - 1, -1, -1):
        c0 = c * tc
        alpha, alphas = ckpt[c], []
        for t in range(c0, min(c0 + tc, ts)):
            if t == 0:
                alpha = first
            else:
                alpha = _fwd_step(alpha, bexp_d, rowz0, colmask, emit[:, t], t < lens, bf16)
            alphas.append(alpha)
        for t in range(min(c0 + tc, ts) - 1, c0 - 1, -1):
            eb, gamma[:, t], xi_t = _bwd_step(eb, alphas[t - c0], t, lens, bexp, bexp_d,
                                              rowz0, colmask, emit[:, t], logz_safe, bf16)
            xi = xi + xi_t
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
    dot_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``hmm_estep_plain`` followed by the count scatter: (counts
    [n_rows, n_cols], xi_pooled [S, S], logz [N])."""
    gamma, xi, logz = hmm_estep_plain(log_init, base, rowz, colmask, emit, src_len,
                                      dot_dtype)
    return pair_counts(gamma, src, concepts, n_rows, n_cols), xi, logz


def _check_inputs(name, max_states, log_init, base, rowz, colmask, emit, src_len) -> None:
    """Checks shared by K2, K4 and K6 before a launch."""
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


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _forward(name, max_states, log_init, base, rowz, colmask, emit, src_len, bf16):
    """Checks, then the forward kernel -> (alphas [N, Ts, S], logz [N]),
    or None on a CUDA batch of no utterances."""
    _check_inputs(name, max_states, log_init, base, rowz, colmask, emit, src_len)
    dev = emit.device
    n, ts, s = emit.shape
    if n == 0:
        return None
    alphas = torch.empty((n, ts, s), dtype=torch.float32, device=dev)
    logz = torch.empty((n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        status = _build.load().mwd_hmm_fwd(
            base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(),
            colmask.data_ptr(), emit.data_ptr(), src_len.data_ptr(),
            alphas.data_ptr(), logz.data_ptr(), n, ts, s, int(bf16), _stream(dev),
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
    dot_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(emission counts [n_rows, n_cols], pooled xi [S, S], logz [N]).

    CPU tensors take ``hmm_estep_counts_plain``; CUDA tensors launch the
    forward and the backward-counts kernels (S <= 64), K2 in float32
    (counted in ``.launches``) or K2-bf16 (``.launches_bf16``)."""
    bf16 = _is_bf16(dot_dtype)
    if emit.device.type == "cpu":
        return hmm_estep_counts_plain(
            log_init, base, rowz, colmask, emit, src, concepts, src_len,
            n_rows, n_cols, dot_dtype,
        )
    fwd = _forward("hmm_estep_counts", MAX_STATES, log_init, base, rowz, colmask,
                   emit, src_len, bf16)
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
            counts.data_ptr(), xi.data_ptr(), n, ts, s, n_rows, n_cols, int(bf16),
            _stream(dev),
        )
    _build.check(status, "mwd_hmm_bwd_counts")
    if bf16:
        hmm_estep_counts.launches_bf16 += 1
    else:
        hmm_estep_counts.launches += 1
    return counts, xi, logz


hmm_estep_counts.launches = 0
hmm_estep_counts.launches_bf16 = 0


def _remat_kernels(log_init, base, rowz, colmask, log_emit, src_len, bf16, tc):
    """K6: the checkpointing forward, then the rematerializing backward."""
    _check_inputs("the remat E-step kernel", MAX_STATES_GENERAL, log_init, base, rowz,
                  colmask, log_emit, src_len)
    dev = log_emit.device
    n, ts, s = log_emit.shape
    gamma = torch.empty((n, ts, s), dtype=torch.float32, device=dev)
    xi = torch.zeros((s, s), dtype=torch.float32, device=dev)
    logz = torch.empty((n,), dtype=torch.float32, device=dev)
    if n == 0:
        return gamma, xi, logz
    ckpt = torch.empty((n, -(-ts // tc), s), dtype=torch.float32, device=dev)
    lib = _build.load()
    with torch.cuda.device(dev):
        status = lib.mwd_hmm_fwd_ckpt(
            base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
            log_emit.data_ptr(), src_len.data_ptr(), ckpt.data_ptr(), logz.data_ptr(),
            n, ts, s, tc, int(bf16), _stream(dev),
        )
        _build.check(status, "mwd_hmm_fwd_ckpt")
        status = lib.mwd_hmm_bwd_remat(
            base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
            log_emit.data_ptr(), ckpt.data_ptr(), logz.data_ptr(), src_len.data_ptr(),
            gamma.data_ptr(), xi.data_ptr(), n, ts, s, tc, int(bf16), _stream(dev),
        )
    _build.check(status, "mwd_hmm_bwd_remat")
    hmm_estep.launches_remat += 1
    return gamma, xi, logz


def hmm_estep(
    log_init: torch.Tensor,  # [N, S] float32
    base: torch.Tensor,      # [S, S] float32
    rowz: torch.Tensor,      # [N, S] float32
    colmask: torch.Tensor,   # [N, S] float32
    log_emit: torch.Tensor,  # [N, Ts, S] float32
    src_len: torch.Tensor,   # [N] int32
    dot_dtype: str = "float32",
    remat: bool | None = None,
    chunk_t: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gamma [N, Ts, S], pooled xi [S, S], logz [N]).

    CPU tensors take ``hmm_estep_plain`` (``hmm_estep_remat_plain`` with
    ``remat=True``); CUDA tensors launch the forward and the backward-gamma
    kernels (S <= 160): K4 in float32 (counted in ``.launches``), K4-bf16
    (``.launches_bf16``), or with ``remat=True`` K6 in either dtype
    (``.launches_remat``), in chunks of ``chunk_t`` steps (default 32, at
    most 64).  ``remat=None`` means False, as in the reference."""
    bf16 = _is_bf16(dot_dtype)
    remat = bool(remat)
    if remat:
        tc = _chunk(chunk_t)
    if log_emit.device.type == "cpu":
        if remat:
            return hmm_estep_remat_plain(log_init, base, rowz, colmask, log_emit, src_len,
                                         dot_dtype, tc)
        return hmm_estep_plain(log_init, base, rowz, colmask, log_emit, src_len, dot_dtype)
    if remat:
        return _remat_kernels(log_init, base, rowz, colmask, log_emit, src_len, bf16, tc)
    fwd = _forward("the general E-step kernel", MAX_STATES_GENERAL, log_init, base,
                   rowz, colmask, log_emit, src_len, bf16)
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
            src_len.data_ptr(), gamma.data_ptr(), xi.data_ptr(), n, ts, s, int(bf16),
            _stream(dev),
        )
    _build.check(status, "mwd_hmm_bwd_gamma")
    if bf16:
        hmm_estep.launches_bf16 += 1
    else:
        hmm_estep.launches += 1
    return gamma, xi, logz


hmm_estep.launches = 0
hmm_estep.launches_bf16 = 0
hmm_estep.launches_remat = 0
