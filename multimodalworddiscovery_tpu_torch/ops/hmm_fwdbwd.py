"""K2, K4 and K6: the HMM E-step kernels over factored transitions, and
their plain versions.

K2 ``hmm_estep_counts``: the fused discrete-HMM E-step (forward, then
backward with the (phone, concept) count accumulation fused in, so gamma
never reaches device memory).  Replaces
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
bfloat16 and the products and sums stay float32 (K4's and K6's block path
runs them on the tensor cores).

CUDA sources: ``csrc/hmm_estep.cu`` (K4 and K6, one design with a remat
flag) and ``csrc/hmm_estep_counts.cu`` (K2), both on the kernel bodies of
``csrc/estep.cuh``.

Transitions come factored (``models/hmm_core.factor_log_trans``):
trans[n, s, s'] = base[s, s'] - rowz[n, s] + colmask[n, s'].  Each step's
log-semiring product is an ordinary product on max-rescaled exponentials
(all <= 1 because base0 = base - max(base)).  What bounds it on the H100 is
latency: the recursion is sequential in time.  K4 and K6 take any S, K2
S <= 64: several utterances share a block and its one copy of exp(base0),
each step a [S, S] x [S, B] product (a warp of 32 / S utterances, one lane
a state, up to S = 32; four utterances over 256 threads above, eight at
S <= 64 in large batches), and the utterances run longest first, in the
order ranked on the card (``csrc/order.cuh``), each block stopping at its
longest; xi is added once per chunk of steps and reduced over blocks in a
fixed order (see ``csrc/hmm_estep.cu``'s header for the rest of the
design).  K2's backward adds each posterior into a [V_src, V_trg] table of
its block in shared memory, flushed once per block, in place of K4's
gamma store; the adds are integer adds in fixed point (``csrc/counts.cuh``),
so one input gives the same counts in every run.  Each E-step is one C call.
"""

from __future__ import annotations

import functools

import torch

from multimodalworddiscovery_tpu_torch.core.counts import pair_counts
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.ops import _build
from multimodalworddiscovery_tpu_torch.utils.profiling import span

MAX_STATES = 64  # csrc/hmm_estep_counts.cu MWD_K2_MAX_S: K2, the fused route's gate
# K6: csrc/hmm_estep.cu MWD_REMAT_MAX_TC, the longest chunk a lane of the
# warp path holds in its local array, and the chunk length when none is given
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
    """Checks shared by K2, K4 and K6 before a launch (``max_states`` None:
    any S)."""
    if emit.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, got {emit.device}")
    dev = emit.device
    n, ts, s = emit.shape
    if s < 1 or ts < 1 or (max_states is not None and s > max_states):
        limit = "" if max_states is None else f" <= {max_states}"
        raise ValueError(f"{name} takes 1 <= S{limit} states and Ts >= 1, got S={s}, Ts={ts}")
    f32 = torch.float32
    _build.require(log_init, "log_init", f32, (n, s), dev)
    _build.require(base, "base", f32, (s, s), dev)
    _build.require(rowz, "rowz", f32, (n, s), dev)
    _build.require(colmask, "colmask", f32, (n, s), dev)
    _build.require(emit, "emit", f32, (n, ts, s), dev)
    _build.require(src_len, "src_len", torch.int32, (n,), dev)


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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

    CPU tensors take ``hmm_estep_counts_plain``; CUDA tensors run the
    whole E-step in one C call (S <= 64), K2 in float32 (counted in
    ``.launches``) or K2-bf16 (``.launches_bf16``); a batch of no
    utterances launches nothing."""
    bf16 = _is_bf16(dot_dtype)
    if emit.device.type == "cpu":
        return hmm_estep_counts_plain(
            log_init, base, rowz, colmask, emit, src, concepts, src_len,
            n_rows, n_cols, dot_dtype,
        )
    with span("mwd.ops.estep_counts"):
        _check_inputs("hmm_estep_counts", MAX_STATES, log_init, base, rowz, colmask, emit, src_len)
        dev = emit.device
        n, ts, s = emit.shape
        _build.require(src, "src", torch.int32, (n, ts), dev)
        _build.require(concepts, "concepts", torch.int32, (n, s), dev)
        f32 = dict(dtype=torch.float32, device=dev)
        if n == 0:
            return (torch.zeros((n_rows, n_cols), **f32), torch.zeros((s, s), **f32),
                    torch.empty((0,), **f32))
        counts = torch.empty((n_rows, n_cols), **f32)
        xi = torch.empty((s, s), **f32)
        logz = torch.empty((n,), **f32)
        work = torch.empty((_counts_work_floats(n, ts, s),), **f32)
        acc = torch.empty((2, n_rows * n_cols), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            status = _build.load().mwd_estep_counts(
                base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
                emit.data_ptr(), src_len.data_ptr(), src.data_ptr(), concepts.data_ptr(),
                work.data_ptr(), acc.data_ptr(), counts.data_ptr(), xi.data_ptr(), logz.data_ptr(),
                n, ts, s, n_rows, n_cols, int(bf16), _stream(dev),
            )
        _build.check(status, "mwd_estep_counts")
        if bf16:
            hmm_estep_counts.launches_bf16 += 1
        else:
            hmm_estep_counts.launches += 1
        return counts, xi, logz


hmm_estep_counts.launches = 0
hmm_estep_counts.launches_bf16 = 0


@functools.lru_cache(maxsize=64)
def _work_floats(n: int, ts: int, s: int, tcr: int) -> int:
    return int(_build.load().mwd_estep_work(n, ts, s, tcr))


@functools.lru_cache(maxsize=64)
def _counts_work_floats(n: int, ts: int, s: int) -> int:
    return int(_build.load().mwd_estep_counts_work(n, ts, s))


def _general_kernels(log_init, base, rowz, colmask, log_emit, src_len, bf16, tcr):
    """K4 (``tcr`` 0) or K6 (``tcr`` > 0, the chunk) in one call of the C
    entry point: length order and tables, forward, backward, xi reduction
    -> (gamma, xi, logz).  Counts the launch in ``hmm_estep``'s counter of
    the variant; a batch of no utterances launches nothing."""
    with span("mwd.ops.estep"):
        name = "the remat E-step kernel" if tcr else "the general E-step kernel"
        _check_inputs(name, None, log_init, base, rowz, colmask, log_emit, src_len)
        dev = log_emit.device
        n, ts, s = log_emit.shape
        f32 = dict(dtype=torch.float32, device=dev)
        gamma = torch.empty((n, ts, s), **f32)
        logz = torch.empty((n,), **f32)
        if n == 0:
            return gamma, torch.zeros((s, s), **f32), logz
        work = torch.empty((_work_floats(n, ts, s, tcr),), **f32)
        xi = torch.empty((s, s), **f32)
        with torch.cuda.device(dev):
            status = _build.load().mwd_estep(
                base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(), colmask.data_ptr(),
                log_emit.data_ptr(), src_len.data_ptr(), work.data_ptr(), gamma.data_ptr(),
                xi.data_ptr(), logz.data_ptr(), n, ts, s, tcr, int(bf16), _stream(dev),
            )
        _build.check(status, "mwd_estep")
        if tcr:
            hmm_estep.launches_remat += 1
        elif bf16:
            hmm_estep.launches_bf16 += 1
        else:
            hmm_estep.launches += 1
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
    ``remat=True``); CUDA tensors launch the forward and backward kernels
    (any S): K4 in float32 (counted in ``.launches``), K4-bf16
    (``.launches_bf16``), or with ``remat=True`` K6 in either dtype
    (``.launches_remat``), in chunks of ``chunk_t`` steps (default 32, at
    most 64).  ``remat=None`` means False, as in the reference."""
    bf16 = _is_bf16(dot_dtype)
    remat = bool(remat)
    tc = _chunk(chunk_t) if remat else 0
    if log_emit.device.type == "cpu":
        if remat:
            return hmm_estep_remat_plain(log_init, base, rowz, colmask, log_emit, src_len,
                                         dot_dtype, tc)
        return hmm_estep_plain(log_init, base, rowz, colmask, log_emit, src_len, dot_dtype)
    return _general_kernels(log_init, base, rowz, colmask, log_emit, src_len, bf16, tc)


hmm_estep.launches = 0
hmm_estep.launches_bf16 = 0
hmm_estep.launches_remat = 0
