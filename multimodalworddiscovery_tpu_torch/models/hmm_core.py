"""Shared HMM alignment machinery (state space, transitions, fwd-bwd, Viterbi).

Counterpart of ``multimodalworddiscovery_tpu/models/hmm_core.py``: the whole
corpus is batched, with an [N, S] carry and one O(N*S^2) log-semiring step
per time step (a Python loop over time here, where the reference has a
``lax.scan``).  ``forward_associative`` and ``forward_blocked`` compute the
same forward pass as prefix products of [S, S] step matrices, parallel in
time, with the log-semiring product K8 as their combine.

State space (Vogel/Och-style HMM word alignment with paired NULL states):
  S = 2 * Tt_max states per utterance.
  s in [0, Tt_max):          "real" state, aligned to target position s.
  s in [Tt_max, 2*Tt_max):   "null" state paired with underlying position
                             s - Tt_max (emits the NULL concept 0).

Transitions are parameterized by jump width between underlying positions
(log_jump[w + max_jump], |w| <= max_jump) plus a null weight log_p0; rows
are normalized over the utterance's valid states.  A state path decodes to
an alignment with 0 for null states and pos + 1 for real states.

Every entry point that takes ``use_kernels`` defaults it to None, which
resolves to whether the data lies on a CUDA device (``ops.kernels_for``): a
corpus on the card runs the kernels, a CPU corpus their plain versions.
An explicit False keeps the plain path on the card (for comparisons).
"""

from __future__ import annotations

import functools

import torch

from multimodalworddiscovery_tpu_torch.core.logsemiring import (
    NEG_INF,
    log_matmul,
    log_normalize,
    masked_logsumexp,
)
from multimodalworddiscovery_tpu_torch.core.masking import lengths_to_mask
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd, kernels_for
from multimodalworddiscovery_tpu_torch.ops import log_semiring as semiring_ops
from multimodalworddiscovery_tpu_torch.ops import viterbi as viterbi_ops


def state_positions(tt_max: int, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos [S], is_null [S]) for S = 2*Tt_max."""
    s = torch.arange(2 * tt_max, device=device)
    return s % tt_max, s >= tt_max


def state_mask(corpus: Corpus) -> torch.Tensor:
    """[N, S] validity of each state given the utterance's #concepts."""
    pos, _ = state_positions(corpus.max_trg_len, corpus.device)
    return pos[None, :] < corpus.trg_len[:, None]


def state_concepts(corpus: Corpus) -> torch.Tensor:
    """[N, S] int32 concept id emitted by each state (0 for null states)."""
    pos, is_null = state_positions(corpus.max_trg_len, corpus.device)
    real_concept = corpus.trg[:, pos]
    return torch.where(is_null[None, :], 0, real_concept).to(torch.int32)


def jump_width_ids(tt_max: int, max_jump: int, device=None) -> torch.Tensor:
    """[S, S] int index into the jump table for each transition.

    width id = clip(pos' - pos, -max_jump, max_jump) + max_jump in [0, W);
    entries into null states get id W (the p0 slot); W+1 marks 'impossible'
    (null entry with mismatched underlying position).
    """
    pos, is_null = state_positions(tt_max, device)
    w = torch.clamp(pos[None, :] - pos[:, None], -max_jump, max_jump) + max_jump
    W = 2 * max_jump + 1
    same_pos = pos[None, :] == pos[:, None]
    null_ids = torch.where(same_pos, W, W + 1)
    return torch.where(is_null[None, :], null_ids, w)


def factor_log_trans(
    log_jump: torch.Tensor, log_p0: torch.Tensor, corpus: Corpus, max_jump: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Factored transitions: trans[n,s,s'] = base[s,s'] - rowz[n,s] + colmask[n,s'].

    base [S, S] is the shared jump-weight matrix, colmask [N, S] is 0 on the
    utterance's valid states and NEG_INF elsewhere, and rowz [N, S] is the
    per-row log normalizer (0 for fully-masked rows).
    """
    ids = jump_width_ids(corpus.max_trg_len, max_jump, log_jump.device)
    neg = torch.full((1,), NEG_INF, dtype=log_jump.dtype, device=log_jump.device)
    table = torch.cat([log_jump, log_p0.reshape(1), neg])  # [W + 2]
    base = table[ids]  # [S, S]
    colmask = torch.where(state_mask(corpus), 0.0, NEG_INF).to(base.dtype)
    rowz = masked_logsumexp(base[None, :, :] + colmask[:, None, :], dim=-1)
    rowz = torch.where(rowz > NEG_INF / 2, rowz, 0.0)  # all-masked rows
    return base, rowz, colmask


def build_log_trans(
    log_jump: torch.Tensor, log_p0: torch.Tensor, corpus: Corpus, max_jump: int
) -> torch.Tensor:
    """[N, S, S] row-normalized log transition matrices (dense form of
    ``factor_log_trans``, used by the plain fwd-bwd path)."""
    base, rowz, colmask = factor_log_trans(log_jump, log_p0, corpus, max_jump)
    logw = base[None, :, :] + colmask[:, None, :]
    out = torch.clamp(logw - rowz[:, :, None], min=NEG_INF)
    # keep exact NEG_INF at masked entries (logw - rowz could drift below)
    return torch.where(logw > NEG_INF / 2, out, NEG_INF)


def build_log_init(log_p0: torch.Tensor, corpus: Corpus) -> torch.Tensor:
    """[N, S] initial distribution: uniform weight on real states, p0 weight
    on null states, normalized over the utterance's valid states."""
    _, is_null = state_positions(corpus.max_trg_len, corpus.device)
    w = torch.where(is_null[None, :], log_p0, torch.zeros_like(log_p0))
    w = torch.where(state_mask(corpus), w, NEG_INF)
    return log_normalize(w, dim=-1)


def forward(
    log_init: torch.Tensor,   # [N, S]
    log_trans: torch.Tensor,  # [N, S, S]
    log_emit: torch.Tensor,   # [N, Ts, S]
    src_len: torch.Tensor,    # [N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched forward pass -> (alphas [Ts, N, S], logZ [N]).

    Steps past an utterance's length carry alpha unchanged; a zero-length
    utterance has logZ = 0.
    """
    n, ts, s = log_emit.shape
    alpha = log_init + log_emit[:, 0]
    alphas = [alpha]
    for t in range(1, ts):
        upd = masked_logsumexp(alpha[:, :, None] + log_trans, dim=1) + log_emit[:, t]
        alpha = torch.where((t < src_len)[:, None], upd, alpha)
        alphas.append(alpha)
    alphas = torch.stack(alphas)
    logz = masked_logsumexp(alphas[-1], dim=-1)
    logz = torch.where(src_len > 0, logz, 0.0)
    return alphas, logz


def backward(
    log_trans: torch.Tensor, log_emit: torch.Tensor, src_len: torch.Tensor
) -> torch.Tensor:
    """Batched backward pass -> betas [Ts, N, S].

    beta[t] is 0 at t == len-1; positions t >= len hold zeros.
    """
    n, ts, s = log_emit.shape
    beta = torch.zeros((n, s), dtype=log_emit.dtype, device=log_emit.device)
    betas = [beta]
    for t in range(ts - 2, -1, -1):
        x = log_trans + (log_emit[:, t + 1] + beta)[:, None, :]
        upd = masked_logsumexp(x, dim=2)
        beta = torch.where((t + 1 >= src_len)[:, None], 0.0, upd)
        betas.append(beta)
    return torch.stack(betas[::-1])


def step_matrices(
    log_trans: torch.Tensor, log_emit: torch.Tensor, src_len: torch.Tensor
) -> torch.Tensor:
    """Per-step transition matrices M_t (t >= 1) for the scan as a matrix
    product: M_t[s, s'] = trans[s, s'] + emit[t, s'], with the identity
    (0 on the diagonal, NEG_INF off it) past an utterance's length, so prefix
    products freeze as ``forward``'s carry does.  Returns [Ts-1, N, S, S]."""
    n, ts, s = log_emit.shape
    alive = torch.arange(1, ts, device=log_emit.device)[:, None] < src_len[None, :]
    m = log_trans[None] + log_emit[:, 1:, None, :].transpose(0, 1)
    eye = torch.eye(s, dtype=torch.bool, device=log_emit.device)
    eye = torch.where(eye, 0.0, NEG_INF).to(log_emit.dtype)
    return torch.where(alive[:, :, None, None], m, eye)


def associative_scan(fn, elems: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``elems`` along dim 0 with the associative ``fn``
    (``fn(earlier, later)``): the odd/even recursion of
    ``jax.lax.associative_scan``, O(log T) deep.  ``fn`` gets the even and
    odd elements as strided views of ``elems`` (step 2 along dim 0)."""
    num = elems.shape[0]
    if num < 2:
        return elems
    odd = associative_scan(fn, fn(elems[0:-1:2], elems[1::2]))
    if num % 2 == 0:
        even = fn(odd[:-1], elems[2::2])
    else:
        even = fn(odd, elems[2::2])
    out = torch.empty_like(elems)
    out[0] = elems[0]
    out[2::2] = even
    out[1::2] = odd
    return out


def _semiring_matmul(use_kernels: bool | None, device: torch.device):
    """The combine of the matrix-product forwards: K8 (``ops/log_semiring``)
    with ``use_kernels`` (None: on a CUDA device), else its plain version."""
    if kernels_for(use_kernels, device):
        return semiring_ops.log_matmul
    return log_matmul


def forward_associative(
    log_init: torch.Tensor,   # [N, S]
    log_trans: torch.Tensor,  # [N, S, S]
    log_emit: torch.Tensor,   # [N, Ts, S]
    src_len: torch.Tensor,    # [N]
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Forward pass as an associative scan over log-semiring matrix
    products: alpha_t = alpha_{t-1} (x) M_t, every prefix product of the
    step matrices in O(log Ts) depth at O(Ts S^3) work (the sequential
    ``forward`` is O(Ts S^2)).  The combine is K8 with ``use_kernels`` (None:
    on a CUDA device), its plain version otherwise.  Returns (alphas [Ts, N,
    S], logZ [N]) with ``forward``'s masking: steps past src_len carry
    alpha, and a zero-length utterance has logZ = 0."""
    m = step_matrices(log_trans, log_emit, src_len)  # [Ts-1, N, S, S]
    prefixes = associative_scan(_semiring_matmul(use_kernels, log_emit.device), m)
    alpha0 = log_init + log_emit[:, 0]  # [N, S]
    rest = masked_logsumexp(alpha0[None, :, :, None] + prefixes, dim=2)  # [Ts-1, N, S]
    alphas = torch.cat([alpha0[None], rest], dim=0)
    logz = masked_logsumexp(alphas[-1], dim=-1)
    return alphas, torch.where(src_len > 0, logz, 0.0)


def forward_blocked(
    log_init: torch.Tensor,
    log_trans: torch.Tensor,
    log_emit: torch.Tensor,
    src_len: torch.Tensor,
    block: int = 16,
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Blocked log-semiring forward: time splits into blocks of ``block``
    steps; within each block every prefix product of the step matrices
    comes from an associative scan (its combine K8 with ``use_kernels``),
    the sequential recursion runs only across the block boundaries, and the
    alphas inside each block come from one vector-matrix contraction per
    step, all blocks at once.  Work O(Ts N S^3), depth O(Ts/block + log
    block).  Same outputs and masking as ``forward``."""
    n, ts, s = log_emit.shape
    m = step_matrices(log_trans, log_emit, src_len)  # [Ts-1, N, S, S]
    nsteps = ts - 1
    nb = -(-nsteps // block)
    pad = nb * block - nsteps
    if pad:
        eye = torch.eye(s, dtype=torch.bool, device=m.device)
        eye = torch.where(eye, 0.0, NEG_INF).to(m.dtype)
        m = torch.cat([m, eye.expand(pad, n, s, s)], dim=0)
    # the block's steps first, (block index, utterance) as one batch
    # dimension: one copy, after which the scan's slices are strided views
    mb = m.reshape(nb, block, n, s, s).transpose(0, 1).reshape(block, nb * n, s, s)
    prefixes = associative_scan(_semiring_matmul(use_kernels, log_emit.device), mb)
    prefixes = prefixes.reshape(block, nb, n, s, s).transpose(0, 1)  # [nb, block, N, S, S]
    totals = prefixes[:, -1]  # whole-block products

    alpha0 = log_init + log_emit[:, 0]  # [N, S]
    bounds = [alpha0]  # alpha entering each block
    for total in totals[:-1]:
        bounds.append(masked_logsumexp(bounds[-1][:, :, None] + total, dim=1))
    bounds = torch.stack(bounds)[:nb]  # [nb, N, S]
    rest = masked_logsumexp(bounds[:, None, :, :, None] + prefixes, dim=3)  # [nb, block, N, S]
    rest = rest.reshape(nb * block, n, s)[:nsteps]
    alphas = torch.cat([alpha0[None], rest], dim=0)
    logz = masked_logsumexp(alphas[-1], dim=-1)
    return alphas, torch.where(src_len > 0, logz, 0.0)


def estep(
    log_jump: torch.Tensor,
    log_p0: torch.Tensor,
    max_jump: int,
    log_emit: torch.Tensor,
    corpus: Corpus,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared HMM E-step for every Vogel-transition aligner (discrete,
    Gaussian, DNN-hybrid emissions differ only in ``log_emit``).

    Returns (gamma [N, Ts, S] state posteriors, width_counts [2*max_jump+3]
    expected jump counts (..., p0 slot, impossible slot), logz [N]).

    ``use_kernels=True`` routes through K4, the general E-step kernel
    (``ops/hmm_fwdbwd.hmm_estep``: its plain version on a CPU corpus), in
    ``dot_dtype`` (``"bfloat16"``: K4-bf16); the dense plain path below is
    its oracle and, like the reference's scan path, ignores ``dot_dtype``.
    None means True on a CUDA corpus.  All outputs are additive across
    corpus shards.
    """
    if kernels_for(use_kernels, corpus.device):
        base, rowz, colmask = factor_log_trans(log_jump, log_p0, corpus, max_jump)
        gamma, xi_pooled, logz = hmm_fwdbwd.hmm_estep(
            build_log_init(log_p0, corpus), base, rowz, colmask, log_emit,
            corpus.src_len, dot_dtype,
        )
        return gamma, project_widths(xi_pooled, corpus.max_trg_len, max_jump), logz

    n, ts, s = log_emit.shape
    log_init = build_log_init(log_p0, corpus)
    log_trans = build_log_trans(log_jump, log_p0, corpus, max_jump)
    alphas, logz = forward(log_init, log_trans, log_emit, corpus.src_len)
    betas = backward(log_trans, log_emit, corpus.src_len)

    smask = state_mask(corpus)  # [N, S]
    tmask = lengths_to_mask(corpus.src_len, ts)  # [N, Ts]
    logz_safe = torch.where(logz > NEG_INF / 2, logz, 0.0)

    log_gamma = alphas + betas - logz_safe[None, :, None]
    valid = tmask.T[:, :, None] & smask[None, :, :]
    gamma = torch.where(valid, torch.exp(log_gamma), 0.0)  # [Ts, N, S]

    xi_pooled = torch.zeros((s, s), dtype=log_emit.dtype, device=log_emit.device)
    for t in range(ts - 1):
        logxi = (
            alphas[t][:, :, None]
            + log_trans
            + (log_emit[:, t + 1] + betas[t + 1])[:, None, :]
            - logz_safe[:, None, None]
        )
        alive = ((t + 1) < corpus.src_len)[:, None, None]
        xi = torch.where(alive, torch.exp(torch.clamp(logxi, max=0.0)), 0.0)
        xi_pooled = xi_pooled + xi.sum(dim=0)

    width_counts = project_widths(xi_pooled, corpus.max_trg_len, max_jump)
    return gamma.transpose(0, 1), width_counts, logz


def project_widths(
    xi_pooled: torch.Tensor, tt_max: int, max_jump: int
) -> torch.Tensor:
    """Pooled transition posteriors [S, S] -> expected jump-width counts
    [2*max_jump+3] (..., p0 slot, impossible slot)."""
    onehot = _width_onehot(tt_max, max_jump, xi_pooled.device, xi_pooled.dtype)
    return (xi_pooled.reshape(1, -1) @ onehot)[0]


@functools.lru_cache(maxsize=16)
def _width_onehot(tt_max: int, max_jump: int, device, dtype) -> torch.Tensor:
    """[S*S, 2*max_jump+3] one-hot of ``jump_width_ids``: ``project_widths``'
    fixed operand, built once per shape (``core.counts.segment_sum``'s form,
    the same bits in every run)."""
    ids = jump_width_ids(tt_max, max_jump, device).reshape(-1)
    return (ids[:, None] == torch.arange(2 * max_jump + 3, device=device)).to(dtype)


def posteriors_from(
    log_init: torch.Tensor,   # [N, S]
    log_trans: torch.Tensor,  # [N, S, S]
    log_emit: torch.Tensor,   # [N, Ts, S]
    corpus: Corpus,
) -> torch.Tensor:
    """State posteriors [N, Ts, S] from assembled machinery (shared by the
    per-model ``posteriors`` wrappers)."""
    alphas, logz = forward(log_init, log_trans, log_emit, corpus.src_len)
    betas = backward(log_trans, log_emit, corpus.src_len)
    logz_safe = torch.where(logz > NEG_INF / 2, logz, 0.0)
    gamma = torch.exp(alphas + betas - logz_safe[None, :, None])
    valid = (
        lengths_to_mask(corpus.src_len, log_emit.shape[1]).T[:, :, None]
        & state_mask(corpus)[None, :, :]
    )
    return torch.where(valid, gamma, 0.0).transpose(0, 1)


def viterbi(
    log_init: torch.Tensor,   # [N, S]
    log_trans: torch.Tensor,  # [N, S, S]
    log_emit: torch.Tensor,   # [N, Ts, S]
    src_len: torch.Tensor,    # [N]
) -> torch.Tensor:
    """Batched Viterbi decode from dense transitions -> state path [N, Ts]
    int32 (frozen-carry states past src_len).

    One max-plus step with backpointers per time step, batched over N, then
    one backtrace step per time step.  Past an utterance's length delta is
    kept and the backpointer is the identity.  The backpointer is
    ``torch.argmax``'s first maximum, as ``jnp.argmax`` gives it.  Plain
    torch on every device: the oracle of ``viterbi_factored`` and K3."""
    n, ts, s = log_emit.shape
    ident = torch.arange(s, device=log_emit.device).expand(n, s)
    delta = log_init + log_emit[:, 0]
    bps = []
    for t in range(1, ts):
        x = delta[:, :, None] + log_trans  # [N, S_prev, S]
        best = torch.amax(x, dim=1) + log_emit[:, t]
        alive = (t < src_len)[:, None]
        delta = torch.where(alive, best, delta)
        bps.append(torch.where(alive, torch.argmax(x, dim=1), ident))
    state = torch.argmax(delta, dim=-1)  # [N]
    states = [state]
    for bp in reversed(bps):
        state = bp.gather(1, state[:, None])[:, 0]
        states.append(state)
    return torch.stack(states[::-1], dim=1).to(torch.int32)


def viterbi_factored(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    log_emit: torch.Tensor,  # [N, Ts, S]
    src_len: torch.Tensor,   # [N]
    use_kernels: bool | None = None,
) -> torch.Tensor:
    """Viterbi decode from factored transitions -> state path [N, Ts] int32
    (frozen-carry states past src_len).  ``use_kernels=True`` routes through
    K3 (``ops/viterbi.viterbi``: its plain version on a CPU corpus), and
    None means True on CUDA tensors; the plain decoder never builds the
    [N, S, S] transition tensor outside one step.  Ties resolve to the
    lowest state index, as in the reference."""
    if kernels_for(use_kernels, log_emit.device):
        decode = viterbi_ops.viterbi
    else:
        decode = viterbi_ops.viterbi_plain
    return decode(log_init, base, rowz, colmask, log_emit, src_len)


def path_to_alignment(path: torch.Tensor, corpus: Corpus) -> torch.Tensor:
    """State path [N, Ts] -> alignment [N, Ts] int32 (0 = NULL, else 1-based pos)."""
    tt_max = corpus.max_trg_len
    a = torch.where(path >= tt_max, 0, path % tt_max + 1).to(torch.int32)
    return torch.where(corpus.src_mask(), a, 0).to(torch.int32)
