"""Sequence (time-axis) parallel HMM forward and full E-step over a mesh.

Counterpart of ``multimodalworddiscovery_tpu/parallel/sequence.py``.  The
forward recursion is a log-semiring matrix product (see
``hmm_core.forward_associative``), so rank d composes the product of its
time chunk's step matrices, one all_gather of the [W, N, S, S] chunk
products closes the chain, and the exclusive prefix, the exclusive suffix
and the total of those products give every rank its entering alpha, its
leaving beta and logZ:

  per rank d:  P_d = M_{t in chunk d} composed            (log-depth tree)
               alpha_in(d) = alpha_0 (x) P_0 (x) ... (x) P_{d-1}
               beta_out(d) = P_{d+1} (x) ... (x) P_{W-1} applied to 0s
               local alphas, betas, gamma and xi           (plain recursions)
               xi pooled by one all_reduce

The step matrices carry the identity at t = 0 and past each utterance's
length (``hmm_core.step_matrices``), so every chunk holds Ts/W of them and
the masking is ``hmm_core.forward``'s.  The combine is
``hmm_core._semiring_matmul(use_kernels, device)``: K8 on the card, its
plain version on the CPU.  The local recursions stay torch, as in the
reference.  Every rank takes the whole (replicated) inputs and builds only
its own chunk's matrices; Ts must divide over the ranks (pad upstream).
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, gather, group_of
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF, masked_logsumexp
from multimodalworddiscovery_tpu_torch.core.mesh import check_mesh
from multimodalworddiscovery_tpu_torch.models import hmm_core

SEQ_AXIS = "seq"


def _log_eye(s: int, like: torch.Tensor) -> torch.Tensor:
    eye = torch.eye(s, dtype=torch.bool, device=like.device)
    return torch.where(eye, 0.0, NEG_INF).to(like.dtype)


def _chunk(log_emit: torch.Tensor, mesh) -> tuple[int, int]:
    ts = log_emit.shape[1]
    w = check_mesh(mesh).size()
    if ts % w:
        raise ValueError(f"Ts={ts} must divide over {w} ranks (pad upstream)")
    d = mesh.get_local_rank()
    return d * (ts // w), (d + 1) * (ts // w)


def _chunk_matrices(log_trans, log_emit, src_len, lo: int, hi: int) -> torch.Tensor:
    """[hi - lo, N, S, S]: M_t for t in [lo, hi), M_0 the identity."""
    n, _, s = log_emit.shape
    if lo == 0:
        eye = _log_eye(s, log_emit).expand(1, n, s, s)
        return torch.cat([eye, hmm_core.step_matrices(log_trans, log_emit[:, :hi], src_len)])
    # the slice starts at t = lo - 1, so its step i is global step lo + i
    return hmm_core.step_matrices(log_trans, log_emit[:, lo - 1:hi], src_len - (lo - 1))


def _product(mm, m: torch.Tensor) -> torch.Tensor:
    """m[0] (x) m[1] (x) ... (x) m[L-1], a pairwise tree of batched combines."""
    while m.shape[0] > 1:
        pairs = mm(m[0:-1:2], m[1::2])
        m = torch.cat([pairs, m[-1:]]) if m.shape[0] % 2 else pairs
    return m[0]


def _fold(mm, mats) -> torch.Tensor | None:
    """The product of ``mats`` in order (None for none)."""
    out = None
    for p in mats:
        out = p if out is None else mm(out, p)
    return out


def _apply(alpha: torch.Tensor, p: torch.Tensor | None) -> torch.Tensor:
    """alpha (x) P: the [N, S] vector after the product ``p``."""
    return alpha if p is None else masked_logsumexp(alpha[:, :, None] + p, dim=1)


def _boundaries(log_init, log_emit, m_chunk, src_len, mesh, use_kernels):
    """(alpha0, prefix, suffix, logz): the exclusive prefix and suffix of
    the gathered chunk products (None where empty) and logZ."""
    group = group_of(mesh)
    mm = hmm_core._semiring_matmul(use_kernels, log_emit.device)
    p_local = _product(mm, m_chunk)
    p_all = gather(p_local, group)  # [W, N, S, S]
    d, w = mesh.get_local_rank(), mesh.size()
    prefix = _fold(mm, p_all[:d])
    suffix = _fold(mm, p_all[d + 1:])
    total = _fold(mm, [p for p in (prefix, p_local, suffix) if p is not None])
    alpha0 = log_init + log_emit[:, 0]
    logz = masked_logsumexp(_apply(alpha0, total), dim=-1)
    return alpha0, prefix, suffix, torch.where(src_len > 0, logz, 0.0)


def _local_alphas(alpha_in: torch.Tensor, m_chunk: torch.Tensor) -> torch.Tensor:
    alphas, alpha = [], alpha_in
    for m_t in m_chunk:
        alpha = masked_logsumexp(alpha[:, :, None] + m_t, dim=1)
        alphas.append(alpha)
    return torch.stack(alphas)


def forward_time_sharded(
    log_init: torch.Tensor,   # [N, S] (replicated)
    log_trans: torch.Tensor,  # [N, S, S] (replicated)
    log_emit: torch.Tensor,   # [N, Ts, S] (replicated); Ts divides the mesh size
    src_len: torch.Tensor,    # [N] (replicated)
    mesh,                     # a 1-D mesh, its axis SEQ_AXIS by convention
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(this rank's alphas [Ts/W, N, S] at t in [d Ts/W, (d+1) Ts/W), logZ
    [N] on every rank): ``hmm_core.forward``'s, with its masking."""
    lo, hi = _chunk(log_emit, mesh)
    m_chunk = _chunk_matrices(log_trans, log_emit, src_len, lo, hi)
    alpha0, prefix, _, logz = _boundaries(log_init, log_emit, m_chunk, src_len, mesh,
                                          use_kernels)
    return _local_alphas(_apply(alpha0, prefix), m_chunk), logz


def estep_time_sharded(
    log_init: torch.Tensor,   # [N, S] (replicated)
    log_trans: torch.Tensor,  # [N, S, S] (replicated)
    log_emit: torch.Tensor,   # [N, Ts, S] (replicated); Ts divides the mesh size
    src_len: torch.Tensor,    # [N] (replicated)
    smask: torch.Tensor,      # [N, S] state validity (hmm_core.state_mask)
    mesh,                     # a 1-D mesh, its axis SEQ_AXIS by convention
    use_kernels: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full E-step with the time axis sharded over the ranks ->
    (this rank's gamma [N, Ts/W, S], pooled xi [S, S] and logZ [N] on every
    rank), ``hmm_core.estep``'s dense path's on the same (padded) inputs:

      forward:  alpha_in(d) from the exclusive prefix of the chunk products;
      backward: beta_out(d)[s] = logsumexp_s' suffix(d)[s, s'] (the
                exclusive suffix applied to the all-ones vector; identity
                steps past src_len keep beta at 0 as ``backward`` does);
      gamma:    exp(alpha_t + beta_t - logZ) on the local chunk;
      xi:       the transition into local step t from alpha_{t-1}, M_t and
                beta_t, alive iff 1 <= t < src_len; one all_reduce pools it.
    """
    lo, hi = _chunk(log_emit, mesh)
    m_chunk = _chunk_matrices(log_trans, log_emit, src_len, lo, hi)
    alpha0, prefix, suffix, logz = _boundaries(log_init, log_emit, m_chunk, src_len, mesh,
                                               use_kernels)
    logz_safe = torch.where(logz > NEG_INF / 2, logz, 0.0)
    alpha_in = _apply(alpha0, prefix)
    alphas = _local_alphas(alpha_in, m_chunk)  # [L, N, S]
    beta = (torch.zeros_like(alpha0) if suffix is None
            else masked_logsumexp(suffix, dim=2))
    betas = [beta]
    for m_t in m_chunk.flip(0)[:-1]:
        beta = masked_logsumexp(m_t + beta[:, None, :], dim=2)
        betas.append(beta)
    betas = torch.stack(betas[::-1])  # [L, N, S]

    t = torch.arange(lo, hi, device=log_emit.device)
    tmask = t[:, None] < src_len[None, :]  # [L, N]
    valid = tmask[:, :, None] & smask[None]
    log_gamma = alphas + betas - logz_safe[None, :, None]
    gamma = torch.where(valid, torch.exp(torch.clamp(log_gamma, max=0.0)), 0.0)

    alive = (t[:, None] >= 1) & tmask
    xi = torch.zeros_like(log_trans[0])
    prev = alpha_in
    for i in range(hi - lo):
        logxi = (prev[:, :, None] + m_chunk[i] + betas[i][:, None, :]
                 - logz_safe[:, None, None])
        xi = xi + torch.where(alive[i][:, None, None],
                              torch.exp(torch.clamp(logxi, max=0.0)), 0.0).sum(dim=0)
        prev = alphas[i]
    return gamma.transpose(0, 1), all_sum(xi, group_of(mesh)), logz
