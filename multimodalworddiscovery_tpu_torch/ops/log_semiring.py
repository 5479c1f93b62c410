"""K8: batched log-semiring matrix product kernel, and its plain versions.

out[..., i, j] = logsumexp_k a[..., i, k] + b[..., k, j].

Replaces ``multimodalworddiscovery_tpu/ops/log_semiring.py:log_matmul_pallas``
(body ``_kernel``).  CUDA source: ``csrc/log_semiring.cu``.  The reference
kernel is rank-2 and vmapped; this one is batched: ``[..., I, K] x [..., K,
J] -> [..., I, J]``, leading dimensions broadcast, and a rank-2 call is a
batch of one.

``dot_dtype="float32"`` gives what the broadcast oracle
(``core/logsemiring.log_matmul``) gives, on every input.  The kernel takes
the factored form, exp(A - M) @ exp(B - N) with each row's maximum M and
each column's N over all of K (2 I J K fp32 FMAs, (I + J) K exps), and an
underflow guard: an element whose sum falls below ``guard_threshold(K)``,
where the terms the form flushed to 0 could matter, is summed again term by
term (the trap of the factored form, on rows that span more than ~87 nats).
The elements that took the guard are counted on the card
(``guard_counts``).  ``dot_dtype="bfloat16"`` is the reference's factored
form: per K tile of ``BLOCK_K`` the row and column maxima, exp(A - m_a) and
exp(B - m_b) rounded to bf16, their product summed in float32 (on the
tensor cores), and the running combine; ``log_matmul_plain(...,
"bfloat16")`` is the same arithmetic in torch.  What bounds each variant on
the H100 is in the CUDA source's header.

The kernel takes two strided batch dimensions over row-major matrices, so
the wrapper hands it views whose leading dimensions merge into at most two
(a strided slice along the time axis of a contiguous [T, N, S, S] tensor
does, as the associative scan's even / odd slices are) and makes a
contiguous copy of anything else.
"""

from __future__ import annotations

import torch

from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.core.logsemiring import log_matmul as log_matmul_f32
from multimodalworddiscovery_tpu_torch.ops import _build

BLOCK_K = 128  # csrc/log_semiring.cu MWD_LM_TK: the K tile of the bf16 variant's maxima
DOT_DTYPES = ("float32", "bfloat16")


def guard_threshold(nk: int) -> float:
    """The float32 kernel's guard: below this sum (in units of exp(M_i +
    N_j)) an element is summed again term by term.  Each of the K terms the
    factored form flushes, and each rounding of its K FMAs, loses less than
    2^-126, so above K 2^-101 what was lost is under 2^-24 of the sum."""
    return float(max(nk, 1)) * 2.0**-101


_guarded: dict[torch.device, torch.Tensor] = {}


def _guard_counter(device) -> torch.Tensor:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device not in _guarded:
        _guarded[device] = torch.zeros((2,), dtype=torch.int64, device=device)
    return _guarded[device]


def guard_counts(device) -> tuple[int, int]:
    """Output elements that took the float32 kernel's guard on ``device``
    since the last ``reset_guard``, and of them those summed again term by
    term (their row and column have a live k in common; the rest, a banded
    product's zero-support elements, leave at once as NEG_INF).  Reads the
    card's counters."""
    took, summed = _guard_counter(device).tolist()
    return took, summed


def reset_guard(device) -> None:
    _guard_counter(device).zero_()


def _is_bf16(dot_dtype: str) -> bool:
    if dot_dtype not in DOT_DTYPES:
        raise ValueError(f"dot_dtype must be one of {DOT_DTYPES}, got {dot_dtype!r}")
    return dot_dtype == "bfloat16"


def _safe(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > NEG_INF / 2, x, 0.0)


def _log_matmul_factored_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference kernel's bf16 arithmetic (``ops/log_semiring.py:_kernel``
    with ``bf16=True``) over K tiles of ``BLOCK_K``, batched: a [B, I, K],
    b [B, K, J] -> [B, I, J]."""
    nk, block_k = a.shape[-1], BLOCK_K
    pad = (-nk) % block_k
    a = torch.nn.functional.pad(a, (0, pad), value=NEG_INF)
    b = torch.nn.functional.pad(b, (0, 0, 0, pad), value=NEG_INF)
    m = torch.full((a.shape[0], a.shape[1], b.shape[2]), NEG_INF, dtype=a.dtype,
                   device=a.device)
    acc = torch.zeros_like(m)
    for k0 in range(0, nk + pad, block_k):
        at, bt = a[:, :, k0:k0 + block_k], b[:, k0:k0 + block_k, :]
        m_a, m_b = at.amax(dim=2, keepdim=True), bt.amax(dim=1, keepdim=True)
        p = torch.exp(at - _safe(m_a)).to(torch.bfloat16).float()
        q = torch.exp(bt - _safe(m_b)).to(torch.bfloat16).float()
        s_t = p @ q  # bf16 x bf16 products are exact in float32
        m_t = torch.where((m_a > NEG_INF / 2) & (m_b > NEG_INF / 2),
                          _safe(m_a) + _safe(m_b), NEG_INF)
        m_new = torch.maximum(m, m_t)
        m_new_safe = _safe(m_new)
        acc = (acc * torch.exp(torch.where(m > NEG_INF / 2, m, NEG_INF) - m_new_safe)
               + s_t * torch.exp(torch.where(m_t > NEG_INF / 2, m_t, NEG_INF) - m_new_safe))
        m = m_new
    return torch.where((m > NEG_INF / 2) & (acc > 0),
                       m + torch.log(torch.clamp(acc, min=1e-38)), NEG_INF)


def log_matmul_plain(a: torch.Tensor, b: torch.Tensor, dot_dtype: str = "float32") -> torch.Tensor:
    """K8's plain versions: the broadcast oracle in float32, the factored
    form over the kernel's K tiles in bfloat16."""
    if not _is_bf16(dot_dtype):
        return log_matmul_f32(a, b)
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    ni, nk = a.shape[-2:]
    nj = b.shape[-1]
    out = _log_matmul_factored_bf16(a.expand(*batch, ni, nk).reshape(-1, ni, nk),
                                    b.expand(*batch, nk, nj).reshape(-1, nk, nj))
    return out.reshape(*batch, ni, nj)


def _rows_contiguous(x: torch.Tensor) -> bool:
    r, c = x.shape[-2:]
    return (x.stride(-1) == 1 or c <= 1) and (x.stride(-2) == c or r <= 1)


def _batch_layout(batch, a: torch.Tensor, b: torch.Tensor):
    """[(size, a stride, b stride)] of the batch dimensions, two entries,
    adjacent dimensions merged where both operands allow; None if more than
    two remain."""
    dims = []
    for size, sa, sb in zip(batch, a.stride()[:-2], b.stride()[:-2]):
        if size == 1:
            continue
        if dims and dims[-1][1] == sa * size and dims[-1][2] == sb * size:
            dims[-1] = (dims[-1][0] * size, sa, sb)
        else:
            dims.append((size, sa, sb))
    if len(dims) > 2:
        return None
    return [(1, 0, 0)] * (2 - len(dims)) + dims


def log_matmul(a: torch.Tensor, b: torch.Tensor, dot_dtype: str = "float32") -> torch.Tensor:
    """[..., I, K] x [..., K, J] -> [..., I, J] in the log semiring.  CPU
    tensors take ``log_matmul_plain``; CUDA tensors (float32) launch the
    kernel."""
    bf16 = _is_bf16(dot_dtype)
    if a.device.type == "cpu":
        return log_matmul_plain(a, b, dot_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"log_matmul runs on cpu or cuda, got {a.device}")
    dev = a.device
    if b.device != dev:
        raise ValueError(f"b is on {b.device}, expected {dev}")
    for name, x in (("a", a), ("b", b)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
        if x.dim() < 2:
            raise ValueError(f"{name} must have at least 2 dimensions, got {tuple(x.shape)}")
    ni, nk = a.shape[-2:]
    if b.shape[-2] != nk:
        raise ValueError(f"inner dimensions differ: a {tuple(a.shape)}, b {tuple(b.shape)}")
    nj = b.shape[-1]
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a, b = a.expand(*batch, ni, nk), b.expand(*batch, nk, nj)
    if not _rows_contiguous(a):
        a = a.contiguous()
    if not _rows_contiguous(b):
        b = b.contiguous()
    layout = _batch_layout(batch, a, b)
    if layout is None:
        a, b = a.contiguous(), b.contiguous()
        layout = _batch_layout(batch, a, b)
    (nb1, sa1, sb1), (nb2, sa2, sb2) = layout
    out = torch.empty((*batch, ni, nj), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _build.load()
    n_work = int(lib.mwd_log_matmul_work(nb1, nb2, ni, nk, nj, int(bf16)))
    work = torch.empty((n_work,), dtype=torch.float32, device=dev) if n_work else None
    with torch.cuda.device(dev):
        status = lib.mwd_log_matmul(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), work.data_ptr() if n_work else None,
            _guard_counter(dev).data_ptr(), nb1, nb2, ni, nk, nj, sa1, sa2, sb1, sb2,
            int(bf16), guard_threshold(nk), torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_log_matmul")
    if bf16:
        log_matmul.launches_bf16 += 1
    else:
        log_matmul.launches += 1
        log_matmul.elements += out.numel()
    return out


log_matmul.launches = 0
log_matmul.launches_bf16 = 0
log_matmul.elements = 0  # output elements of the float32 launches (the guard's share)
