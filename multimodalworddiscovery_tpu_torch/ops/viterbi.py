"""K3: Viterbi decode kernel over factored transitions, and its plain version.

Replaces ``multimodalworddiscovery_tpu/ops/viterbi_pallas.py:viterbi_pallas``
(``_vit_fwd_kernel`` then ``_vit_bwd_kernel``).  CUDA source:
``csrc/viterbi.cu``.

The recursion is delta'[s'] = max_s(delta[s] - rowz[s] + base[s, s']) +
colmask[s'] + emit[t, s'], frozen past each utterance's length, then a
backtrace from the argmax of the last delta.  What bounds it on the H100
is latency and the issue of the max-plus terms: the recursion is
sequential in time.  The kernel takes the utterances in length order
(ranked on the card, ``csrc/order.cuh``), several a warp (S <= 32: one lane
a state, no barriers) or a block (S > 32: each thread one state for four or
eight utterances, one load of base for all of them, a state's max split
into exact chains where threads are to spare), each stopping at its
longest; base sits in shared memory where it fits, the backpointers (uint8
up to S = 256 states, uint16 above, S <= 65536) too, else in the
workspace in device memory, and one thread per utterance walks the
backtrace (see ``csrc/viterbi.cu``'s header).  Sums are taken in the plain
decoder's order and ties go to the lowest state, so both give the same
path.
"""

from __future__ import annotations

import functools

import torch

from multimodalworddiscovery_tpu_torch.ops import _build


def viterbi_plain(
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    log_emit: torch.Tensor,  # [N, Ts, S]
    src_len: torch.Tensor,   # [N]
) -> torch.Tensor:
    """Batched decode, one torch step per time step -> path [N, Ts] int32
    (frozen-carry states past src_len).  Never builds the [N, S, S]
    transition tensor outside one step; backpointers are int8 when S < 128.
    Ties resolve to the lowest state index."""
    n, ts, s = log_emit.shape
    bp_dtype = torch.int8 if s < 128 else torch.int32
    ident = torch.arange(s, device=log_emit.device).to(bp_dtype).expand(n, s)
    delta = log_init + log_emit[:, 0]
    bps = []
    for t in range(1, ts):
        x = (delta - rowz)[:, :, None] + base[None, :, :]  # [N, S_prev, S]
        best, bp = torch.max(x, dim=1)
        best = best + colmask + log_emit[:, t]
        alive = (t < src_len)[:, None]
        delta = torch.where(alive, best, delta)
        bps.append(torch.where(alive, bp.to(bp_dtype), ident))

    state = torch.argmax(delta, dim=-1)  # [N]
    states = [state]
    for bp in reversed(bps):
        state = bp.long().gather(1, state[:, None])[:, 0]
        states.append(state)
    return torch.stack(states[::-1], dim=1).to(torch.int32)


def path_score(
    path: torch.Tensor,      # [N, Ts] int
    log_init: torch.Tensor,  # [N, S]
    base: torch.Tensor,      # [S, S]
    rowz: torch.Tensor,      # [N, S]
    colmask: torch.Tensor,   # [N, S]
    log_emit: torch.Tensor,  # [N, Ts, S]
    src_len: torch.Tensor,   # [N]
) -> torch.Tensor:
    """[N] float64 score of each utterance's state path under the factored
    transitions (0 for zero-length utterances).  Two decoders may break an
    exact tie differently; their paths' scores still agree."""
    p = path.long()
    log_init, base, rowz, colmask, log_emit = (
        x.double() for x in (log_init, base, rowz, colmask, log_emit)
    )
    tmask = torch.arange(p.shape[1], device=p.device)[None, :] < src_len[:, None]
    score = log_init.gather(1, p[:, :1])[:, 0] + log_emit[:, 0].gather(1, p[:, :1])[:, 0]
    step = (base[p[:, :-1], p[:, 1:]] - rowz.gather(1, p[:, :-1])
            + colmask.gather(1, p[:, 1:]) + log_emit[:, 1:].gather(2, p[:, 1:, None])[..., 0])
    step = torch.where(tmask[:, 1:], step, 0.0).sum(1)
    return torch.where(src_len > 0, score + step, 0.0)


@functools.lru_cache(maxsize=64)
def _work_bytes(n: int, ts: int, s: int) -> int:
    return int(_build.load().mwd_viterbi_work(n, ts, s))


def viterbi(
    log_init: torch.Tensor,  # [N, S] float32
    base: torch.Tensor,      # [S, S] float32
    rowz: torch.Tensor,      # [N, S] float32
    colmask: torch.Tensor,   # [N, S] float32
    log_emit: torch.Tensor,  # [N, Ts, S] float32
    src_len: torch.Tensor,   # [N] int32
) -> torch.Tensor:
    """State path [N, Ts] int32.  CPU tensors take ``viterbi_plain``; CUDA
    tensors run the kernel (one C call: the length order, then the decode);
    a batch of no utterances launches nothing."""
    if log_emit.device.type == "cpu":
        return viterbi_plain(log_init, base, rowz, colmask, log_emit, src_len)
    if log_emit.device.type != "cuda":
        raise ValueError(f"viterbi runs on cpu or cuda, got {log_emit.device}")
    dev = log_emit.device
    n, ts, s = log_emit.shape
    if s < 1 or ts < 1:
        raise ValueError(f"the Viterbi kernel takes S >= 1 states and Ts >= 1, got S={s}, Ts={ts}")
    f32 = torch.float32
    _build.require(log_init, "log_init", f32, (n, s), dev)
    _build.require(base, "base", f32, (s, s), dev)
    _build.require(rowz, "rowz", f32, (n, s), dev)
    _build.require(colmask, "colmask", f32, (n, s), dev)
    _build.require(log_emit, "log_emit", f32, (n, ts, s), dev)
    _build.require(src_len, "src_len", torch.int32, (n,), dev)

    path = torch.empty((n, ts), dtype=torch.int32, device=dev)
    if n == 0:
        return path
    with torch.cuda.device(dev):
        work = torch.empty((_work_bytes(n, ts, s),), dtype=torch.uint8, device=dev)
        status = _build.load().mwd_viterbi(
            base.data_ptr(), log_init.data_ptr(), rowz.data_ptr(),
            colmask.data_ptr(), log_emit.data_ptr(), src_len.data_ptr(),
            path.data_ptr(), work.data_ptr(), n, ts, s,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(status, "mwd_viterbi")
    viterbi.launches += 1
    return path


viterbi.launches = 0
