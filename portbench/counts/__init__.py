"""Operations and bytes of each kernel and of a whole step, counted from
the inputs' shapes and lengths, and the published peaks of one H100 (SXM,
dense rates, at its full power limit of 700 W).

Copied in substance from the port's ``scripts/bench_kernels.py`` (``bound``,
``estep_bound``, and the K3 / K7 bounds of its ``viterbi`` and ``counts``
entries), with one change: work is counted over each utterance's own
states and steps (S_n = 2 * concepts of image n, len_n steps), what the
inputs need, and bytes over the valid (step, state) entries a kernel must
read or write, so a share of the roofline never counts padding as work.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def bound_ms(nbytes: float, ops: float) -> float:
    """The least time one H100 could take: bytes over its memory rate or
    float32 operations over the float32 rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3


def _np(x):
    return np.asarray(x, dtype=np.float64)


def state_steps(src_len, trg_len) -> tuple[float, float]:
    """(sum of len_n * S_n, sum of len_n * S_n^2) with S_n = 2 * trg_len_n."""
    s = 2 * _np(trg_len)
    ln = _np(src_len)
    return float((ln * s).sum()), float((ln * s * s).sum())


def estep_ops(src_len, trg_len) -> float:
    """The E-step's 7 S^2 operations per utterance-step: the forward, the
    backward and xi's products (2 + 2 + 2) and xi's multiply."""
    return 7.0 * state_steps(src_len, trg_len)[1]


def k2_bound_ms(src_len, trg_len, n, ts, tt, v_src, v_trg) -> float:
    """K2: K1's emissions read at the valid entries, the ids, lengths and
    the [S, S] factors read, the counts written once."""
    entries, _ = state_steps(src_len, trg_len)
    nbytes = 4 * (entries + n * ts + n * tt + 4 * n * 2 * tt + v_src * v_trg)
    return bound_ms(nbytes, estep_ops(src_len, trg_len))


def k4_bound_ms(src_len, trg_len, n, tt) -> float:
    """K4: the emissions read and gamma written at the valid entries, the
    init, row and column factors read, the pooled xi written."""
    entries, _ = state_steps(src_len, trg_len)
    s = 2 * tt
    nbytes = 4 * (2 * entries + 3 * n * s + n + 2 * s * s)
    return bound_ms(nbytes, estep_ops(src_len, trg_len))


def k7_bound_ms(src_len, trg_len, n, ts, tt, v_src, v_trg) -> float:
    """K7: gamma read at the valid entries, the ids read, the counts
    written; one add an entry."""
    entries, _ = state_steps(src_len, trg_len)
    nbytes = 4 * (entries + n * ts + n * 2 * tt + v_src * v_trg)
    return bound_ms(nbytes, entries)


def k3_bound_ms(src_len, trg_len, n, ts, tt) -> float:
    """K3: the emissions read at the valid entries, the factors read, the
    path written; an add and a max per transition."""
    entries, sq = state_steps(src_len, trg_len)
    s = 2 * tt
    nbytes = 4 * (entries + 3 * n * s + s * s + 2 * n * ts)
    return bound_ms(nbytes, 2.0 * sq)


def gauss_product_ops(frames: float, feat_dim: int, n_states: int) -> float:
    """The Gaussian E-step's four float32 products over the valid frames:
    two for the log-densities (x and x^2 against the [C*K, D] parameter
    matrices) and two for the moments (the posteriors against x and x^2)."""
    return 4 * 2.0 * frames * feat_dim * n_states
