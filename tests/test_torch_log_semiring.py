"""K8's plain versions and the matrix-product forward passes vs the JAX
reference.

Inputs come from numpy with a seed and go to both packages as the same
arrays.  The log-semiring product is held to the reference's own bound,
rtol 1e-4 atol 1e-4 (tests/test_log_semiring_pallas.py), against the jnp
oracle and against the Pallas kernel in interpret mode (small shapes only:
interpret mode is slow).  The bf16 variant is held to 5e-2 of float32, the
reference's bound, and to 2e-2 of the reference's bf16 kernel: two
kernels that round exp(A - m_a) and exp(B - m_b) to bf16 from float32
values that differ in their last bits may round an operand each way, one
bf16 ulp (at most 2^-7 relative) on each of a product's two operands,
about 0.016 in log space.  The forwards use the bounds of
tests/test_hmm.py:168-205: logZ rtol 1e-4, alphas rtol 1e-3 atol 1e-3 at
valid (t, state) positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.core.logsemiring import log_matmul as jax_log_matmul
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.ops.log_semiring import log_matmul_pallas
from multimodalworddiscovery_tpu_torch.core import logsemiring as tsemi
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.ops import log_semiring as k8

TOL = dict(rtol=1e-4, atol=1e-4)
BF16_VS_F32 = 5e-2
BF16_VS_BF16 = 2e-2
FWD_TOL = dict(rtol=1e-3, atol=1e-3)
N_EMPTY = 3


def _normal(shape, scale, seed):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(np.float32)


def _pair(i, k, j, scale=5.0, seed=0):
    return _normal((i, k), scale, seed), _normal((k, j), scale, seed + 1)


def _port(a, b, dot_dtype="float32"):
    before = (k8.log_matmul.launches, k8.log_matmul.launches_bf16)
    out = k8.log_matmul(torch.as_tensor(a), torch.as_tensor(b), dot_dtype)
    assert (k8.log_matmul.launches, k8.log_matmul.launches_bf16) == before  # CPU: plain
    return out.numpy()


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 200, 96), (300, 140, 260)])
def test_plain_matches_jnp_oracle(shape):
    a, b = _pair(*shape, seed=sum(shape))
    want = np.asarray(jax_log_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a, b), want, **TOL)


@pytest.mark.parametrize("shape", [(128, 128, 128), (64, 200, 96)])
def test_plain_matches_pallas_kernel(shape):
    a, b = _pair(*shape, seed=sum(shape))
    want = np.asarray(log_matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_allclose(_port(a, b), want, **TOL)


def test_neg_inf_rows_and_columns():
    """A fully masked row of a and column of b give NEG_INF, never nan, as
    in the reference (tests/test_log_semiring_pallas.py:21-33)."""
    a, b = _pair(64, 64, 64, scale=1.0, seed=7)
    a[3, :] = NEG_INF
    b[:, 7] = NEG_INF
    got = _port(a, b)
    assert np.all(np.isfinite(got))
    assert np.all(got[3, :] == NEG_INF) and np.all(got[:, 7] == NEG_INF)
    want = np.asarray(log_matmul_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    mask = want > NEG_INF / 2
    np.testing.assert_array_equal(mask, got > NEG_INF / 2)
    np.testing.assert_allclose(got[mask], want[mask], **TOL)
    bf = _port(a, b, "bfloat16")
    assert np.all(bf[3, :] == NEG_INF) and np.all(bf[:, 7] == NEG_INF)


def test_batched_and_broadcast():
    """A batch of products against the reference's vmapped kernel, and a
    rank-2 a broadcast against a batch of b."""
    a = _normal((4, 48, 40), 1.0, 2)
    b = _normal((4, 40, 56), 1.0, 3)
    f = jax.vmap(lambda x, y: log_matmul_pallas(x, y, interpret=True))
    want = np.asarray(f(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a, b), want, **TOL)
    want = np.asarray(jax_log_matmul(jnp.asarray(a[0]), jnp.asarray(b)))
    np.testing.assert_allclose(_port(a[0], b), want, **TOL)


def test_chunking_leaves_the_values_unchanged(monkeypatch):
    """The plain version builds the broadcast sum a block at a time: blocks
    of matrices, or of rows when one matrix exceeds the budget."""
    a = torch.as_tensor(_normal((3, 20, 30), 5.0, 4))
    b = torch.as_tensor(_normal((3, 30, 25), 5.0, 5))
    whole = tsemi.log_matmul(a, b)
    for budget in (30 * 25 * 4 * 7, 30 * 25 * 4 * 45):  # 7 rows; 2 matrices
        monkeypatch.setattr(tsemi, "LOG_MATMUL_CHUNK_BYTES", budget)
        assert torch.equal(tsemi.log_matmul(a, b), whole)


def _wide_range():
    """Row 0 of a spans 300 nats (0 at k = 0, -300 at most k); its largest
    product a[0, k] + b[k, 0] is -10, at k = 5, where a[0, 5] lies 250 nats
    below the row's maximum.  The other rows and columns are ordinary
    log-probabilities beside -300 entries, as in HMM step matrices."""
    a = np.full((64, 96), -300.0, np.float32)
    b = np.full((96, 48), -300.0, np.float32)
    a[:, :10] = _normal((64, 10), 2.0, 8)
    b[:10, :] = _normal((10, 48), 2.0, 9)
    a[0, :] = -300.0
    a[0, 0], a[0, 5] = 0.0, -250.0
    b[:, 0] = -300.0
    b[0, 0], b[5, 0] = -400.0, 240.0
    return a, b


def test_wide_range_keeps_the_dominant_term():
    """The float32 plain version agrees with the float64 oracle on a row
    whose dominant product lies far below its row and column maxima, where
    the factored form (the bf16 variant's, and the reference kernel's)
    loses it: exp(-250) is 0 in float32."""
    a, b = _wide_range()
    want = torch.logsumexp(torch.as_tensor(a, dtype=torch.float64)[:, :, None]
                           + torch.as_tensor(b, dtype=torch.float64)[None], dim=1).numpy()
    assert abs(want[0, 0] + 10.0) < 1e-6
    got = _port(a, b)
    np.testing.assert_allclose(got, want, **TOL)
    assert abs(_port(a, b, "bfloat16")[0, 0] - want[0, 0]) > 1.0


def test_plain_bf16_matches_pallas_bf16():
    a, b = _pair(96, 160, 72, scale=4.0, seed=3)
    want = np.asarray(log_matmul_pallas(jnp.asarray(a), jnp.asarray(b), block_k=k8.BLOCK_K,
                                        dot_dtype="bfloat16", interpret=True))
    got = _port(a, b, "bfloat16")
    np.testing.assert_allclose(got, want, rtol=0, atol=BF16_VS_BF16)
    f32 = _port(a, b)
    np.testing.assert_allclose(got, f32, rtol=0, atol=BF16_VS_F32)
    assert not np.array_equal(got, f32)


@pytest.mark.parametrize("shape", [(40, 300, 56), (33, 17, 9), (128, 129, 64)])
def test_plain_bf16_at_block_k_matches_pallas_bf16(shape):
    """The plain bf16 version over K tiles of BLOCK_K (128): one partial
    tile, and several, against the reference's bf16 kernel at the same
    block_k in interpret mode."""
    i, k, j = shape
    a, b = _pair(i, k, j, scale=4.0, seed=k)
    want = np.asarray(log_matmul_pallas(jnp.asarray(a), jnp.asarray(b), block_k=k8.BLOCK_K,
                                        dot_dtype="bfloat16", interpret=True))
    np.testing.assert_allclose(_port(a, b, "bfloat16"), want, rtol=0, atol=BF16_VS_BF16)


def _guarded_model(a, b):
    """csrc/log_semiring.cu's float32 design in torch: the factored form
    with each row's and column's maximum over all of K, and the elements
    whose sum falls below guard_threshold(K) (both maxima live) summed
    again exactly; (out, the guard's mask)."""
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    m, n = a.amax(-1, keepdim=True), b.amax(-2, keepdim=True)
    live = (m > NEG_INF / 2) & (n > NEG_INF / 2)
    p = torch.exp(a - torch.where(m > NEG_INF / 2, m, 0.0))
    q = torch.exp(b - torch.where(n > NEG_INF / 2, n, 0.0))
    acc = p @ q
    guard = live & (acc < k8.guard_threshold(a.shape[-1]))
    out = torch.where(live, m + n + torch.log(acc), NEG_INF)
    return torch.where(guard, tsemi.log_matmul(a, b), out), guard


@pytest.mark.parametrize("case", ["normal", "identity", "wide", "steps"])
def test_guarded_factored_form_matches_oracle(case, mini):
    """The float32 kernel's arithmetic against the float64 oracle: 5 *
    normal (no element takes the guard), a log-space identity times columns
    spanning 200 nats and the wide-range rows (the guard keeps what the
    factored form flushes: without it these fail), and step matrices of the
    mini corpus with their prefix products (whose zero-support elements take
    the guard and stay NEG_INF)."""
    if case == "normal":
        a, b = _pair(64, 200, 48, seed=5)
    elif case == "identity":
        a = np.full((96, 96), NEG_INF, np.float32)
        np.fill_diagonal(a, 0.0)
        b = (-200.0 * np.random.default_rng(6).random((96, 40))).astype(np.float32)
    elif case == "wide":
        a, b = _wide_range()
    else:
        _, (_, log_trans, log_emit, src_len) = mini
        m = tcore.step_matrices(*(torch.as_tensor(x) for x in (log_trans, log_emit, src_len)))
        pre = tcore.associative_scan(tsemi.log_matmul, m)
        a, b = pre[:-1].numpy(), m[1:].numpy()
    want = tsemi.log_matmul(torch.as_tensor(a).double(), torch.as_tensor(b).double())
    got, guard = _guarded_model(a, b)
    np.testing.assert_allclose(got.numpy(), want.float().numpy(), **TOL)
    if case == "normal":
        assert not bool(guard.any())
    if case in ("identity", "wide"):
        unguarded = torch.where(guard, NEG_INF, got)
        assert not np.allclose(unguarded.numpy(), want.float().numpy(), **TOL)


def test_dot_dtype_is_validated():
    a, b = _pair(8, 8, 8)
    with pytest.raises(ValueError, match="dot_dtype"):
        k8.log_matmul(torch.as_tensor(a), torch.as_tensor(b), "float16")


@pytest.mark.parametrize("num", [1, 2, 5, 8, 13])
def test_associative_scan_is_an_inclusive_scan(num):
    x = torch.as_tensor(_normal((num, 3), 1.0, num)).double()
    np.testing.assert_allclose(tcore.associative_scan(torch.add, x).numpy(),
                               torch.cumsum(x, dim=0).numpy(), rtol=1e-12)


@pytest.fixture(scope="module")
def mini():
    """The reference tests' ``mini`` corpus (24 utterances, seed 3) with
    zero-length utterances, and its machinery from init as numpy arrays."""
    tc, _, _ = torch_make(n_utterances=24, seed=3, device="cpu")
    tc = tc.pad_to(tc.n + N_EMPTY)
    log_init, log_trans, log_emit = thmm._machinery(thmm.init(tc), tc)
    arrays = tuple(x.numpy() for x in (log_init, log_trans, log_emit, tc.src_len))
    return tc, arrays


def _alphas_close(got, want, corpus):
    """alphas [Ts, N, S] at valid (t, state) positions."""
    valid = (np.arange(got.shape[0])[:, None, None] < corpus.src_len.numpy()[None, :, None]) \
        & tcore.state_mask(corpus).numpy()[None]
    np.testing.assert_allclose(got[valid], want[valid], **FWD_TOL)


def test_step_matrices_match_jax(mini):
    _, (_, log_trans, log_emit, src_len) = mini
    want = np.asarray(jcore.step_matrices(jnp.asarray(log_trans), jnp.asarray(log_emit),
                                          jnp.asarray(src_len)))
    got = tcore.step_matrices(*(torch.as_tensor(x) for x in (log_trans, log_emit, src_len)))
    np.testing.assert_array_equal(got.numpy(), want)


def _forwards(mini, name, **kw):
    corpus, arrays = mini
    fn = {"associative": (jcore.forward_associative, tcore.forward_associative),
          "blocked": (jcore.forward_blocked, tcore.forward_blocked)}[name]
    a_w, z_w = fn[0](*(jnp.asarray(x) for x in arrays), **kw)
    a, z = fn[1](*(torch.as_tensor(x) for x in arrays), **kw)
    a_s, z_s = tcore.forward(*(torch.as_tensor(x) for x in arrays))
    assert torch.all(z[-N_EMPTY:] == 0)
    for want_a, want_z in ((np.asarray(a_w), np.asarray(z_w)), (a_s.numpy(), z_s.numpy())):
        np.testing.assert_allclose(z.numpy(), want_z, rtol=1e-4)
        _alphas_close(a.numpy(), want_a, corpus)


def test_forward_associative_matches_jax_and_sequential(mini):
    before = k8.log_matmul.launches
    _forwards(mini, "associative")
    assert k8.log_matmul.launches == before


@pytest.mark.parametrize("block", [4, 16, 64])
def test_forward_blocked_matches_jax_and_sequential(mini, block):
    """Blocks that divide Ts - 1, that do not, and longer than the sequence."""
    _forwards(mini, "blocked", block=block)


@pytest.mark.parametrize("view", ["contiguous", "even_odd", "transposed", "three", "broadcast"])
def test_kernel_batch_layout_addresses_every_matrix(view):
    """The two strided batch dimensions the wrapper hands K8 address every
    matrix of the view where it lies: offset (z // nb2) * s1 + (z % nb2) * s2
    for the z-th matrix in row-major batch order; leading dimensions that do
    not merge into two give None (the wrapper then copies)."""
    m = torch.zeros((8, 6, 4, 5, 3, 3))
    x = {"contiguous": m[0, 0], "even_odd": m[0, 0, 0:-1:2], "transposed":
         m[0, 0].transpose(0, 1)[:, 0:-1:2], "three": m[::2, ::2, ::2, 0],
         "broadcast": m[0, 0, :1].expand(4, 5, 3, 3)}[view]
    batch = x.shape[:-2]
    layout = k8._batch_layout(batch, x, x)
    if view == "three":
        assert layout is None
        return
    (nb1, s1, _), (nb2, s2, _) = layout
    assert nb1 * nb2 == int(np.prod(batch))
    for z, idx in enumerate(np.ndindex(*batch)):
        want = sum(i * st for i, st in zip(idx, x.stride()[:-2]))
        assert (z // nb2) * s1 + (z % nb2) * s2 == want
