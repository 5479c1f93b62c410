"""K1's and K7's plain versions and the plain pair counts vs the JAX reference.

The JAX Pallas lookup runs in interpret mode, as the reference's own tests
run it on the CPU; its padded time-major output is transposed to the port's
utterance-major [N, Ts, S] layout to compare.  Both sides are exact gathers,
so the lookup must match bit for bit.
"""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.core import counts as jcounts
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.ops.counts_pallas import (
    pad_time_major,
    pair_counts_pallas,
    table_lookup_pallas,
)
from multimodalworddiscovery_tpu_torch.core import counts as tcounts
from multimodalworddiscovery_tpu_torch.ops import counts as k1

CASES = {
    "S8": dict(n_utterances=40, seed=3),
    "S40": dict(n_utterances=8, n_concepts=200, min_concepts=17,
                max_concepts=20, min_word_len=2, max_word_len=3, seed=21),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def lookup_case(request):
    corpus, _, _ = jax_make(**CASES[request.param])
    corpus = corpus.pad_to(corpus.n + 3)  # zero-length utterances
    params, _ = jhmm.em_step(jhmm.init(corpus), corpus)  # non-uniform table
    table = np.array(params.log_emit)
    src = np.array(corpus.src)
    concepts = np.array(jcore.state_concepts(corpus))
    return corpus, table, src, concepts


def test_plain_lookup_equals_pallas_lookup(lookup_case):
    corpus, table, src, concepts = lookup_case
    n, ts = src.shape
    s = concepts.shape[1]
    bn, bt = 128, 8
    tp, np_, kp = -(-ts // bt) * bt, -(-n // bn) * bn, -(-s // 8) * 8
    want_t = table_lookup_pallas(
        table, pad_time_major(src, tp, np_), pad_time_major(concepts, kp, np_),
        k_real=s, block_n=bn, block_t=bt, interpret=True,
    )
    want = np.transpose(np.asarray(want_t), (2, 0, 1))[:n, :ts, :s]
    got = k1.table_lookup(
        torch.as_tensor(table), torch.as_tensor(src), torch.as_tensor(concepts)
    )
    assert got.shape == (n, ts, s) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_lookup_equals_core_lookup(lookup_case):
    _, table, src, concepts = lookup_case
    want = np.asarray(jcounts.table_lookup(table, src, concepts))
    got = tcounts.table_lookup(
        torch.as_tensor(table), torch.as_tensor(src), torch.as_tensor(concepts)
    )
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_lookup_launches_no_kernel(lookup_case):
    _, table, src, concepts = lookup_case
    before = k1.table_lookup.launches
    k1.table_lookup(torch.as_tensor(table), torch.as_tensor(src), torch.as_tensor(concepts))
    assert k1.table_lookup.launches == before


def _k1_div(x, d):
    """csrc/counts.cu mwd_k1_div in float32 numpy: q = trunc(float(x) * (1 /
    d)), then one correction by the remainder."""
    inv = np.float32(1.0) / np.float32(d)
    q = np.trunc(np.asarray(x, np.float32) * inv).astype(np.int64)
    r = np.asarray(x, np.int64) - q * d
    return q + np.where(r < 0, -1, np.where(r >= d, 1, 0))


@pytest.mark.parametrize("d", [1, 3, 7, 12, 13, 64, 128, 372, 23168, 25664, 4099])
def test_k1_reciprocal_division_is_exact(d):
    """K1's 32-bit index math: x / d by a float reciprocal and one
    correction is exact for every x below 2^24 (the chunk's flat length),
    checked at multiples of d and their neighbours (every one, or a million
    spread over the range and the last thousand), and at random x."""
    k = np.arange(0, (1 << 24) // d + 1, dtype=np.int64)
    k = np.unique(np.concatenate([k[:: max(1, k.size >> 20)], k[-1000:]]))
    x = np.concatenate([k * d - 1, k * d, k * d + 1,
                        np.random.default_rng(d).integers(0, 1 << 24, 100_000)])
    x = x[(x >= 0) & (x < (1 << 24))]
    np.testing.assert_array_equal(_k1_div(x, d), x // d)


def _k1_model(table, src, conc, per_block, chunk, base_off=0):
    """csrc/counts.cu's K1 plan in numpy: blocks over contiguous utterance
    ranges, chunks of them, each chunk's flat output walked as an unaligned
    head, 4-element stores stepping (u, t, k), and a tail; ``base_off``
    shifts the output's start off a 16-byte boundary."""
    n, ts = src.shape
    s = conc.shape[1]
    length = ts * s
    flat = np.full(base_off + n * length, np.nan, np.float32)
    for n0 in range(0, n, per_block):
        n1 = min(n, n0 + per_block)
        for c0 in range(n0, n1, chunk):
            cu = min(chunk, n1 - c0)
            start = base_off + c0 * length
            total = cu * length
            head = min(total, (4 - start % 4) % 4)
            nv = (total - head) // 4

            def at(x):
                u = int(_k1_div(x, length))
                r = x - u * length
                t = int(_k1_div(r, s))
                return u, t, r - t * s

            def put(x, u, t, k):
                flat[start + x] = table[src[c0 + u, t], conc[c0 + u, k]]

            for x in range(head):
                put(x, *at(x))
            for v in range(nv):
                x = head + 4 * v
                u, t, k = at(x)
                for w in range(4):
                    put(x + w, u, t, k)
                    k += 1
                    if k == s:
                        k, t = 0, t + 1
                        if t == ts:
                            t, u = 0, u + 1
            for x in range(head + 4 * nv, total):
                put(x, *at(x))
    return flat[base_off:].reshape(n, ts, s)


@pytest.mark.parametrize("s, ts, per_block, chunk, off", [
    (12, 31, 16, 5, 0), (7, 23, 9, 4, 1), (13, 1, 50, 50, 3), (64, 9, 3, 2, 2), (5, 3, 1, 1, 1)])
def test_k1_plan_model_equals_gather(s, ts, per_block, chunk, off):
    """The index walk of K1's kernel (chunks, head, 16-byte stores, tail)
    writes every element of the plain gather exactly once, whatever the
    row length's remainder mod 4 and the output's alignment."""
    rng = np.random.default_rng(s * ts)
    n = 23
    table = rng.normal(size=(11, 17)).astype(np.float32)
    src = rng.integers(0, 11, (n, ts))
    conc = rng.integers(0, 17, (n, s))
    got = _k1_model(table, src, conc, per_block, chunk, off)
    want = tcounts.table_lookup(torch.as_tensor(table), torch.as_tensor(src),
                                torch.as_tensor(conc)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [6, 40])  # reference's broadcast / einsum forms
def test_pair_counts_matches_jax(k):
    rng = np.random.default_rng(k)
    n, t, f, e = 30, 17, 11, 23
    gamma = rng.random((n, t, k)).astype(np.float32)
    gamma[rng.random((n, t)) < 0.2] = 0.0  # padded positions carry zeros
    rows = rng.integers(0, f, size=(n, t)).astype(np.int32)
    cols = rng.integers(0, e, size=(n, k)).astype(np.int32)
    want = np.asarray(jcounts.pair_counts(gamma, rows, cols, f, e))
    got = tcounts.pair_counts(
        torch.as_tensor(gamma), torch.as_tensor(rows), torch.as_tensor(cols), f, e
    )
    assert got.shape == (f, e)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_k7_plain_matches_pallas_pair_counts(seed):
    """K7 (``ops/counts.pair_counts``, its plain version on the CPU) on
    gamma in K4's [N, Ts, S] layout against the reference kernel on the
    same values in its padded time-major layout (interpret mode), at the
    reference's bound rtol 1e-5 atol 1e-4 (tests/test_counts_pallas.py:64-74)."""
    rng = np.random.default_rng(seed)
    n, t, k, f, e = 37, 19, 11, 23, 17
    src = rng.integers(0, f, size=(n, t)).astype(np.int32)
    concepts = rng.integers(0, e, size=(n, k)).astype(np.int32)
    gamma = rng.uniform(size=(n, t, k)).astype(np.float32)
    lens = rng.integers(0, t + 1, size=(n,))
    for i in range(n):
        gamma[i, lens[i]:] = 0.0  # the E-step's zeros past each length
    bn, bt = 128, 8
    tp, np_, kp = -(-t // bt) * bt, -(-n // bn) * bn, -(-k // 8) * 8
    gamma_t = np.zeros((tp, kp, np_), np.float32)
    gamma_t[:t, :k, :n] = np.moveaxis(gamma, 0, -1)
    want = np.asarray(pair_counts_pallas(
        gamma_t, pad_time_major(src, tp, np_), pad_time_major(concepts, kp, np_),
        n_rows=f, n_cols=e, block_n=bn, block_t=bt, interpret=True,
    ))
    before = k1.pair_counts.launches
    got = k1.pair_counts(torch.as_tensor(gamma), torch.as_tensor(src),
                         torch.as_tensor(concepts), f, e)
    assert k1.pair_counts.launches == before  # CPU tensors take the plain version
    assert got.shape == (f, e) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _k7_plan(gamma, src, concepts, f, e, rows_per_block):
    """csrc/counts.cu's K7 plan (its adds in counts.cuh) in numpy: blocks
    over contiguous ranges of (n, t) rows, each with its own [F, E] table;
    in each row the posteriors of concept 0 summed first (float32) and added
    once, every other nonzero posterior added into its entry.  The adds are
    integers: each value rounded to 2^-48 (a value of 32 or more straight
    into the counts, as two words); each table's entries join the counts,
    and the counts turn into float32 at the end."""
    n, t, s = gamma.shape
    g = gamma.reshape(n * t, s)
    rows_src = src.reshape(-1)
    acc = np.zeros((f, e), np.int64)

    def add(tab, ph, cj, v):
        if v < 32:
            tab[ph, cj] += int(np.rint(np.float64(v) * 2.0**48))
        else:
            d = np.float64(v) * 2.0**16
            acc[ph, cj] += (int(np.floor(d)) << 32) + int(np.rint((d - np.floor(d)) * 2.0**32))

    for r0 in range(0, n * t, rows_per_block):
        tab = np.zeros((f, e), np.int64)
        for r in range(r0, min(n * t, r0 + rows_per_block)):
            c = concepts[r // t]
            ph = rows_src[r]
            null = c == 0
            g0 = g[r, null].sum(dtype=np.float32)
            if g0 != 0:
                add(tab, ph, 0, g0)
            for k in np.nonzero(~null & (g[r] != 0))[0]:
                add(tab, ph, c[k], g[r, k])
        assert tab.max() < 2**62
        acc += tab
    return (acc.astype(np.float64) * 2.0**-48).astype(np.float32)


@pytest.mark.parametrize("layout", ["path 8 (S=128, nulls the upper half)", "nulls scattered"])
def test_k7_plan_matches_pair_counts(layout):
    """K7's plan (per-row null pre-sum, per-block tables, fixed-point adds)
    against the JAX package's ``core.counts.pair_counts``: at path 8's
    state layout (``hmm_core.state_concepts`` of a dense-caption corpus,
    S=128, V_trg=401) and with the null states placed at random; rtol 1e-5,
    atol 1e-5 (float64 sums against float32 ones)."""
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
    from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore

    corpus, _, _ = torch_make(n_utterances=24, n_concepts=400, n_phones=48, min_concepts=48,
                              max_concepts=64, min_word_len=2, max_word_len=3, seed=2,
                              device="cpu")
    concepts = tcore.state_concepts(corpus).numpy()
    src = corpus.src.numpy()
    lens = corpus.src_len.numpy()
    f, e = corpus.src_vocab, corpus.trg_vocab
    n, t = src.shape
    s = concepts.shape[1]
    rng = np.random.default_rng(8)
    if layout == "nulls scattered":
        concepts = rng.integers(1, e, size=(n, s)).astype(np.int32)
        concepts[rng.random((n, s)) < 0.4] = 0
    else:
        assert (s, e) == (128, 401) and not concepts[:, s // 2:].any()
    gamma = rng.random((n, t, s)).astype(np.float32)
    gamma[rng.random((n, t, s)) < 0.3] = 0.0
    for i in range(n):
        gamma[i, lens[i]:] = 0.0
    want = np.asarray(jcounts.pair_counts(gamma, src, concepts, f, e))
    got = _k7_plan(gamma, src, concepts, f, e, rows_per_block=97)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got[:, 0].sum() > 0  # the null column is exercised
