"""Port retrieval scorers and DTW vs the JAX reference.

The corpus comes from the numpy generator with a fixed seed (the same in
both packages), parameters cross over with ``params_from_numpy`` and both
sides score the same candidate arrays.  Tolerances: scores rtol 1e-5, ranks
and recall exact; ``dtw_distance`` rtol 1e-5 (the segment matrix and
``dtw_to_gold`` also atol 1e-6, for distances near 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.eval import dtw as jdtw
from multimodalworddiscovery_tpu.eval import retrieval as jret
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import model1 as jm1
from multimodalworddiscovery_tpu.segment import segments_from_alignment as jsegments
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.eval import dtw as tdtw
from multimodalworddiscovery_tpu_torch.eval import retrieval as tret
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import model1 as tm1
from multimodalworddiscovery_tpu_torch.segment import segments_from_alignment as tsegments

GEN = dict(n_utterances=40, seed=5)
POOL = 8


@pytest.fixture(scope="module")
def setup():
    jc, _, _ = jax_make(**GEN)
    tc, _, _ = torch_make(**GEN, device="cpu")
    jm, _ = jm1.train(jm1.init(jc), jc, 4)
    jh = jhmm.init(jc)
    for _ in range(3):
        jh, _ = jhmm.em_step(jh, jc)
    tm = tm1.params_from_numpy(np.array(jm.log_t), device="cpu")
    th = thmm.params_from_numpy(np.array(jh.log_emit), np.array(jh.log_jump),
                                np.array(jh.log_p0), jh.max_jump, device="cpu")
    rng = np.random.default_rng(0)
    cand = np.concatenate([np.arange(jc.n)[:, None],
                           rng.integers(0, jc.n, (jc.n, POOL - 1))], axis=1)
    return jc, tc, jm, tm, jh, th, cand


@pytest.mark.parametrize("use_kernels", [False, True])
def test_model1_full_scores_match_jax(setup, use_kernels):
    jc, tc, jm, tm, *_ = setup
    want = np.array(jret.retrieval_scores_model1(jm, jc))
    got = tret.retrieval_scores_model1(tm, tc, use_kernels=use_kernels).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    for k, v in jret.recall_at_k(jnp.asarray(want)).items():
        assert float(tret.recall_at_k(torch.as_tensor(want))[k]) == float(v), k


@pytest.mark.parametrize("direction", ["c2i", "i2c"])
def test_model1_pooled_scores_match_jax(setup, direction, monkeypatch):
    jc, tc, jm, tm, _, _, cand = setup
    want = np.array(jret.retrieval_scores_model1_pooled(jm, jc, jnp.asarray(cand),
                                                        direction=direction))
    # chunks of a few rows: the chunked pairing equals the one-shot one
    monkeypatch.setattr(tret, "PAIR_CHUNK_BYTES", 3 * POOL * tret._model1_pair_bytes(tc))
    got = tret.retrieval_scores_model1_pooled(tm, tc, torch.as_tensor(cand),
                                              direction=direction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    jr = np.array(jret.ranks_from_pooled(jnp.asarray(want)))
    np.testing.assert_array_equal(tret.ranks_from_pooled(torch.as_tensor(want)).numpy(), jr)
    jrec = jret.recall_at_k_pooled(jnp.asarray(want), direction=direction)
    trec = tret.recall_at_k_pooled(torch.as_tensor(want), direction=direction)
    assert set(trec) == set(jrec)
    for k in jrec:
        assert float(trec[k]) == float(jrec[k]), k


@pytest.mark.parametrize("direction", ["c2i", "i2c"])
def test_hmm_pooled_scores_match_jax(setup, direction):
    jc, tc, _, _, jh, th, cand = setup
    want = np.array(jret.retrieval_scores_hmm_family_pooled(
        jhmm, jh, jc, jnp.asarray(cand), direction=direction))
    got = tret.retrieval_scores_hmm_family_pooled(thmm, th, tc, torch.as_tensor(cand),
                                                  direction=direction)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    if direction == "c2i":
        np.testing.assert_allclose(
            tret.retrieval_scores_hmm_pooled(th, tc, torch.as_tensor(cand)).numpy(),
            np.array(jret.retrieval_scores_hmm_pooled(jh, jc, jnp.asarray(cand))), rtol=1e-5)


def test_hmm_full_scores_match_jax(setup):
    jc, tc, _, _, jh, th, _ = setup
    sub_j = jax.tree.map(lambda x: x[:12], jc)
    sub_t = tc.__class__(src=tc.src[:12], src_len=tc.src_len[:12], trg=tc.trg[:12],
                         trg_len=tc.trg_len[:12], src_vocab=tc.src_vocab,
                         trg_vocab=tc.trg_vocab)
    want = np.array(jret.retrieval_scores_hmm(jh, sub_j))
    np.testing.assert_allclose(tret.retrieval_scores_hmm(th, sub_t).numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("n,pool", [(40, 8), (9, 9), (20, 1)])
def test_sample_candidate_pools_protocol(n, pool):
    cand = tret.sample_candidate_pools(n, pool, torch.Generator().manual_seed(1), device="cpu")
    again = tret.sample_candidate_pools(n, pool, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(cand, again) and cand.shape == (n, pool)
    np.testing.assert_array_equal(cand[:, 0].numpy(), np.arange(n))
    for i, row in enumerate(cand.tolist()):
        assert len(set(row)) == pool and all(0 <= j < n for j in row), i
    if pool == n:  # every other row exactly once
        assert all(sorted(r) == list(range(n)) for r in cand.tolist())
    with pytest.raises(ValueError, match="pool_size"):
        tret.sample_candidate_pools(n, n + 1, device="cpu")


def test_large_pools_are_iid_and_never_true(monkeypatch):
    monkeypatch.setattr(tret, "EXACT_POOL_MAX_N", 10)
    cand = tret.sample_candidate_pools(50, 30, torch.Generator().manual_seed(0), device="cpu")
    assert bool((cand[:, 1:] != torch.arange(50)[:, None]).all())


def test_dense_pools_and_median_match_jax():
    np.testing.assert_array_equal(tret.dense_candidate_pools(7, device="cpu").numpy(),
                                  np.array(jret.dense_candidate_pools(7)))
    for ranks in ([0, 3, 1, 7], [2, 2, 5], [4]):
        want = jret.recall_from_ranks(np.array(ranks), 8)
        got = tret.recall_from_ranks(torch.tensor(ranks), 8)
        for k in want:
            assert float(got[k]) == float(want[k]), (ranks, k)


@pytest.fixture(scope="module")
def dtw_corpus():
    jc, jg, _ = jax_make(n_utterances=10, seed=42)
    jfc, jfg, _ = jax_frames(jc, jg, feat_dim=6, noise=0.05, seed=42)
    tc, tg, _ = torch_make(n_utterances=10, seed=42, device="cpu")
    tfc, tfg, _ = torch_frames(tc, tg, feat_dim=6, noise=0.05, seed=42, device="cpu")
    js, jm = jsegments(jnp.asarray(jfg.alignment), jfc.trg, jfc.src_len)
    ts, tm = tsegments(torch.as_tensor(tfg.alignment), tfc.trg, tfc.src_len)
    np.testing.assert_array_equal(ts.numpy(), np.array(js))
    return jfc, js, jm, tfc, ts, tm


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "cosine"])
@pytest.mark.parametrize("normalize", [False, True])
def test_dtw_distance_matches_jax(metric, normalize):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(12, 9, 5)).astype(np.float32)
    y = rng.normal(size=(12, 7, 5)).astype(np.float32)
    lx = rng.integers(0, 10, 12).astype(np.int32)
    ly = rng.integers(1, 8, 12).astype(np.int32)
    want = np.array(jdtw.dtw_distance(x, y, lx, ly, metric=metric, normalize=normalize))
    got = tdtw.dtw_distance(*map(torch.as_tensor, (x, y, lx, ly)), metric=metric,
                            normalize=normalize).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_segment_dtw_matrix_and_coherence_match_jax(dtw_corpus):
    jfc, js, jm, tfc, ts, tm = dtw_corpus
    jd, ji = jdtw.segment_dtw_matrix(jfc.src, js, jm, max_seg_len=12)
    td, ti = tdtw.segment_dtw_matrix(tfc.src, ts, tm, max_seg_len=12)
    # atol 1e-6: the prefix form D = S + cummin(E - shift(S)) subtracts sums
    # of a row's costs (~10 here), so a distance near 0 keeps their rounding
    np.testing.assert_allclose(td.numpy(), np.array(jd), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ti.numpy(), np.array(ji))
    want = jdtw.cluster_dtw_coherence(jfc.src, js, jm, max_seg_len=12)
    got = tdtw.cluster_dtw_coherence(tfc.src, ts, tm, max_seg_len=12)
    for k in ("within", "across", "ratio"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)


def test_dtw_to_gold_matches_jax(dtw_corpus):
    jfc, js, jm, tfc, ts, tm = dtw_corpus
    # a prediction: the gold units with every other boundary moved a frame
    pred = ts.clone()
    pred[:, ::2, 1] = torch.clamp(pred[:, ::2, 1] - 1, min=1)
    pred[:, ::2, 1] = torch.maximum(pred[:, ::2, 1], pred[:, ::2, 0] + 1)
    want = jdtw.dtw_to_gold(jfc.src, jnp.asarray(pred.numpy()), jm, js, jm, max_seg_len=12)
    got = tdtw.dtw_to_gold(tfc.src, pred, tm, ts, tm, max_seg_len=12)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)
    assert float(tdtw.dtw_to_gold(tfc.src, ts, tm, ts, tm, max_seg_len=12)) == 0.0


def test_golden_dtw_coherence():
    """tests/golden_metrics.json "dtw_gold_segments": the DTW coherence of
    the gold segmentation on the frozen continuous corpus (N=60, seed 42),
    within rtol 0.02 (atol 1e-3) as tests/test_golden_metrics.py holds the
    reference."""
    import json
    from pathlib import Path

    want = json.loads((Path(__file__).parent / "golden_metrics.json").read_text())
    corpus, gold, _ = torch_make(n_utterances=60, seed=42, device="cpu")
    fc, fg, _ = torch_frames(corpus, gold, feat_dim=8, noise=0.05, seed=42, device="cpu")
    segs, mask = tsegments(torch.as_tensor(fg.alignment), fc.trg, fc.src_len)
    coh = tdtw.cluster_dtw_coherence(fc.src, segs, mask, max_seg_len=16)
    for k in ("within", "across", "ratio"):
        np.testing.assert_allclose(float(coh[k]), want["dtw_gold_segments"][k], rtol=0.02,
                                   atol=1e-3)
