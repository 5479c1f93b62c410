"""Port Model-1 (init, EM, posteriors, align) vs the JAX reference, its
float64 oracle and the golden metrics.

Inputs come from the numpy generator with a fixed seed (the same corpus in
both packages), padded with zero-length utterances.  Tolerances: loglik
rtol 1e-5 per iteration and log_t atol 1e-5 over 5 EM iterations, align
exact; against ``oracles/numpy_model1.py`` as ``tests/test_model1.py``
holds the reference (loglik rtol 1e-4, t rtol 2e-3 atol 1e-6); the golden
metrics within 0.02 as ``tests/test_golden_metrics.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import model1 as jm1
from multimodalworddiscovery_tpu.oracles.numpy_model1 import NumpyModel1
from multimodalworddiscovery_tpu_torch import segment as tsegment
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.eval import metrics as tmetrics
from multimodalworddiscovery_tpu_torch.models import model1 as tm1

GEN = dict(n_utterances=40, seed=3)
N_EMPTY = 4
EM_ITERS = 5
GOLDEN = json.loads((Path(__file__).parent / "golden_metrics.json").read_text())


@pytest.fixture(scope="module")
def corpora():
    jc, _, _ = jax_make(**GEN)
    tc, _, _ = torch_make(**GEN, device="cpu")
    return jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)


@pytest.fixture(scope="module")
def jax_run(corpora):
    jc, _ = corpora
    p, lls, tables = jm1.init(jc), [], []
    for _ in range(EM_ITERS):
        p, stats = jm1.em_step(p, jc)
        lls.append(float(stats["loglik"]))
        tables.append(np.array(p.log_t))
    return p, np.array(lls), tables


def test_init_and_params_from_numpy(corpora):
    jc, tc = corpora
    jp, tp = jm1.init(jc), tm1.init(tc)
    np.testing.assert_allclose(tp.log_t.numpy(), np.array(jp.log_t), rtol=1e-7)
    q = tm1.params_from_numpy(np.array(jp.log_t), device="cpu")
    assert q.log_t.dtype == torch.float32 and q.log_t.is_contiguous()
    np.testing.assert_array_equal(q.log_t.numpy(), np.array(jp.log_t))


def test_count_stats_exact(corpora):
    jc, tc = corpora
    jh, jcnt = jm1._count_stats(jc)
    th, tcnt = tm1._count_stats(tc)
    np.testing.assert_array_equal(th.numpy(), np.array(jh))
    np.testing.assert_array_equal(tcnt.numpy(), np.array(jcnt))


def test_em_trajectory_matches_jax(corpora, jax_run):
    _, tc = corpora
    _, j_lls, j_tables = jax_run
    p = tm1.init(tc)
    for it in range(EM_ITERS):
        p, stats = tm1.em_step(p, tc)
        np.testing.assert_allclose(float(stats["loglik"]), j_lls[it], rtol=1e-5)
        np.testing.assert_allclose(p.log_t.numpy(), j_tables[it], rtol=0, atol=1e-5)
    p_train, lls = tm1.train(tm1.init(tc), tc, EM_ITERS)
    np.testing.assert_allclose(lls.numpy(), j_lls, rtol=1e-5)
    np.testing.assert_allclose(p_train.log_t.numpy(), j_tables[-1], rtol=0, atol=1e-5)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_align_posteriors_loglik_match_jax(corpora, jax_run, use_kernels):
    """From the JAX parameters after 5 iterations: align exact (dense and
    concept space), posteriors and loglik rtol 1e-5."""
    jc, tc = corpora
    jp = jax_run[0]
    tp = tm1.params_from_numpy(np.array(jp.log_t), device="cpu")
    want = np.array(jm1.align(jp, jc))
    np.testing.assert_array_equal(tm1.align(tp, tc, use_kernels=use_kernels).numpy(), want)
    np.testing.assert_array_equal(tm1._align_concept_space(tp, tc).numpy(), want)
    np.testing.assert_allclose(tm1.posteriors(tp, tc, use_kernels=use_kernels).numpy(),
                               np.array(jm1.posteriors(jp, jc)), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(float(tm1.loglik(tp, tc)), float(jm1.loglik(jp, jc)), rtol=1e-5)


def test_posteriors_rows_sum_to_one(corpora):
    _, tc = corpora
    p, _ = tm1.train(tm1.init(tc), tc, 2)
    gamma = tm1.posteriors(p, tc)
    sm = tc.src_mask()
    torch.testing.assert_close(gamma.sum(-1)[sm], torch.ones(int(sm.sum())), rtol=1e-5, atol=0)
    assert bool((gamma.sum(-1)[~sm] == 0).all())


def _ragged(corpus):
    src, trg = corpus.src.numpy(), corpus.trg.numpy()
    sl, tl = corpus.src_len.numpy(), corpus.trg_len.numpy()
    return ([src[i, : sl[i]] for i in range(corpus.n)],
            [trg[i, : tl[i]] for i in range(corpus.n)])


def test_em_matches_numpy_oracle():
    """The float64 per-utterance oracle, as tests/test_model1.py holds the
    reference (loglik rtol 1e-4, t rtol 2e-3 atol 1e-6, decode exact)."""
    corpus, _, _ = torch_make(n_utterances=32, seed=1, device="cpu")
    oracle = NumpyModel1(*_ragged(corpus), corpus.src_vocab, corpus.trg_vocab)
    params = tm1.init(corpus)
    for _ in range(5):
        oracle_ll = oracle.em_iteration()
        params, stats = tm1.em_step(params, corpus)
        np.testing.assert_allclose(float(stats["loglik"]), oracle_ll, rtol=1e-4)
        np.testing.assert_allclose(np.exp(params.log_t.double().numpy()), oracle.t,
                                   rtol=2e-3, atol=1e-6)
    ours = tm1.align(params, corpus).numpy()
    sl = corpus.src_len.numpy()
    for i, a in enumerate(oracle.align()):
        np.testing.assert_array_equal(ours[i, : sl[i]], a)


def test_golden_metrics():
    """tests/golden_metrics.json "model1": the corpus of N=100 (seed 42), 15
    EM iterations, align, segment and evaluate, within 0.02 of each value."""
    corpus, gold, _ = torch_make(n_utterances=100, seed=42, device="cpu")
    p, _ = tm1.train(tm1.init(corpus), corpus, 15)
    al = tm1.align(p, corpus)
    ga = torch.as_tensor(gold.alignment)
    ps, pm = tsegment.segments_from_alignment(al, corpus.trg, corpus.src_len)
    gs, gm = tsegment.segments_from_alignment(ga, corpus.trg, corpus.src_len)
    pb = tsegment.boundaries_from_segments(ps, pm, corpus.max_src_len)
    gb = tsegment.boundaries_from_segments(gs, gm, corpus.max_src_len)
    got = {
        "alignment_f1": float(tmetrics.alignment_prf(al, ga, corpus.src_mask())["f1"]),
        "word_iou_f1": float(tmetrics.word_iou(ps, pm, gs, gm)["f1"]),
        "boundary_f1": float(tmetrics.boundary_prf(pb, gb, tolerance=1)["f1"]),
        "purity": float(tmetrics.cluster_purity(ps, pm, gs, gm, corpus.trg_vocab)),
    }
    for k, want in GOLDEN["model1"].items():
        assert abs(got[k] - want) < 0.02, (k, got[k], want)


@pytest.mark.parametrize("gen", [
    dict(n_utterances=24, n_concepts=60, min_concepts=3, max_concepts=6, seed=0),
    dict(n_utterances=12, n_concepts=200, min_concepts=24, max_concepts=32, min_word_len=3,
         max_word_len=5, seed=1),
])
def test_concept_space_equals_dense(gen):
    """``_align_concept_space`` equals ``_align_dense`` at the Tt6 and Tt32
    regimes of the reference's model1_align benchmark, cut to a few
    utterances, also with tied (smoothing-only) columns after 1 iteration."""
    corpus, _, _ = torch_make(**gen, device="cpu")
    corpus = corpus.pad_to(corpus.n + 2)
    p = tm1.init(corpus)
    for _ in range(3):
        p, _ = tm1.em_step(p, corpus)
        assert torch.equal(tm1._align_concept_space(p, corpus), tm1._align_dense(p, corpus))


def test_init_refuses_frames():
    from multimodalworddiscovery_tpu_torch.data import phones_to_frames

    c, g, _ = torch_make(n_utterances=4, seed=0, device="cpu")
    fc, _, _ = phones_to_frames(c, g, feat_dim=4, seed=0, device="cpu")
    with pytest.raises(ValueError, match="DISCRETE"):
        tm1.init(fc)
