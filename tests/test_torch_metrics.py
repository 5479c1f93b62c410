"""Port segmentation and metric families vs the JAX reference and the
golden values.

Noisy predictions (gold with 25% of positions corrupted, numpy seed) go
through both packages' segmenters and metrics.  Counts are exact, so every
metric agrees to rtol 1e-6 (float32 divisions of equal integers); the
golden-value run allows the reference's own drift of 0.02
(tests/test_golden_metrics.py).
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu import segment as jseg
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.eval import metrics as jm
from multimodalworddiscovery_tpu_torch import segment as tseg
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.eval import metrics as tm
from multimodalworddiscovery_tpu_torch.models import hmm as thmm

GOLDEN = json.loads((Path(__file__).parent / "golden_metrics.json").read_text())


@pytest.fixture(scope="module")
def segs():
    jc, jgold, _ = jax_make(n_utterances=60, seed=0)
    tc, _, _ = torch_make(n_utterances=60, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    sl, tl = np.asarray(jc.src_len), np.asarray(jc.trg_len)
    pred = jgold.alignment.copy()
    for i in range(jc.n):
        for t in range(sl[i]):
            if rng.random() < 0.25:
                pred[i, t] = rng.integers(0, tl[i] + 1)
    j = (*jseg.segments_from_alignment(jnp.asarray(pred), jc.trg, jc.src_len),
         *jseg.segments_from_alignment(jnp.asarray(jgold.alignment), jc.trg, jc.src_len))
    t = (*tseg.segments_from_alignment(torch.as_tensor(pred), tc.trg, tc.src_len),
         *tseg.segments_from_alignment(torch.as_tensor(jgold.alignment), tc.trg, tc.src_len))
    return jc, tc, j, t


def _close(got: dict, want: dict):
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_boundaries_and_host_segments_match_jax(segs):
    jc, tc, j, t = segs
    for a, b in ((0, 1), (2, 3)):
        want = np.asarray(jseg.boundaries_from_segments(j[a], j[b], jc.max_src_len))
        got = tseg.boundaries_from_segments(t[a], t[b], tc.max_src_len)
        assert got.dtype == torch.bool
        np.testing.assert_array_equal(got.numpy(), want)
        assert tseg.segments_to_host(t[a], t[b]) == jseg.segments_to_host(j[a], j[b])


@pytest.mark.parametrize("threshold", [0.5, 0.8])
def test_word_iou_matches_jax(segs, threshold):
    _, _, j, t = segs
    _close(tm.word_iou(*t, iou_threshold=threshold), jm.word_iou(*j, iou_threshold=threshold))
    _close(tm.word_iou_stats(*t, iou_threshold=threshold),
           jm.word_iou_stats(*j, iou_threshold=threshold))


@pytest.mark.parametrize("tolerance", [0, 1, 2])
def test_boundary_prf_matches_jax(segs, tolerance):
    jc, tc, j, t = segs
    jb = [jseg.boundaries_from_segments(j[a], j[a + 1], jc.max_src_len) for a in (0, 2)]
    tb = [tseg.boundaries_from_segments(t[a], t[a + 1], tc.max_src_len) for a in (0, 2)]
    _close(tm.boundary_prf(*tb, tolerance=tolerance), jm.boundary_prf(*jb, tolerance=tolerance))
    _close(tm.boundary_stats(*tb, tolerance=tolerance),
           jm.boundary_stats(*jb, tolerance=tolerance))


def test_purity_and_nmi_match_jax(segs):
    jc, tc, j, t = segs
    want = np.asarray(jm.purity_counts(*j, jc.trg_vocab))
    got = tm.purity_counts(*t, tc.trg_vocab)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(float(tm.cluster_purity(*t, tc.trg_vocab)),
                               float(jm.cluster_purity(*j, jc.trg_vocab)), rtol=1e-6)
    np.testing.assert_allclose(float(tm.cluster_nmi(*t, tc.trg_vocab)),
                               float(jm.cluster_nmi(*j, jc.trg_vocab)), rtol=1e-5)


def test_stats_are_additive_across_shards(segs):
    _, tc, _, t = segs
    halves = [tuple(x[sl] for x in t) for sl in (slice(0, 25), slice(25, None))]
    whole = tm.word_iou_stats(*t)
    parts = [tm.word_iou_stats(*h) for h in halves]
    for k in whole:
        assert float(whole[k]) == float(parts[0][k] + parts[1][k]), k
    counts = sum(tm.purity_counts(*h, tc.trg_vocab) for h in halves)
    assert torch.equal(counts, tm.purity_counts(*t, tc.trg_vocab))


def test_perfect_segmentation_scores_one(segs):
    jc, tc, _, t = segs
    gold = t[2:]
    assert float(tm.word_iou(*gold, *gold)["f1"]) == 1.0
    assert float(tm.cluster_purity(*gold, *gold, tc.trg_vocab)) == 1.0
    b = tseg.boundaries_from_segments(*gold, tc.max_src_len)
    assert float(tm.boundary_prf(b, b)["f1"]) == 1.0


def test_golden_metrics_hmm():
    """The discrete HMM's train -> align -> segment -> evaluate loop on the
    frozen corpus of tests/test_golden_metrics.py reproduces the committed
    metrics."""
    corpus, gold, _ = torch_make(n_utterances=100, seed=42, device="cpu")
    p, _ = thmm.train(thmm.init(corpus), corpus, 12, use_kernels=True)
    al = thmm.align(p, corpus, use_kernels=True)
    ga = torch.as_tensor(gold.alignment)
    ps, pm = tseg.segments_from_alignment(al, corpus.trg, corpus.src_len)
    gs, gm = tseg.segments_from_alignment(ga, corpus.trg, corpus.src_len)
    pb = tseg.boundaries_from_segments(ps, pm, corpus.max_src_len)
    gb = tseg.boundaries_from_segments(gs, gm, corpus.max_src_len)
    got = {
        "alignment_f1": float(tm.alignment_prf(al, ga, corpus.src_mask())["f1"]),
        "word_iou_f1": float(tm.word_iou(ps, pm, gs, gm)["f1"]),
        "boundary_f1": float(tm.boundary_prf(pb, gb, tolerance=1)["f1"]),
        "purity": float(tm.cluster_purity(ps, pm, gs, gm, corpus.trg_vocab)),
    }
    for k, want in GOLDEN["hmm"].items():
        assert abs(got[k] - want) < 0.02, (k, got[k], want)
