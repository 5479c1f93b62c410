"""The port's float64 NumPy oracles against the JAX package's, on the CPU.

The port keeps its own copies of ``oracles/`` (it imports nothing of the
JAX package).  Each copy is held to the original on the same seeded numpy
inputs: bitwise for the pure-numpy oracles (same code, same float64 ops),
and the MFCC oracle within 1e-12 (its filterbank and DCT tables come from
the port's ``frontend/speech``, a copy of the reference's numpy code).
"""

import numpy as np
import pytest

from multimodalworddiscovery_tpu.oracles import numpy_detector as jdet
from multimodalworddiscovery_tpu.oracles import numpy_hmm as jhmm
from multimodalworddiscovery_tpu.oracles import numpy_hmm_gaussian as jgauss
from multimodalworddiscovery_tpu.oracles import numpy_metrics as jmet
from multimodalworddiscovery_tpu.oracles import numpy_mfcc as jmfcc
from multimodalworddiscovery_tpu.oracles import numpy_model1 as jm1
from multimodalworddiscovery_tpu.oracles import numpy_segkmeans as jseg
from multimodalworddiscovery_tpu_torch.oracles import numpy_detector as tdet
from multimodalworddiscovery_tpu_torch.oracles import numpy_hmm as thmm
from multimodalworddiscovery_tpu_torch.oracles import numpy_hmm_gaussian as tgauss
from multimodalworddiscovery_tpu_torch.oracles import numpy_metrics as tmet
from multimodalworddiscovery_tpu_torch.oracles import numpy_mfcc as tmfcc
from multimodalworddiscovery_tpu_torch.oracles import numpy_model1 as tm1
from multimodalworddiscovery_tpu_torch.oracles import numpy_segkmeans as tseg

V_SRC, V_TRG = 9, 6


def _tokens(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    src = [rng.integers(1, V_SRC, size=rng.integers(3, 8)) for _ in range(n)]
    trg = [rng.integers(1, V_TRG, size=rng.integers(1, 4)) for _ in range(n)]
    return src, trg


def _frames(seed: int, n: int = 5, d: int = 3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(rng.integers(4, 9), d)) for _ in range(n)]


def _equal(a, b) -> None:
    """Bitwise equality of nested lists / tuples / dicts of numbers or arrays."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 1])
def test_numpy_hmm_bitwise(seed):
    src, trg = _tokens(seed)
    ours, ref = thmm.NumpyHMM(src, trg, V_SRC, V_TRG), jhmm.NumpyHMM(src, trg, V_SRC, V_TRG)
    _equal(ours.train(3), ref.train(3))
    _equal((ours.log_emit, ours.log_jump, ours.log_p0), (ref.log_emit, ref.log_jump, ref.log_p0))
    _equal(ours.align(), ref.align())
    assert ours.loglik() == ref.loglik()


def test_numpy_model1_bitwise():
    src, trg = _tokens(2)
    ours, ref = tm1.NumpyModel1(src, trg, V_SRC, V_TRG), jm1.NumpyModel1(src, trg, V_SRC, V_TRG)
    _equal(ours.train(3), ref.train(3))
    _equal(ours.t, ref.t)
    _equal(ours.align(), ref.align())
    assert ours.loglik() == ref.loglik()


@pytest.mark.parametrize("k", [1, 2])
def test_numpy_gaussian_hmm_bitwise(k):
    x = _frames(3)
    _, trg = _tokens(3, n=len(x))
    ours = tgauss.NumpyGaussianHMM(x, trg, V_TRG, n_components=k, seed=4)
    ref = jgauss.NumpyGaussianHMM(x, trg, V_TRG, n_components=k, seed=4)
    _equal([ours.em_iteration() for _ in range(2)], [ref.em_iteration() for _ in range(2)])
    _equal((ours.means, ours.log_vars, ours.log_mix, ours.log_jump, ours.log_p0),
           (ref.means, ref.log_vars, ref.log_mix, ref.log_jump, ref.log_p0))
    assert ours.loglik() == ref.loglik()


def test_numpy_segkmeans_bitwise():
    x = _frames(5, d=2)
    cents = np.random.default_rng(6).normal(size=(3, 4 * 2))
    for cls_t, cls_j, kw in ((tseg.NumpySegKMeans, jseg.NumpySegKMeans, {}),
                             (tseg.NumpySegGMM, jseg.NumpySegGMM, {"log_var": 0.3})):
        ours = cls_t(x, cents.copy(), max_seg_len=4, **kw)  # updated in place
        ref = cls_j(x, cents.copy(), max_seg_len=4, **kw)
        _equal([ours.em_iteration() for _ in range(2)], [ref.em_iteration() for _ in range(2)])
        _equal(ours.centroids, ref.centroids)
        _equal(ours.discover(), ref.discover())


def test_numpy_metrics_bitwise():
    rng = np.random.default_rng(7)
    n, t, tt = 5, 10, 3
    lengths = rng.integers(4, t + 1, size=n)
    trg = rng.integers(1, 8, size=(n, tt))
    pred, gold = rng.integers(0, tt + 1, size=(n, t)), rng.integers(0, tt + 1, size=(n, t))
    _equal(tmet.alignment_prf_np(pred, gold, lengths), jmet.alignment_prf_np(pred, gold, lengths))

    def segs(mod, a):
        return [mod.segments_from_alignment_np(a[i], trg[i], lengths[i]) for i in range(n)]

    ps, gs = segs(tmet, pred), segs(tmet, gold)
    _equal(ps, segs(jmet, pred))
    _equal(tmet.word_iou_np(ps, gs), jmet.word_iou_np(ps, gs))
    for tol in (0, 1):
        _equal(tmet.boundary_prf_np(ps, gs, lengths, tol),
               jmet.boundary_prf_np(ps, gs, lengths, tol))
    _equal(tmet.cluster_purity_np(ps, gs, 8), jmet.cluster_purity_np(ps, gs, 8))
    _equal(tmet.cluster_nmi_np(ps, gs, 8), jmet.cluster_nmi_np(ps, gs, 8))
    a, b = rng.normal(size=(6, 3)), rng.normal(size=(9, 3))
    for metric in ("sqeuclidean", "cosine"):
        assert tmet.dtw_np(a, b, metric) == jmet.dtw_np(a, b, metric)


def test_numpy_detector_bitwise():
    rng = np.random.default_rng(8)
    lo = rng.uniform(0, 20, size=(12, 2))
    boxes = np.concatenate([lo, lo + rng.uniform(2, 10, size=(12, 2))], axis=1)
    anchors, gt = boxes[:6], boxes[6:]
    _equal(tdet.iou_matrix(anchors, gt), jdet.iou_matrix(anchors, gt))
    deltas = tdet.encode_boxes(anchors, gt)
    _equal(deltas, jdet.encode_boxes(anchors, gt))
    _equal(tdet.decode_boxes(anchors, deltas), jdet.decode_boxes(anchors, deltas))
    scores = rng.uniform(size=12)
    _equal(tdet.greedy_nms(boxes, scores, 0.3, 0.1), jdet.greedy_nms(boxes, scores, 0.3, 0.1))


@pytest.mark.parametrize("kind", ["mfcc", "fbank"])
def test_numpy_mfcc_matches(kind):
    wav = np.random.default_rng(9).uniform(-1, 1, size=2000)
    got, want = tmfcc.mfcc_np(wav, kind=kind), jmfcc.mfcc_np(wav, kind=kind)
    assert got.shape == want.shape == (11, 13 if kind == "mfcc" else 26)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tmfcc.deltas_np(got), jmfcc.deltas_np(want), rtol=0, atol=1e-12)


def test_oracles_import_no_jax_package():
    """The port's oracles name no module of the JAX package (numpy_mfcc's
    tables come from the port's own frontend)."""
    import inspect

    for mod in (tdet, thmm, tgauss, tmet, tmfcc, tm1, tseg):
        src = inspect.getsource(mod)
        assert "multimodalworddiscovery_tpu." not in src and "import jax" not in src, mod
