"""Port segmental k-means and its GMM variant vs the JAX reference and the
float64 oracle (``oracles/numpy_segkmeans.py``).

The frames corpus comes from the numpy generator with a fixed seed (the
same in both packages); centroids cross over with ``params_from_numpy``.
Tolerances: ``embed_all_segments`` atol 1e-6; from carried centroids the
distortion rtol 1e-5 and the segmentation exact; against the oracle as
``tests/test_segmental_kmeans.py`` holds the reference.
"""

import jax
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import segmental_kmeans as jskm
from multimodalworddiscovery_tpu.oracles.numpy_segkmeans import NumpySegGMM, NumpySegKMeans
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus as TCorpus
from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as tskm

GEN = dict(n_utterances=24, seed=21)
FRAMES = dict(feat_dim=8, noise=0.05, seed=21)


@pytest.fixture(scope="module")
def frames():
    jc, jg, _ = jax_make(**GEN)
    jfc, _, _ = jax_frames(jc, jg, **FRAMES)
    tc, tg, _ = torch_make(**GEN, device="cpu")
    tfc, tfg, _ = torch_frames(tc, tg, **FRAMES, device="cpu")
    np.testing.assert_array_equal(tfc.src.numpy(), np.array(jfc.src))
    return jfc.pad_to(jfc.n + 2), tfc.pad_to(tfc.n + 2), tfg


def _sub(c, n):
    return TCorpus(src=c.src[:n], src_len=c.src_len[:n], trg=c.trg[:n], trg_len=c.trg_len[:n],
                   src_vocab=0, trg_vocab=c.trg_vocab)


@pytest.mark.parametrize("n_samples,max_seg_len", [(4, 8), (3, 5)])
def test_embed_all_segments_matches_jax(frames, n_samples, max_seg_len):
    jfc, tfc, _ = frames
    want = np.array(jskm.embed_all_segments(jfc.src, n_samples, max_seg_len))
    got = tskm.embed_all_segments(tfc.src, n_samples, max_seg_len).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _carried(jp, gmm=False):
    kw = dict(n_samples=jp.n_samples, max_seg_len=jp.max_seg_len, min_seg_len=jp.min_seg_len,
              device="cpu")
    if gmm:
        kw["log_var"] = np.array(jp.log_var)
    return tskm.params_from_numpy(np.array(jp.centroids), **kw)


@pytest.mark.parametrize("min_seg_len", [1, 2])
def test_em_step_and_discover_match_jax(frames, min_seg_len):
    """Three EM iterations from the JAX init's centroids: the distortion
    rtol 1e-5 and the segment count exact each iteration, the centroids
    atol 1e-5, and discover's segmentation exact before and after."""
    jfc, tfc, _ = frames
    jp = jskm.init(jfc, n_clusters=16, min_seg_len=min_seg_len, key=jax.random.PRNGKey(0))
    tp = _carried(jp)
    for it in range(3):
        js, _ = jskm.discover(jp, jfc)
        ts, tmask = tskm.discover(tp, tfc)
        np.testing.assert_array_equal(ts.numpy(), np.array(js), err_msg=f"iter {it}")
        jp, jstats = jskm.em_step(jp, jfc)
        tp, tstats = tskm.em_step(tp, tfc)
        np.testing.assert_allclose(float(tstats["loglik"]), float(jstats["loglik"]), rtol=1e-5)
        assert int(tstats["n_segments"]) == int(jstats["n_segments"])
        np.testing.assert_allclose(tp.centroids.numpy(), np.array(jp.centroids), rtol=0,
                                   atol=1e-5)
    _, lls = tskm.train(_carried(jskm.init(jfc, n_clusters=16, key=jax.random.PRNGKey(0))),
                        tfc, 3)
    assert lls.shape == (3,) and bool(torch.isfinite(lls).all())


def test_em_step_gmm_matches_jax(frames):
    jfc, tfc, _ = frames
    jp = jskm.init_gmm(jfc, n_clusters=12, key=jax.random.PRNGKey(5))
    tp = _carried(jp, gmm=True)
    for _ in range(3):
        jp, jstats = jskm.em_step_gmm(jp, jfc)
        tp, tstats = tskm.em_step_gmm(tp, tfc)
        np.testing.assert_allclose(float(tstats["loglik"]), float(jstats["loglik"]), rtol=1e-5)
        assert int(tstats["n_segments"]) == int(jstats["n_segments"])
        np.testing.assert_allclose(tp.centroids.numpy(), np.array(jp.centroids), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(float(tp.log_var), float(jp.log_var), rtol=1e-5)
    np.testing.assert_array_equal(tskm.discover_gmm(tp, tfc)[0].numpy(),
                                  np.array(jskm.discover_gmm(jp, jfc)[0]))


def test_em_step_matches_numpy_oracle(frames):
    """As tests/test_segmental_kmeans.py holds the reference: segmentation
    before the update exact, then per iteration the segment count, the
    distortion rtol 1e-4 and the centroids rtol 1e-3 atol 1e-3."""
    _, tfc, _ = frames
    sub = _sub(tfc, 8)
    params = tskm.init(sub, n_clusters=8, n_samples=4, max_seg_len=6, min_seg_len=2,
                       generator=torch.Generator().manual_seed(3))
    x, sl = sub.src.numpy(), sub.src_len.numpy()
    oracle = NumpySegKMeans([x[i, : sl[i]] for i in range(8)], params.centroids.numpy(),
                            n_samples=4, max_seg_len=6, min_seg_len=2)
    segs, mask = tskm.discover(params, sub)
    got = [[tuple(int(v) for v in segs[i, t]) for t in range(segs.shape[1]) if mask[i, t]]
           for i in range(8)]
    assert got == oracle.discover()
    for it in range(2):
        o_cost, o_nseg = oracle.em_iteration()
        params, stats = tskm.em_step(params, sub)
        assert int(stats["n_segments"]) == o_nseg, f"iter {it}"
        np.testing.assert_allclose(-float(stats["loglik"]), o_cost, rtol=1e-4)
        np.testing.assert_allclose(params.centroids.double().numpy(), oracle.centroids,
                                   rtol=1e-3, atol=1e-3)


def test_em_step_gmm_matches_numpy_oracle(frames):
    _, tfc, _ = frames
    sub = _sub(tfc, 6)
    params = tskm.init_gmm(sub, n_clusters=8, n_samples=4, max_seg_len=6, min_seg_len=2,
                           generator=torch.Generator().manual_seed(5))
    x, sl = sub.src.numpy(), sub.src_len.numpy()
    oracle = NumpySegGMM([x[i, : sl[i]] for i in range(6)], params.centroids.numpy(),
                         log_var=float(params.log_var), n_samples=4, max_seg_len=6,
                         min_seg_len=2)
    for it in range(2):
        o_cost, o_nseg = oracle.em_iteration()
        params, stats = tskm.em_step_gmm(params, sub)
        assert int(stats["n_segments"]) == o_nseg, f"iter {it}"
        np.testing.assert_allclose(-float(stats["loglik"]), o_cost, rtol=1e-3)
        np.testing.assert_allclose(params.centroids.double().numpy(), oracle.centroids,
                                   rtol=1e-2, atol=1e-2)
        np.testing.assert_allclose(float(params.log_var), oracle.log_var, rtol=1e-3, atol=1e-3)


def test_init_draws_distinct_valid_segments(frames):
    _, tfc, _ = frames
    p1 = tskm.init(tfc, n_clusters=20, generator=torch.Generator().manual_seed(7))
    p2 = tskm.init(tfc, n_clusters=20, generator=torch.Generator().manual_seed(7))
    assert torch.equal(p1.centroids, p2.centroids)  # one seed, one draw
    assert torch.unique(p1.centroids, dim=0).shape[0] == 20
    emb = tskm.embed_all_segments(tfc.src, 4, 8)
    ok = tskm._valid_candidates(tfc, emb.shape[1], 8).reshape(-1)
    pool = emb.reshape(-1, emb.shape[-1])[ok]
    assert all(bool((pool == c).all(-1).any()) for c in p1.centroids)


def test_segmentation_is_partition(frames):
    _, tfc, _ = frames
    params = tskm.init(tfc, n_clusters=16, generator=torch.Generator().manual_seed(0))
    params, _ = tskm.em_step(params, tfc)
    segs, mask = tskm.discover(params, tfc)
    sl = tfc.src_len.numpy()
    for i in range(tfc.n):
        covered = np.zeros(sl[i], int)
        for s in np.where(mask[i].numpy())[0]:
            st, en, lbl = segs[i, s].tolist()
            assert 0 <= st < en <= sl[i] and lbl >= 1
            covered[st:en] += 1
        assert (covered == 1).all(), i

