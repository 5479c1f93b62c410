"""The port's learned region-proposal detector against the JAX reference and
the float64 NumPy oracle (``oracles/numpy_detector.py``), on the CPU.

Inputs come from numpy generators with fixed seeds; weights cross over as
flax trees (``detector.params_from_flax``, and ``image_reference.
module_to_flax`` back).  Tolerances, and why:

- ``anchor_grid``: equal (the same numpy code); box geometry against JAX
  atol 1e-6 (the same float32 operations) and against the float64 oracle
  atol 1e-5, as tests/test_detector.py holds the reference;
- ``nms`` and ``match_anchors``: equal, including tied scores of 1.0
  (``lax.top_k``'s lower-index-first order) and two gts forcing one anchor
  (the scatter-max keeps the larger gt index);
- the RPN's outputs from carried weights: rtol 1e-5 atol 1e-6 (checks the
  (h, w, anchor) flatten order);
- ``loss_fn`` rtol 1e-4, and three ``train`` steps (widths (8, 16, 32),
  32 x 32 images): each logged loss rtol 1e-4, parameters atol 1e-5; then
  ``propose`` equal to JAX's (boxes atol 1e-5);
- the image pipeline at a small size against ``tests/image_reference.py``:
  each metric within 0.05; the grounding stage from the reference's
  proposals: its loss over steps 0-10 rtol 1e-4 (the bound
  ``chip_smoke.py`` holds the card to), its metrics within 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import image_reference
from multimodalworddiscovery_tpu.data.synthetic import make_boxes_mini
from multimodalworddiscovery_tpu.frontend import detector as jdet
from multimodalworddiscovery_tpu.oracles import numpy_detector as oracle
from multimodalworddiscovery_tpu_torch.frontend import detector as tdet
from multimodalworddiscovery_tpu_torch.scripts import image_pipeline as tpipe
from multimodalworddiscovery_tpu_torch.scripts import train_detector as ttrain

SMALL = tdet.DetectorConfig(image_size=32, scales=(0.25, 0.45), ratios=(0.7, 1.4),
                            widths=(8, 16, 32), channels=16)
GEO = dict(rtol=0, atol=1e-6)


def _random_boxes(rng, n):
    y1, x1 = rng.uniform(0, 0.8, n), rng.uniform(0, 0.8, n)
    h, w = rng.uniform(0.05, 0.5, n), rng.uniform(0.05, 0.5, n)
    return np.stack([y1, x1, np.minimum(y1 + h, 1), np.minimum(x1 + w, 1)], -1).astype(
        np.float32)


def test_anchor_grid_equals_the_references():
    for args in ((4, 4), (3, 5, (0.2,), (1.0, 2.0))):
        np.testing.assert_array_equal(tdet.anchor_grid(*args), jdet.anchor_grid(*args))


def test_box_geometry_matches_jax_and_oracle():
    rng = np.random.default_rng(0)
    anchors = tdet.anchor_grid(4, 4, scales=(0.2, 0.4), ratios=(1.0,))
    gt = _random_boxes(rng, len(anchors))
    deltas = rng.normal(size=anchors.shape).astype(np.float32) * 2
    a_t, a_j = torch.as_tensor(anchors), jnp.asarray(anchors)
    enc = tdet.encode_boxes(a_t, torch.as_tensor(gt))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jdet.encode_boxes(a_j, jnp.asarray(gt))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(enc.numpy(), oracle.encode_boxes(anchors, gt), atol=1e-5)
    np.testing.assert_allclose(tdet.decode_boxes(a_t, enc).numpy(), gt, atol=1e-5)
    dec = tdet.decode_boxes(a_t, torch.as_tensor(deltas)).numpy()
    np.testing.assert_allclose(dec, np.asarray(jdet.decode_boxes(a_j, jnp.asarray(deltas))), **GEO)
    np.testing.assert_allclose(dec, oracle.decode_boxes(anchors, deltas), atol=1e-5)
    a, b = _random_boxes(rng, 17), _random_boxes(rng, 9)
    iou = tdet.box_iou(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(iou, np.asarray(jdet.box_iou(jnp.asarray(a), jnp.asarray(b))), **GEO)
    np.testing.assert_allclose(iou, oracle.iou_matrix(a, b), atol=1e-5)
    np.testing.assert_allclose(tdet.iou_matrix(a, b), oracle.iou_matrix(a, b), rtol=1e-12)


@pytest.mark.parametrize("case", ["distinct", "ties"])
def test_nms_matches_jax_and_oracle(case):
    """Distinct scores: the kept set equals the oracle's greedy NMS.  Tied
    scores (a third at exactly 1.0, the rest on a coarse grid): candidates,
    scores and keep equal JAX's, batched over two images."""
    rng = np.random.default_rng(1)
    boxes = np.stack([_random_boxes(rng, 40), _random_boxes(rng, 40)])
    if case == "distinct":
        scores = (np.arange(40) * 0.013 + rng.uniform(0, 0.005, 40)).astype(np.float32)
        scores = np.stack([rng.permutation(scores), rng.permutation(scores)])
    else:
        scores = rng.choice(np.float32([1.0, 1.0, 1.0, 0.75, 0.5, 0.25]), size=(2, 40))
    k = 24
    cand, vals, keep = tdet.nms(torch.as_tensor(boxes), torch.as_tensor(scores), k,
                                iou_thresh=0.4, score_thresh=0.3)
    for i in range(2):
        jc, jv, jk = jdet.nms(jnp.asarray(boxes[i]), jnp.asarray(scores[i]), k=k,
                              iou_thresh=0.4, score_thresh=0.3)
        np.testing.assert_array_equal(cand[i].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(vals[i].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(keep[i].numpy(), np.asarray(jk))
        if case == "distinct":
            order = np.argsort(-scores[i], kind="stable")[:k]
            kept = oracle.greedy_nms(boxes[i][order], scores[i][order], iou_thresh=0.4,
                                     score_thresh=0.3)
            got = sorted(map(tuple, cand[i].numpy()[keep[i].numpy()].round(6).tolist()))
            assert got == sorted(map(tuple, boxes[i][order][kept].round(6).tolist()))


def test_top_k_breaks_ties_to_the_lower_index():
    scores = torch.tensor([0.5, 1.0, 1.0, 0.2, 1.0])
    vals, idx = tdet.top_k(scores, 4)
    jv, ji = jax.lax.top_k(jnp.asarray(scores.numpy()), 4)
    assert idx.tolist() == np.asarray(ji).tolist() == [1, 2, 4, 0]
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_match_anchors_matches_jax_with_collisions():
    """Batched over images; image 0 has two identical valid gts (they force
    the same anchor: the larger index wins) and a padded one, image 1 no
    valid gt."""
    rng = np.random.default_rng(3)
    anchors = tdet.anchor_grid(6, 6)
    gts = np.stack([_random_boxes(rng, 4) for _ in range(3)])
    gts[0, 1] = gts[0, 0]
    masks = np.array([[True, True, False, True], [False] * 4, [True, True, True, False]])
    labels, matched = tdet.match_anchors(torch.as_tensor(anchors), torch.as_tensor(gts),
                                         torch.as_tensor(masks))
    for i in range(3):
        jl, jm = jdet.match_anchors(jnp.asarray(anchors), jnp.asarray(gts[i]),
                                    jnp.asarray(masks[i]))
        np.testing.assert_array_equal(labels[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(matched[i].numpy(), np.asarray(jm))
    best = int(np.argmax(oracle.iou_matrix(anchors, gts[0, :1])[:, 0]))
    assert labels[0, best] == 1 and matched[0, best] == 1


@pytest.fixture(scope="module")
def small_setup():
    images, boxes, mask = make_boxes_mini(n_images=6, image_size=32, seed=2)
    jcfg = jdet.DetectorConfig(*SMALL)
    mod, variables = jdet.init(jcfg, jax.random.PRNGKey(4))
    tree = jax.tree.map(np.asarray, variables)
    return images, boxes, mask, jcfg, mod, variables, tree


def test_rpn_outputs_and_loss_match_jax(small_setup):
    images, boxes, mask, jcfg, mod, variables, tree = small_setup
    model = tdet.params_from_flax(tree, device="cpu")
    obj, deltas = model(torch.as_tensor(images))
    j_obj, j_deltas = mod.apply(variables, jnp.asarray(images))
    np.testing.assert_allclose(obj.detach().numpy(), np.asarray(j_obj), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(deltas.detach().numpy(), np.asarray(j_deltas), rtol=1e-5,
                               atol=1e-6)
    anchors = SMALL.anchors()
    loss, stats = tdet.loss_fn(model, torch.as_tensor(anchors), torch.as_tensor(images),
                               torch.as_tensor(boxes), torch.as_tensor(mask))
    j_loss, j_stats = jdet.loss_fn(mod, variables, jnp.asarray(anchors), jnp.asarray(images),
                                   jnp.asarray(boxes), jnp.asarray(mask))
    for k in ("loss", "obj_loss", "box_loss"):
        np.testing.assert_allclose(float(stats[k].detach()), float(j_stats[k]), rtol=1e-4,
                                   err_msg=k)
    assert int(stats["n_pos"]) == int(j_stats["n_pos"])


def test_train_steps_and_propose_match_jax(small_setup, monkeypatch):
    """Three full-batch Adam steps from the same weights (``train``'s
    ``init`` returns the carried ones; the history logs the last step only),
    then ``propose`` on the trained weights."""
    images, boxes, mask, jcfg, mod, variables, tree = small_setup
    monkeypatch.setattr(tdet, "init", lambda *a: tdet.params_from_flax(tree, device="cpu"))
    model, hist = tdet.train(SMALL, torch.as_tensor(images), torch.as_tensor(boxes),
                             torch.as_tensor(mask), num_steps=3, learning_rate=1e-3)
    _, j_vars, j_hist = image_reference.train_detector(
        jcfg, variables, jnp.asarray(images), jnp.asarray(boxes), jnp.asarray(mask), 3, 1e-3)
    assert len(hist) == len(j_hist) == 1
    for k in ("loss", "obj_loss", "box_loss"):
        np.testing.assert_allclose(hist[0][k], j_hist[0][k], rtol=1e-4, err_msg=k)
    want = image_reference.module_to_flax(model, {})["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, j_vars)["params"])[0]:
        got = want
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, leaf, rtol=0, atol=1e-5, err_msg=str(path))
    anchors = SMALL.anchors()
    tb, ts, tk = tdet.propose(model, torch.as_tensor(anchors), torch.as_tensor(images), k=8,
                              score_thresh=0.3)
    jb, js, jk = jdet.propose(mod, j_vars, jnp.asarray(anchors), jnp.asarray(images), k=8,
                              score_thresh=0.3)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    pb, pk = tb.numpy(), tk.numpy()
    assert tdet.detection_recall(pb, pk, boxes, mask) == jdet.detection_recall(pb, pk, boxes,
                                                                                mask)


def test_train_detector_script_runs(capsys):
    """The script's record carries the reference's keys; the loss falls."""
    rec = ttrain.run_train_detector(n_images=8, image_size=32, steps=60, proposals=4,
                                    device="cpu")
    for k in ("train_seconds", "final_loss", "recall_at_0.5_train", "recall_at_0.5_heldout",
              "kept_per_image", "region_crops_shape"):
        assert k in rec, k
    assert rec["loss_history"][-1] < rec["loss_history"][0]
    assert rec["region_crops_shape"] == [4, ttrain.CROP, ttrain.CROP, 3]


def test_image_pipeline_matches_reference(tmp_path):
    """The port's pipeline and the JAX steps of scripts/image_pipeline.py,
    from the same initial weights, at a small size; then the port's
    grounding stage (``score_proposals``) from the reference's own
    proposals, as ``chip_smoke.py`` path 14 runs it at full size."""
    size = dict(n_utterances=24, image_size=32, det_steps=40, align_iters=20)
    got = tpipe.run_image_pipeline(**size, device="cpu")
    want = image_reference.jax_run(**size, proposals_out=str(tmp_path / "p.npz"))
    keys = [k for k in want if k.startswith(("detector_recall", "alignment_acc", "recall@"))]
    assert len(keys) == 8
    for k in keys:
        assert abs(got[k] - want[k]) <= 0.05, (k, got[k], want[k])
    z = np.load(tmp_path / "p.npz")
    data = tpipe.paired_corpus(24, tpipe.DEFAULTS["n_concepts"], 32, "cpu")
    stage = tpipe.score_proposals(data, z["boxes"], z["keep"], align_iters=20, device="cpu")
    assert stage["proposals_per_image"] == want["proposals_per_image"]
    np.testing.assert_allclose(stage["grounding_loss"][:11], want["grounding_loss_steps_0_10"],
                               rtol=1e-4)
    for k in keys[1:]:
        assert abs(stage[k] - want[k]) <= 0.05, (k, stage[k], want[k])


def test_detector_entry_points_default_to_cuda():
    """With no device named, the detector and its scripts build on the card:
    on a host without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    no_cuda = pytest.raises((AssertionError, RuntimeError), match="CUDA")
    with no_cuda:
        tdet.init(SMALL)
    with no_cuda:
        tdet.params_from_flax(image_reference.module_to_flax(
            tdet.init(SMALL, device="cpu"), {}))
    with no_cuda:
        ttrain.run_train_detector(n_images=2, image_size=32, steps=1)
    with no_cuda:
        tpipe.run_image_pipeline(n_utterances=2, image_size=32, det_steps=1, align_iters=1)
