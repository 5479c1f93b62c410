"""The JAX reference of the image pipeline, started from the port's initial
detector and grounding weights.

The JAX package runs the steps of ``scripts/image_pipeline.py`` on the CPU:
``make_flickr8k_mini(N, n_concepts=12, min_concepts=2, max_concepts=4,
seed=0)`` and ``images_for_corpus(image_size=64, seed=0)``, full-batch Adam
training of the detector (its ``make_train_step`` with ``optax.adam(1e-3)``),
``propose(k=8)``, crops of 16 x 16 flattened and compacted to a prefix,
``grounding.train`` at dim 64, then the IoU-matched alignment accuracy
(``null_threshold=-2.0``) and recall@1/5/10.  The initial weights are the
port's (``detector.init`` with a CPU ``torch.Generator`` seeded 0,
``grounding.init`` seeded 1), carried into the JAX package as numpy arrays
with fresh Adam states.  It prints the record, the values of
``chip_smoke.REFERENCE_IMAGE`` and ``REFERENCE_GROUNDING_LOSS``:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/image_reference.py \\
        [--utterances 400 --det-steps 300 --align-iters 300] [--port]

With ``--port`` it also runs the port's pipeline on the CPU at the same
size, and with ``--proposals-out`` too the port's grounding stage from the
JAX proposals.  ``--proposals-out tests/image_reference_proposals.npz`` at
the defaults writes the proposals ``chip_smoke.py`` path 14 runs the port's
grounding stage from: the detector's 300 steps diverge between machines in
float32, and the stage is compared on the same proposals.
``tests/test_torch_detector.py`` runs these functions at a small size.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini
from multimodalworddiscovery_tpu.data.corpus import Corpus
from multimodalworddiscovery_tpu.data.synthetic import images_for_corpus
from multimodalworddiscovery_tpu.eval.retrieval import recall_at_k
from multimodalworddiscovery_tpu.frontend import detector, image
from multimodalworddiscovery_tpu.models import grounding
from multimodalworddiscovery_tpu.oracles.numpy_detector import iou_matrix
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus as TorchCorpus
from multimodalworddiscovery_tpu_torch.frontend import detector as port_detector
from multimodalworddiscovery_tpu_torch.models import flax_params
from multimodalworddiscovery_tpu_torch.models import grounding as port_grounding
from multimodalworddiscovery_tpu_torch.scripts import image_pipeline as port_pipeline

DEFAULTS = port_pipeline.DEFAULTS
PROPOSALS = "tests/image_reference_proposals.npz"


def module_to_flax(model: torch.nn.Module, rename: dict[str, str]) -> dict:
    """A port module's weights as the reference's flax tree {"params": ...}
    of numpy arrays (the inverse of ``flax_params.load_flax_tree``'s layouts
    for Dense, Conv (1-D and 2-D), Embed and LayerNorm)."""
    tree: dict = {}
    owners = [m for _, m in model.named_modules() for _ in m.named_parameters(recurse=False)]
    for module, path, p in zip(owners, flax_params.flax_paths(model, rename), model.parameters()):
        a = p.detach().cpu().numpy()
        if path[-1] == "kernel":
            if isinstance(module, torch.nn.Linear):
                a = a.T
            elif isinstance(module, torch.nn.Conv1d):
                a = a.transpose(2, 1, 0)
            elif isinstance(module, torch.nn.Conv2d):
                a = a.transpose(2, 3, 1, 0)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(a)
    return {"params": tree}


def port_detector_init(config) -> dict:
    """The port's initial detector weights for ``config`` as a flax tree."""
    model = port_detector.init(port_detector.DetectorConfig(*config),
                               torch.Generator().manual_seed(port_pipeline.DET_SEED),
                               device="cpu")
    return module_to_flax(model, {})


def port_grounding_init(region_corpus: Corpus, dim: int) -> dict:
    """The port's initial grounding weights for this region corpus's shapes."""
    t = {k: torch.as_tensor(np.array(getattr(region_corpus, k)))
         for k in ("src", "src_len", "trg", "trg_len")}
    tc = TorchCorpus(**t, src_vocab=region_corpus.src_vocab, trg_vocab=0)
    gen = torch.Generator().manual_seed(port_pipeline.GROUNDING_SEED)
    state = port_grounding.init(tc, dim=dim, generator=gen)
    return module_to_flax(state.model, port_grounding._flax_names(state.model))


def train_detector(config, variables, images, gt_boxes, gt_mask, num_steps: int, lr: float):
    """``detector.train``'s loop from given variables (full batch)."""
    mod = config.module()
    anchors = jnp.asarray(config.anchors())
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(variables)
    step = detector.make_train_step(mod, anchors, optimizer)
    history = []
    for it in range(num_steps):
        variables, opt_state, stats = step(variables, opt_state, images, gt_boxes, gt_mask)
        if (it + 1) % 50 == 0 or it == num_steps - 1:
            history.append({k: float(v) for k, v in stats.items()})
    return mod, variables, history


def jax_run(n_utterances: int = DEFAULTS["n_utterances"],
            n_concepts: int = DEFAULTS["n_concepts"],
            image_size: int = DEFAULTS["image_size"],
            det_steps: int = DEFAULTS["det_steps"],
            align_iters: int = DEFAULTS["align_iters"],
            proposals: int = DEFAULTS["proposals"],
            crop: int = DEFAULTS["crop"],
            proposals_out: str | None = None) -> dict:
    """The JAX package's pipeline from the port's initial weights -> the
    reference script's record (and the detector's loss history).  With
    ``proposals_out`` the detector's proposals (boxes [N, k, 4], keep
    [N, k]) are written there as an .npz."""
    t_all = time.time()
    corpus, gold, _ = make_flickr8k_mini(n_utterances=n_utterances, n_concepts=n_concepts,
                                         min_concepts=2, max_concepts=4, seed=0)
    images, gt_boxes, gt_mask, gt_pos = images_for_corpus(corpus, image_size=image_size, seed=0)
    dcfg = detector.DetectorConfig(image_size=image_size)
    variables = jax.tree.map(jnp.asarray, port_detector_init(dcfg))
    mod, variables, hist = train_detector(dcfg, variables, jnp.asarray(images),
                                          jnp.asarray(gt_boxes), jnp.asarray(gt_mask),
                                          det_steps, port_pipeline.DET_LR)
    anchors = jnp.asarray(dcfg.anchors())
    pb, _, pk = detector.propose(mod, variables, anchors, jnp.asarray(images), k=proposals)
    det_recall = detector.detection_recall(np.asarray(pb), np.asarray(pk), gt_boxes, gt_mask)

    feats = np.asarray(jax.jit(jax.vmap(
        lambda img, bx: image.crop_and_resize(img, bx, size=crop).reshape(bx.shape[0], -1)))(
        jnp.asarray(images), pb))
    keep = np.asarray(pk)
    n, k = keep.shape  # compact the kept proposals to a prefix
    trg_feats = np.zeros((n, k, feats.shape[-1]), np.float32)
    slot_to_prop = np.full((n, k), -1, np.int32)
    trg_len = keep.sum(axis=1).astype(np.int32)
    for i in range(n):
        props = np.nonzero(keep[i])[0]
        trg_feats[i, : len(props)] = feats[i, props]
        slot_to_prop[i, : len(props)] = props
    region_corpus = Corpus(src=corpus.src, src_len=corpus.src_len, trg=jnp.asarray(trg_feats),
                           trg_len=jnp.asarray(np.maximum(trg_len, 1)),
                           src_vocab=corpus.src_vocab, trg_vocab=0)
    dim = port_pipeline.GROUNDING_DIM
    params = jax.tree.map(jnp.asarray, port_grounding_init(region_corpus, dim))
    state = grounding.GroundingParams(params=params, opt_state=optax.adam(1e-3).init(params),
                                      step=jnp.zeros((), jnp.int32), dim=dim)
    state, lls = jax.jit(lambda s: grounding.train(s, region_corpus, align_iters))(state)

    pbn = np.asarray(pb)
    if proposals_out:
        np.savez(proposals_out, boxes=pbn, keep=keep)
    slot_to_goldpos = np.zeros((len(keep), keep.shape[1] + 1), np.int32)
    for i in range(len(keep)):
        gm = gt_mask[i].astype(bool)
        if not gm.any():
            continue
        for s_ in range(trg_len[i]):
            p = slot_to_prop[i, s_]
            ious = iou_matrix(pbn[i, p : p + 1], gt_boxes[i][gm])[0]
            j = int(np.argmax(ious))
            if ious[j] >= 0.5:
                slot_to_goldpos[i, s_ + 1] = gt_pos[i][gm][j]
    pred_slots = np.asarray(grounding.align(state, region_corpus,
                                            null_threshold=port_pipeline.NULL_THRESHOLD))
    pred = np.take_along_axis(slot_to_goldpos, pred_slots, axis=1)
    mask = np.asarray(corpus.src_mask()) & (gold.alignment > 0)
    align_acc = float((pred == gold.alignment)[mask].mean())
    scores = grounding.retrieval_scores(state, region_corpus)
    rec = {k: round(float(v), 3) for k, v in recall_at_k(scores, ks=(1, 5, 10)).items()}
    return {"n": corpus.n, "detector_recall@0.5": round(det_recall, 3),
            "proposals_per_image": round(float(trg_len.mean()), 2),
            "alignment_acc": round(align_acc, 3), **rec,
            "detector_loss": [h["loss"] for h in hist],
            "grounding_loss_steps_0_10": (-np.asarray(lls[:11])).tolist(),
            "total_seconds": round(time.time() - t_all, 1)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--utterances", type=int, default=DEFAULTS["n_utterances"])
    ap.add_argument("--det-steps", type=int, default=DEFAULTS["det_steps"])
    ap.add_argument("--align-iters", type=int, default=DEFAULTS["align_iters"])
    ap.add_argument("--port", action="store_true",
                    help="also run the port's pipeline on the CPU")
    ap.add_argument("--proposals-out", default=None,
                    help="write the detector's proposals there (.npz); at the defaults "
                         "chip_smoke.py reads them from " + PROPOSALS)
    args = ap.parse_args()
    print(json.dumps({"jax": jax_run(args.utterances, det_steps=args.det_steps,
                                     align_iters=args.align_iters,
                                     proposals_out=args.proposals_out)}), flush=True)
    if args.port:
        print(json.dumps({"port": port_pipeline.run_image_pipeline(
            args.utterances, det_steps=args.det_steps, align_iters=args.align_iters,
            device="cpu")}), flush=True)
        if args.proposals_out:  # the port's grounding stage from the JAX proposals
            with np.load(args.proposals_out) as z:
                boxes, keep = z["boxes"], z["keep"]
            data = port_pipeline.paired_corpus(args.utterances, DEFAULTS["n_concepts"],
                                               DEFAULTS["image_size"], "cpu")
            stage = port_pipeline.score_proposals(data, boxes, keep, args.align_iters,
                                                  device="cpu")
            stage["grounding_loss_steps_0_10"] = stage.pop("grounding_loss")[:11]
            print(json.dumps({"port_stage_from_jax_proposals": stage}))


if __name__ == "__main__":
    main()
