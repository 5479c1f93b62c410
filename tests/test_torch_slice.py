"""The ported slice end to end vs the JAX reference, and the port's rules:
corpus -> EM -> Viterbi align -> segment -> alignment P/R/F1 agrees with
the reference; the port imports no JAX; routes whose kernel is not yet
ported raise instead of dropping to the plain path."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu import segment as jsegment
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.eval import metrics as jmetrics
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu_torch import ops as tops
from multimodalworddiscovery_tpu_torch import segment as tsegment
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.eval import metrics as tmetrics
from multimodalworddiscovery_tpu_torch.models import hmm as thmm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEN = dict(n_utterances=48, n_concepts=60, n_phones=48, min_concepts=3,
           max_concepts=6, seed=0)  # bench.py's generator, cut to 48 utterances
N_EMPTY = 4
EM_ITERS = 5
PORT_MODULES = [
    "multimodalworddiscovery_tpu_torch",
    "multimodalworddiscovery_tpu_torch.core",
    "multimodalworddiscovery_tpu_torch.core.counts",
    "multimodalworddiscovery_tpu_torch.core.logsemiring",
    "multimodalworddiscovery_tpu_torch.core.masking",
    "multimodalworddiscovery_tpu_torch.data",
    "multimodalworddiscovery_tpu_torch.data.bucketing",
    "multimodalworddiscovery_tpu_torch.data.corpus",
    "multimodalworddiscovery_tpu_torch.data.flickr30k_entities",
    "multimodalworddiscovery_tpu_torch.data.flickr8k",
    "multimodalworddiscovery_tpu_torch.data.io",
    "multimodalworddiscovery_tpu_torch.data.mscoco",
    "multimodalworddiscovery_tpu_torch.data.stream",
    "multimodalworddiscovery_tpu_torch.data.synthetic",
    "multimodalworddiscovery_tpu_torch.eval",
    "multimodalworddiscovery_tpu_torch.eval.dtw",
    "multimodalworddiscovery_tpu_torch.eval.metrics",
    "multimodalworddiscovery_tpu_torch.eval.retrieval",
    "multimodalworddiscovery_tpu_torch.frontend",
    "multimodalworddiscovery_tpu_torch.frontend.detector",
    "multimodalworddiscovery_tpu_torch.frontend.image",
    "multimodalworddiscovery_tpu_torch.frontend.pretrained",
    "multimodalworddiscovery_tpu_torch.frontend.speech",
    "multimodalworddiscovery_tpu_torch.frontend.vq",
    "multimodalworddiscovery_tpu_torch.models",
    "multimodalworddiscovery_tpu_torch.models.attention",
    "multimodalworddiscovery_tpu_torch.models.bucketed",
    "multimodalworddiscovery_tpu_torch.models.flax_params",
    "multimodalworddiscovery_tpu_torch.models.grounding",
    "multimodalworddiscovery_tpu_torch.models.hmm",
    "multimodalworddiscovery_tpu_torch.models.hmm_core",
    "multimodalworddiscovery_tpu_torch.models.hmm_crf",
    "multimodalworddiscovery_tpu_torch.models.hmm_dnn",
    "multimodalworddiscovery_tpu_torch.models.hmm_gaussian",
    "multimodalworddiscovery_tpu_torch.models.minibatch",
    "multimodalworddiscovery_tpu_torch.models.model1",
    "multimodalworddiscovery_tpu_torch.models.registry",
    "multimodalworddiscovery_tpu_torch.models.segmental_kmeans",
    "multimodalworddiscovery_tpu_torch.native",
    "multimodalworddiscovery_tpu_torch.ops",
    "multimodalworddiscovery_tpu_torch.ops._build",
    "multimodalworddiscovery_tpu_torch.ops.counts",
    "multimodalworddiscovery_tpu_torch.ops.hmm_fwdbwd",
    "multimodalworddiscovery_tpu_torch.ops.log_semiring",
    "multimodalworddiscovery_tpu_torch.ops.mfcc",
    "multimodalworddiscovery_tpu_torch.ops.viterbi",
    "multimodalworddiscovery_tpu_torch.scripts",
    "multimodalworddiscovery_tpu_torch.scripts.ab_tree",
    "multimodalworddiscovery_tpu_torch.scripts.bench_assoc",
    "multimodalworddiscovery_tpu_torch.scripts.bench_estep",
    "multimodalworddiscovery_tpu_torch.scripts.bench_kernels",
    "multimodalworddiscovery_tpu_torch.scripts.bench_stream",
    "multimodalworddiscovery_tpu_torch.scripts.extract_features",
    "multimodalworddiscovery_tpu_torch.scripts.image_pipeline",
    "multimodalworddiscovery_tpu_torch.scripts.k8_phases",
    "multimodalworddiscovery_tpu_torch.scripts.run_pipeline",
    "multimodalworddiscovery_tpu_torch.scripts.train_detector",
    "multimodalworddiscovery_tpu_torch.segment",
    "multimodalworddiscovery_tpu_torch.utils",
    "multimodalworddiscovery_tpu_torch.utils.audio",
    "chip_smoke",
]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ml_collections",
             "multimodalworddiscovery_tpu")


@pytest.fixture(scope="module")
def slice_runs():
    jc, jg, _ = jax_make(**GEN)
    tc, tg, _ = torch_make(**GEN, device="cpu")
    jc, tc = jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)
    gold = np.zeros((tc.n, tc.max_src_len), np.int32)
    gold[: jg.n] = jg.alignment

    jp = jhmm.init(jc)
    for _ in range(EM_ITERS):
        jp, _ = jhmm.em_step(jp, jc)
    j_align = jhmm.align(jp, jc)
    j_segs, j_mask = jsegment.segment_corpus(j_align, jc)
    j_prf = jmetrics.alignment_prf(j_align, gold, jc.src_mask())

    tp, _ = thmm.train(thmm.init(tc), tc, EM_ITERS, use_kernels=True)
    t_align = thmm.align(tp, tc)
    t_segs, t_mask = tsegment.segment_corpus(t_align, tc)
    t_prf = tmetrics.alignment_prf(t_align, torch.as_tensor(gold), tc.src_mask())
    return {
        "jax": (np.array(j_align), np.array(j_segs), np.array(j_mask),
                {k: float(v) for k, v in j_prf.items()}),
        "torch": (t_align.numpy(), t_segs.numpy(), t_mask.numpy(),
                  {k: float(v) for k, v in t_prf.items()}),
        "gold": gold,
    }


def test_slice_end_to_end_matches_jax(slice_runs):
    j_align, j_segs, j_mask, j_prf = slice_runs["jax"]
    t_align, t_segs, t_mask, t_prf = slice_runs["torch"]
    np.testing.assert_array_equal(t_align, j_align)
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_segs, j_segs)
    for k in ("precision", "recall", "f1", "aer"):
        np.testing.assert_allclose(t_prf[k], j_prf[k], rtol=1e-6, err_msg=k)
    assert t_prf["f1"] > 0.5  # EM learned something at this size


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segments_from_alignment_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, ts, tt = 16, 12, 4
    align = rng.integers(0, tt + 1, size=(n, ts)).astype(np.int32)
    align[:, ::3] = align[:, 1::3][:, : align[:, ::3].shape[1]]  # runs
    trg = rng.integers(1, 30, size=(n, tt)).astype(np.int32)
    lens = rng.integers(0, ts + 1, size=n).astype(np.int32)
    j_segs, j_mask = jsegment.segments_from_alignment(align, trg, lens)
    t_segs, t_mask = tsegment.segments_from_alignment(
        torch.as_tensor(align), torch.as_tensor(trg), torch.as_tensor(lens)
    )
    np.testing.assert_array_equal(t_mask.numpy(), np.array(j_mask))
    np.testing.assert_array_equal(t_segs.numpy(), np.array(j_segs))


@pytest.mark.parametrize("seed", [0, 1])
def test_alignment_prf_matches_jax(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, 4, size=(20, 9)).astype(np.int32)
    gold = rng.integers(0, 4, size=(20, 9)).astype(np.int32)
    mask = rng.random((20, 9)) < 0.8
    want = jmetrics.alignment_prf(pred, gold, mask)
    got = tmetrics.alignment_prf(
        torch.as_tensor(pred), torch.as_tensor(gold), torch.as_tensor(mask)
    )
    for k in ("precision", "recall", "f1", "aer"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    stats = tmetrics.alignment_stats(
        torch.as_tensor(pred), torch.as_tensor(gold), torch.as_tensor(mask)
    )
    assert float(stats["n_pred"]) == float(((pred > 0) & mask).sum())


def test_alignment_prf_empty_is_zero():
    z = torch.zeros((3, 4), dtype=torch.int32)
    out = tmetrics.alignment_prf(z, z, torch.ones((3, 4), dtype=torch.bool))
    assert float(out["f1"]) == 0.0 and float(out["precision"]) == 0.0


def test_port_imports_no_jax():
    """Every port module (and chip_smoke.py) imports without pulling in
    jax, flax, optax, orbax or the reference package."""
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_chip_smoke_refuses_without_gpu():
    """With no CUDA device the smoke script exits nonzero and prints no
    result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_estep_route_gate():
    route = thmm.estep_route
    assert route(12, 49, 61, False, "float32") == "plain"
    assert route(12, 49, 61, True, "float32") == "fused"
    assert route(64, 128, 256, True, "float32") == "fused"
    # outside the fused gate: K1 then K4, the general E-step kernel
    for s, v_src, v_trg in ((66, 49, 61), (12, 129, 61), (12, 49, 257)):
        assert route(s, v_src, v_trg, True, "float32") == "general"
    # dot_dtype="bfloat16" takes the same routes, through K2-bf16 / K4-bf16
    assert route(12, 49, 61, True, "bfloat16") == "fused"
    assert route(66, 49, 61, True, "bfloat16") == "general"
    assert route(12, 49, 61, False, "bfloat16") == "plain"
    with pytest.raises(ValueError, match="dot_dtype"):
        route(12, 49, 61, True, "float16")


def test_expected_counts_cpu_outside_gate_uses_plain_estep():
    """Outside the fused gate a CPU corpus runs K4's plain version; it agrees
    with the dense plain E-step within the reference's tolerances (counts
    atol 1e-4 x scale, loglik rtol 1e-6, widths rtol 1e-4 atol 1e-3)."""
    corpus, _, _ = torch_make(n_utterances=6, n_concepts=200, min_concepts=33,
                              max_concepts=34, min_word_len=2, max_word_len=2, seed=1,
                              device="cpu")
    assert 2 * corpus.max_trg_len > 64
    params = thmm.init(corpus)
    (ec, wc), ll = thmm.expected_counts(params, corpus, use_kernels=True)
    (ec_p, wc_p), ll_p = thmm.expected_counts(params, corpus, use_kernels=False)
    scale = max(float(ec_p.max()), 1.0)
    torch.testing.assert_close(ec, ec_p, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(wc, wc_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(ll, ll_p, rtol=1e-6, atol=0)


def test_use_kernels_none_follows_the_device():
    """use_kernels=None means the kernels on a CUDA tensor and their plain
    versions on a CPU tensor; an explicit value is kept."""
    cpu, cuda = torch.device("cpu"), torch.device("cuda", 0)
    assert tops.kernels_for(None, cpu) is False
    assert tops.kernels_for(None, cuda) is True
    for dev in (cpu, cuda):
        assert tops.kernels_for(False, dev) is False
        assert tops.kernels_for(True, dev) is True
