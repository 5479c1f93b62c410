"""Config #4's waveform pipeline on the port (waveforms -> MFCC -> Gaussian
HMM EM -> decode -> segment -> metrics) vs the JAX steps of
``scripts/run_pipeline.py``, on the CPU, and the port's feature-extraction
script.  Both packages start EM from the port's initial parameters (see
``tests/pipeline_reference.py``).  Tolerances, and why:

- EM on the JAX features: each iteration's loglik rtol 1e-5 (the same
  float32 terms summed in another order, tests/test_torch_gaussian.py), the
  alignment equal and the metrics, counts of equal integers, rtol 1e-6;
- the whole pipeline from waveforms: features rtol 1e-3 atol 2e-3 on valid
  frames (K5's bound, tests/test_mfcc_pallas.py:33), then alignment F1
  within 0.01: EM from features that differ in the last digits ends at
  slightly different parameters.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pipeline_reference
from multimodalworddiscovery_tpu.frontend import speech as jspeech
from multimodalworddiscovery_tpu.ops import mfcc_pallas as jmfcc
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.scripts import extract_features as tx
from multimodalworddiscovery_tpu_torch.scripts import run_pipeline as tp

N_UTT = 24
ITERS = 3
MFCC_TOL = dict(rtol=1e-3, atol=2e-3)
METRICS = ("alignment", "word_iou", "boundary", "purity")


@pytest.fixture(scope="module")
def ref():
    return pipeline_reference.reference(N_UTT, ITERS)


def _flat(metrics: dict) -> dict:
    out = {}
    for k in METRICS:
        v = metrics[k]
        out |= {f"{k}.{kk}": vv for kk, vv in v.items()} if isinstance(v, dict) else {k: v}
    return out


def _valid_close(got, want, flens, **tol):
    assert got.shape == want.shape
    for i, fl in enumerate(flens):
        np.testing.assert_allclose(got[i, :fl], want[i, :fl], **tol, err_msg=f"utterance {i}")


def test_em_on_jax_features_matches_jax(ref):
    """The pipeline's EM, decode and scoring stages on the JAX features."""
    want = ref["run"]
    phone_corpus, gold, _ = torch_make(n_utterances=N_UTT, n_phones=tp.N_PHONES, seed=tp.SEED,
                                       device="cpu")
    feats, flens = torch.as_tensor(ref["feats"]), torch.as_tensor(ref["frame_lens"])
    corpus = tp.frame_corpus(feats, flens, phone_corpus)
    assert corpus.src.dtype == torch.float32 and corpus.src_len.dtype == torch.int32
    assert torch.equal(corpus.trg_mask(), phone_corpus.trg_mask())
    p0 = tp.init_params(corpus)
    assert all(np.array_equal(getattr(p0, f).numpy(), ref["init"][f])
               for f in pipeline_reference.FIELDS)
    params, lls = tg.train(p0, corpus, ITERS)
    np.testing.assert_allclose(lls.numpy(), want["loglik"], rtol=1e-5)
    np.testing.assert_array_equal(tg.align(params, corpus).numpy(), want["path"])

    got = tp.fit_and_score(feats, flens, phone_corpus, gold, ITERS)
    np.testing.assert_allclose(got["loglik"], want["loglik"], rtol=1e-5)
    g, w = _flat(got), _flat(want)
    assert g.keys() == w.keys()
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)


def test_run_pipeline_end_to_end_matches_jax(ref):
    want = ref["run"]
    out = tp.run_pipeline(n_utterances=N_UTT, iters=ITERS, device="cpu")
    assert out["shape"] == {"N": N_UTT, "L": out["shape"]["L"], "F": ref["feats"].shape[1],
                            "D": 13, "S": out["shape"]["S"], "C": out["shape"]["C"], "K": 2}
    assert len(out["loglik"]) == ITERS and np.all(np.isfinite(out["loglik"]))
    assert set(out["stage_ms"]) >= {"waveforms", "frontend", "em", "decode", "metrics"}
    assert abs(out["alignment"]["f1"] - want["alignment"]["f1"]) <= 0.01
    assert out["alignment"]["f1"] > 0.2  # EM learned something at this size
    # the features it aligned
    _, _, wavs, wav_lens = tp.synthesize(N_UTT, "cpu")
    feats, flens = tp.frontend(torch.as_tensor(wavs), torch.as_tensor(wav_lens))
    np.testing.assert_array_equal(flens.numpy(), ref["frame_lens"])
    _valid_close(feats.numpy(), ref["feats"], ref["frame_lens"], **MFCC_TOL)


def test_frontend_deltas_and_cmvn_match_jax(ref):
    """The optional stages of the frontend, on the JAX features' inputs."""
    _, _, wavs, wav_lens = tp.synthesize(8, "cpu")
    wav, wl = torch.as_tensor(wavs), torch.as_tensor(wav_lens)
    jf, jl = jmfcc.extract_pallas(jnp.asarray(wavs), jnp.asarray(wav_lens), jspeech.MfccConfig(
        n_mfcc=13, n_mels=26), interpret=True)
    jd = jspeech.add_deltas(jf, jl)
    got, fl = tp.frontend(wav, wl, deltas=True)
    assert got.shape[-1] == 39
    _valid_close(got.numpy(), np.asarray(jd), fl.numpy(), **MFCC_TOL)
    got, _ = tp.frontend(wav, wl, deltas=True, cmvn=True)
    want = np.asarray(jspeech.cmvn(jd, jl))
    # CMVN divides by each utterance's spread: the features' bound, scaled
    scale = 1.0 / np.asarray(jspeech.add_deltas(jf, jl)).std(axis=1, keepdims=True).min()
    _valid_close(got.numpy(), want, fl.numpy(), rtol=1e-3, atol=2e-3 * max(scale, 1.0))


def test_run_pipeline_cli_prints_metrics(capsys):
    out = tp.main(["--utterances", "6", "--iters", "1", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed["alignment"] == out["alignment"]
    assert set(METRICS) <= set(printed) and printed["shape"]["N"] == 6


def test_run_pipeline_on_given_waveforms_is_the_same_run():
    """``data=`` from ``synthesize`` skips the synthesis and nothing else."""
    data = tp.synthesize(6, "cpu")
    got = tp.run_pipeline(n_utterances=6, iters=2, device="cpu", data=data)
    want = tp.run_pipeline(n_utterances=6, iters=2, device="cpu")
    for k in ("loglik", "shape", *METRICS):
        assert got[k] == want[k], k


@pytest.mark.parametrize("kind,batch", [("mfcc", 2), ("fbank", 0)])
def test_extract_features_speech_round_trip(tmp_path, kind, batch):
    """Ragged waveforms in an .npz -> features in an .npz, in fixed-size
    batches, against the reference kernel (interpret mode) per utterance."""
    rng = np.random.default_rng(4)
    lens = [8000, 399, 401, 3000, 5000]
    wavs = {f"arr_{i}": (0.2 * rng.standard_normal(n)).astype(np.float32)
            for i, n in enumerate(lens)}
    np.savez(tmp_path / "wavs.npz", **wavs)
    tx.main(["speech", "--input", str(tmp_path / "wavs.npz"), "--output",
             str(tmp_path / "feats.npz"), "--kind", kind, "--batch-size", str(batch),
             "--device", "cpu"])
    cfg = jspeech.MfccConfig()
    with np.load(tmp_path / "feats.npz") as z:
        assert sorted(z.files) == sorted(wavs)
        for key, w in wavs.items():
            got = z[key]
            n_frames = jspeech.num_frames(len(w), cfg)
            assert got.shape == (n_frames, 26 if kind == "fbank" else 13), key
            if n_frames:
                want, _ = jmfcc.extract_pallas(jnp.asarray(w[None]), None, cfg, kind=kind,
                                               interpret=True)
                np.testing.assert_allclose(got, np.asarray(want)[0], **MFCC_TOL, err_msg=key)


def test_extract_features_image_waits_for_its_slice(tmp_path):
    """``extract_features image`` (ported with the image frontend):
    region embeddings for the images with boxes, whole-image concept
    posteriors (after the resize to the model's input size) for the rest,
    from a torchvision-layout state dict on disk (narrow: fc 64, 10
    classes, 32 x 32 input)."""
    from multimodalworddiscovery_tpu_torch.frontend import image as timg

    model = timg.init_vgg16(num_classes=10, fc_dim=64, input_size=32, device="cpu")
    torch.save(model.state_dict(), tmp_path / "w.pt")
    rng = np.random.default_rng(8)
    imgs = {"arr_0": rng.integers(0, 256, size=(40, 50, 3)).astype(np.uint8),
            "arr_1": rng.integers(0, 256, size=(20, 16, 3)).astype(np.uint8)}
    np.savez(tmp_path / "imgs.npz", **imgs)
    boxes = {"arr_0": [[0.1, 0.1, 0.6, 0.5], [0.2, 0.3, 0.9, 0.9]]}
    (tmp_path / "boxes.json").write_text(json.dumps(boxes))
    tx.main(["image", "--input", str(tmp_path / "imgs.npz"), "--boxes",
             str(tmp_path / "boxes.json"), "--output", str(tmp_path / "y.npz"),
             "--weights", str(tmp_path / "w.pt"), "--device", "cpu"])
    with np.load(tmp_path / "y.npz") as z:
        assert sorted(z.files) == ["arr_0", "arr_1"]
        want = timg.region_embeddings(model, torch.as_tensor(imgs["arr_0"]).float(),
                                      torch.as_tensor(boxes["arr_0"]))
        np.testing.assert_array_equal(z["arr_0"], want.numpy())
        resized = timg.resize(torch.as_tensor(imgs["arr_1"]), 32, 32)
        want = timg.image_concepts(model, resized[None])[0]
        np.testing.assert_array_equal(z["arr_1"], want.numpy())
        assert z["arr_0"].shape == (2, 64) and z["arr_1"].shape == (10,)


def test_pipeline_entry_points_default_to_cuda():
    """With no device named, the pipeline's entry points build on the card:
    on a host without CUDA they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tp.run_pipeline(n_utterances=2, iters=1)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tp.synthesize(2)
