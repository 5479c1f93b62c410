"""The port's dense-region studies (scripts/exp_gauss_dense,
exp_ceiling_fullscale) stage by stage against the JAX package, on the CPU.

Each stage starts from parameters the JAX package drew, carried across with
``hmm_gaussian.params_from_numpy``, on the same corpus (one numpy generator
on both sides: 16 utterances, 10 concepts, 2-3 an image, 4-d frames), and is
held to the calls the root scripts make: the chunked EM
(``chunked_expected_counts`` + ``m_step``, annealed and not), the chunked
supervised counts and ``supervised_fit``, each loglik within rtol 1e-5 and
the decoded accuracy equal.  Then each script's ``main`` runs end to end at
a tiny size on the CPU, and every study script refuses a host without CUDA
unless given ``--device cpu``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models.bucketed import chunked_expected_counts as jchunked
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.scripts import exp_ceiling_fullscale as ceiling
from multimodalworddiscovery_tpu_torch.scripts import exp_crf40k as crf40k
from multimodalworddiscovery_tpu_torch.scripts import exp_gauss_dense as dense
from multimodalworddiscovery_tpu_torch.scripts import self_train as st
from torch_studies_common import both_frames, gauss_to_port, one_thread  # noqa: F401

DENSE = dict(n_utterances=16, n_concepts=10, min_concepts=2, max_concepts=3, seed=0)
CHUNKS = 4  # equal slices of 4: one compile a JAX stage


@pytest.fixture(scope="module")
def dense_corpus():
    """The dense-region study's corpus shape, cut: (JAX corpus, port corpus,
    frame gold, scored-frame mask)."""
    return both_frames(DENSE, dict(feat_dim=4, seed=0))


_j_align = jax.jit(jg.align)
_j_loglik = jax.jit(jg.loglik)
_j_train = jax.jit(jg.train, static_argnums=2)
_j_supervised = jax.jit(jg.supervised_counts)
_j_m_step = jax.jit(jg.m_step)


def _jax_chunk_align(jp, jfc, chunks=CHUNKS):
    csz = -(-jfc.n // chunks)
    return np.concatenate([np.asarray(_j_align(jp, jax.tree.map(
        lambda x: x[i * csz:(i + 1) * csz], jfc))) for i in range(chunks)])[: jfc.n]


def _jax_chunk_accuracy(jp, jfc, gold, mask, chunks=CHUNKS):
    return float((_jax_chunk_align(jp, jfc, chunks) == gold)[mask].mean())


class _Scaled:
    """The root exp_gauss_dense.py's shim: hmm_gaussian at one temperature."""

    def __init__(self, scale):
        self.scale = scale

    def expected_counts(self, p, c):
        return jg.expected_counts(p, c, emit_scale=self.scale)


@jax.jit
def _jax_em_chunked(p, jfc, scale):
    counts, ll = jchunked(_Scaled(scale), p, jfc, CHUNKS)
    return jg.m_step(p, counts), ll


@pytest.mark.parametrize("anneal", [None, (0.25, 2)])
def test_chunked_em_matches_jax(dense_corpus, anneal):
    jfc, fc, fg, wm = dense_corpus
    jp = jg.init_diagonal(jfc, max_jump=dense.MAX_JUMP, n_components=2, key=jax.random.PRNGKey(0))
    tp, lls = dense.chunked_train(gauss_to_port(jp), fc, 3, CHUNKS, anneal)
    want = []
    for scale in tg.anneal_scales(3, anneal):
        jp, ll = _jax_em_chunked(jp, jfc, scale)
        want.append(float(ll))
    np.testing.assert_allclose(lls, want, rtol=1e-5)
    got = dense.accuracy(dense.chunked_align(tg, tp, fc, CHUNKS), fg.alignment, wm)
    assert got == _jax_chunk_accuracy(jp, jfc, fg.alignment, wm)


def test_chunked_supervised_counts_match_jax(dense_corpus):
    """exp_ceiling_fullscale's supervised fit: counts summed over chunks,
    then the M-step, twice."""
    jfc, fc, fg, wm = dense_corpus
    jp = jg.init(jfc, max_jump=dense.MAX_JUMP, n_components=2, key=jax.random.PRNGKey(0))
    tp = ceiling.chunked_supervised_fit(gauss_to_port(jp), fc,
                                        torch.as_tensor(fg.alignment), CHUNKS, rounds=2)
    gold = jnp.asarray(fg.alignment)
    csz = -(-jfc.n // CHUNKS)
    for _ in range(2):
        total = None
        for i in range(CHUNKS):
            sl = slice(i * csz, (i + 1) * csz)
            cts = _j_supervised(jp, jax.tree.map(lambda v: v[sl], jfc), gold[sl])
            total = cts if total is None else jax.tree.map(jnp.add, total, cts)
        jp = _j_m_step(jp, total)
    np.testing.assert_allclose(float(tg.loglik(tp, fc)), float(_j_loglik(jp, jfc)), rtol=1e-5)
    np.testing.assert_array_equal(dense.chunked_align(tg, tp, fc, CHUNKS),
                                  _jax_chunk_align(jp, jfc))
    # and ceiling + EM: the chunked exact EM from there
    tp2 = ceiling.chunked_em(tp, fc, 2, CHUNKS)
    for _ in range(2):
        jp, _ = _jax_em_chunked(jp, jfc, 1.0)
    np.testing.assert_allclose(float(tg.loglik(tp2, fc)), float(_j_loglik(jp, jfc)), rtol=1e-5)


def test_supervised_fit_matches_jax(dense_corpus):
    jfc, fc, fg, wm = dense_corpus
    jp = jg.init_diagonal(jfc, max_jump=dense.MAX_JUMP, n_components=2, key=jax.random.PRNGKey(0))
    tp = tg.supervised_fit(gauss_to_port(jp), fc, torch.as_tensor(fg.alignment), 3)
    jp = jax.jit(jg.supervised_fit, static_argnums=3)(jp, jfc, jnp.asarray(fg.alignment), 3)
    np.testing.assert_allclose(float(tg.loglik(tp, fc)), float(_j_loglik(jp, jfc)), rtol=1e-5)
    got = dense.accuracy(dense.chunked_align(tg, tp, fc, CHUNKS), fg.alignment, wm)
    assert got == _jax_chunk_accuracy(jp, jfc, fg.alignment, wm)


TINY_DENSE = ["--n", "12", "--iters", "2", "--feat-dim", "4", "--concepts", "10", "2", "3",
              "--device", "cpu"]


@pytest.mark.parametrize("script,argv,keys", [
    (dense, [*TINY_DENSE, "--chunks", "3"], set(dense.DOCUMENTED)),  # a padded last slice
    (ceiling, [*TINY_DENSE, "--chunks", "3"], {"supervised_ceiling", "ceiling_plus_2_em"}),
])
def test_dense_studies_run_end_to_end(script, argv, keys):
    out = script.main(argv)
    got = out.get("results") or out["variants"]
    assert set(got) == keys and out["device"] == "cpu"
    for v in got.values():
        acc = v if isinstance(v, float) else v["frame_acc"]
        assert 0.0 <= acc <= 1.0


@pytest.mark.parametrize("script", [dense, ceiling, crf40k, st])
def test_scripts_default_to_the_card(script, monkeypatch):
    """Without --device the scripts run on the card, and refuse a host
    without one rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main([])
