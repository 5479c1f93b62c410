"""The port's length bucketing (data/bucketing.py, models/bucketed.py)
against the JAX reference, on the CPU: the bucketed counterparts of
tests/test_bucketed.py.

Buckets are equal to the JAX package's (same rows, same arrays, same
padding waste).  Bucketed EM against the JAX package's unbucketed EM from
the same parameters: loglik rtol 1e-4, parameters rtol 1e-3 atol 1e-3
(tests/test_bucketed.py:45-48 and :81-87; only the float addition order
differs); the DNN-HMM's pooled neural update against the port's resident
one: parameters rtol 1e-3 atol 1e-4 (:110-114).  Bucketed decode agrees with
the full decode on more than 0.999 of positions (:50-52).  The chunked
E-step against the unchunked one: rtol 1e-5 on the loglik, rtol 1e-4
atol 1e-4 on counts (:156-168).
"""

import jax
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.bucketing import bucket_corpus as jax_bucket_corpus
from multimodalworddiscovery_tpu.data.bucketing import padding_waste as jax_padding_waste
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models import model1 as jm1
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.data.bucketing import bucket_corpus, padding_waste
from multimodalworddiscovery_tpu_torch.models import bucketed
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as tdnn
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.models import model1 as tm1

FIELDS = ("src", "src_len", "trg", "trg_len")
G_FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")


def _pair(**gen):
    jc, jgold, _ = jax_make(**gen)
    tc, tgold, _ = torch_make(**gen, device="cpu")
    return jc, jgold, tc, tgold


def _frames(n, seed):
    jc, jgold, tc, tgold = _pair(n_utterances=n, seed=seed)
    jf, _, _ = jax_frames(jc, jgold, feat_dim=8, seed=seed)
    tf, _, _ = torch_frames(tc, tgold, feat_dim=8, seed=seed, device="cpu")
    return jf, tf


def _jax_em(mod, params, corpus, iters, **kw):
    step = jax.jit(lambda p, c: mod.em_step(p, c, **kw))
    lls = []
    for _ in range(iters):
        params, stats = step(params, corpus)
        lls.append(float(stats["loglik"]))
    return params, lls


@pytest.mark.parametrize("edges, min_size", [([10, 16], 1), ([12], 1), ([5, 10, 15], 100),
                                             ([8, 12, 16], 6)])
def test_bucket_corpus_matches_jax(edges, min_size):
    """The same rows in the same buckets, the same arrays and padding
    waste; every utterance lands in one bucket."""
    jc, _, tc, _ = _pair(n_utterances=50, seed=6)
    got, want = bucket_corpus(tc, edges, min_size), jax_bucket_corpus(jc, edges, min_size)
    assert len(got) == len(want)
    for (b, idx), (jb, jidx) in zip(got, want):
        np.testing.assert_array_equal(idx, jidx)
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)))
        assert padding_waste(b) == pytest.approx(jax_padding_waste(jb), abs=1e-12)
    all_idx = np.concatenate([idx for _, idx in got])
    assert sorted(all_idx.tolist()) == list(range(50))
    assert padding_waste(tc) == pytest.approx(jax_padding_waste(jc), abs=1e-12)


def test_bucketing_cuts_padding_waste():
    _, _, tc, _ = _pair(n_utterances=50, seed=6)
    buckets = bucket_corpus(tc, [10, 16])
    waste = sum(padding_waste(b) * b.n * b.max_src_len for b, _ in buckets)
    assert waste < padding_waste(tc) * tc.n * tc.max_src_len
    assert all(b.max_src_len <= tc.max_src_len for b, _ in buckets)


def test_bucketed_model1_matches_jax():
    jc, _, tc, _ = _pair(n_utterances=40, seed=7)
    pj, lls_j = _jax_em(jm1, jm1.init(jc), jc, 4)
    pb, lls_b = bucketed.train_bucketed(tm1, tm1.init(tc), tc, [12], 4)
    np.testing.assert_allclose(lls_b, lls_j, rtol=1e-4)
    np.testing.assert_allclose(pb.log_t.numpy(), np.asarray(pj.log_t), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_bucketed_hmm_matches_jax_and_decodes(use_kernels):
    """Through the plain E-step and through the kernel route's plain
    versions (K1, K2), then the bucketed decode (K3's plain version)."""
    jc, _, tc, _ = _pair(n_utterances=30, seed=8)
    pj, lls_j = _jax_em(jhmm, jhmm.init(jc), jc, 3)
    pb, lls_b = bucketed.train_bucketed(thmm, thmm.init(tc), tc, [12], 3,
                                        use_kernels=use_kernels)
    np.testing.assert_allclose(lls_b, lls_j, rtol=1e-4)
    np.testing.assert_allclose(pb.log_emit.numpy(), np.asarray(pj.log_emit), rtol=1e-3,
                               atol=1e-3)
    a_full = np.asarray(jhmm.align(pj, jc))
    a_b = bucketed.align_bucketed(thmm, pb, tc, [12], use_kernels=use_kernels)
    assert a_b.shape == a_full.shape and (a_full == a_b).mean() > 0.999


def test_bucketed_gaussian_matches_jax():
    jf, tf = _frames(24, 11)
    jp = jg.init(jf, n_components=2, key=jax.random.PRNGKey(0))
    p0 = tg.params_from_numpy(*(np.asarray(getattr(jp, f)) for f in G_FIELDS), jp.max_jump,
                              device="cpu")
    pj, lls_j = _jax_em(jg, jp, jf, 3, smoothing=1e-6)
    edges = [int(np.median(tf.src_len.numpy()))]
    pb, lls_b = bucketed.train_bucketed(tg, p0, tf, edges, 3, smoothing=1e-6)
    np.testing.assert_allclose(lls_b, lls_j, rtol=1e-4)
    for f in ("means", "log_vars"):
        np.testing.assert_allclose(getattr(pb, f).numpy(), np.asarray(getattr(pj, f)),
                                   rtol=1e-3, atol=1e-3, err_msg=f)


def test_bucketed_dnn_matches_resident():
    """The pooled per-bucket CE gradients give the unbucketed neural
    update (the port's resident em_step, held to the JAX package's in
    tests/test_torch_hmm_dnn.py)."""
    _, tf = _frames(20, 12)

    def p0():
        return tdnn.init(tf, hidden=32, n_sgd=2, generator=torch.Generator().manual_seed(1))

    p_full, lls_full = p0(), []
    for _ in range(2):
        p_full, s = tdnn.em_step(p_full, tf, smoothing=1e-6)
        lls_full.append(float(s["loglik"]))
    edges = [int(np.median(tf.src_len.numpy()))]
    pb, lls_b = bucketed.train_bucketed(tdnn, p0(), tf, edges, 2, smoothing=1e-6)
    np.testing.assert_allclose(lls_b, lls_full, rtol=1e-4)
    np.testing.assert_allclose(pb.log_prior.numpy(), p_full.log_prior.numpy(), rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(pb.mlp.parameters(), p_full.mlp.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-3,
                                   atol=1e-4)


def test_on_iteration_callback_and_mesh():
    _, _, tc, _ = _pair(n_utterances=20, seed=5)
    seen = []
    bucketed.train_bucketed(thmm, thmm.init(tc), tc, [12], 3,
                            on_iteration=lambda it, p, ll: seen.append((it, ll)))
    assert [it for it, _ in seen] == [0, 1, 2]
    assert all(np.isfinite(ll) for _, ll in seen)
    with pytest.raises(TypeError, match="DeviceMesh"):  # over ranks: test_torch_multihost.py
        bucketed.train_bucketed(thmm, thmm.init(tc), tc, [12], 1, mesh=object())


@pytest.mark.parametrize("mod_name", ["hmm", "model1"])
def test_chunked_expected_counts_matches_unchunked(mod_name):
    """37 utterances in 5 (or 4) chunks, the last padded: the port's
    chunked E-step against its unchunked one and the JAX package's."""
    jc, _, tc, _ = _pair(n_utterances=37, seed=19)
    jmod, tmod, chunks = {"hmm": (jhmm, thmm, 5), "model1": (jm1, tm1, 4)}[mod_name]
    params = tmod.init(tc)
    want, ll_want = tmod.expected_counts(params, tc)
    got, ll_got = bucketed.chunked_expected_counts(tmod, params, tc, num_chunks=chunks)
    np.testing.assert_allclose(float(ll_got), float(ll_want), rtol=1e-5)
    _, ll_jax = jmod.expected_counts(jmod.init(jc), jc)
    np.testing.assert_allclose(float(ll_got), float(ll_jax), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_chunked_expected_counts_passes_estep_kwargs():
    """hmm_gaussian's annealing temperature flows through the chunks."""
    _, tf = _frames(24, 11)
    p = tg.init(tf, generator=torch.Generator().manual_seed(0))
    want, ll_want = tg.expected_counts(p, tf, emit_scale=0.5)
    got, ll_got = bucketed.chunked_expected_counts(tg, p, tf, num_chunks=3, emit_scale=0.5)
    np.testing.assert_allclose(float(ll_got), float(ll_want), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=1e-4,
                                   err_msg=k)
