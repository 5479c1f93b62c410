"""The port's CUDA kernels on the card against their plain versions, at
small shapes.  Marked ``cuda``; each test skips when no CUDA device is
present.  This file imports no JAX, so on a GPU host without JAX run it
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import pytest
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_core
from multimodalworddiscovery_tpu_torch.ops import counts as k1
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd as k2

pytestmark = pytest.mark.cuda

CASES = {
    "S12": dict(n_utterances=40, n_concepts=60, min_concepts=3, max_concepts=6, seed=3),
    "S40": dict(n_utterances=12, n_concepts=200, min_concepts=17,
                max_concepts=20, min_word_len=2, max_word_len=3, seed=21),
}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(name, dev):
    corpus, _, _ = make_flickr8k_mini(**CASES[name])
    corpus = corpus.pad_to(corpus.n + 3).to(dev)
    params, _ = hmm.em_step(hmm.init(corpus), corpus)
    concepts = hmm_core.state_concepts(corpus)
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return corpus, params, concepts, (log_init, base, rowz, colmask)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k1_kernel_exact(dev, name):
    corpus, params, concepts, _ = _inputs(name, dev)
    before = k1.table_lookup.launches
    got = k1.table_lookup(params.log_emit, corpus.src, concepts)
    assert k1.table_lookup.launches == before + 1
    want = k1.table_lookup_plain(params.log_emit, corpus.src, concepts)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_k2_kernel_matches_plain(dev, name):
    corpus, params, concepts, (log_init, base, rowz, colmask) = _inputs(name, dev)
    emit = k1.table_lookup(params.log_emit, corpus.src, concepts)
    args = (log_init, base, rowz, colmask, emit, corpus.src, concepts,
            corpus.src_len, *params.log_emit.shape)
    before = k2.hmm_estep_counts.launches
    counts, xi, logz = k2.hmm_estep_counts(*args)
    assert k2.hmm_estep_counts.launches == before + 1
    counts_p, xi_p, logz_p = k2.hmm_estep_counts_plain(*args)
    torch.testing.assert_close(logz, logz_p, rtol=1e-4, atol=1e-4)
    assert torch.all(logz[-3:] == 0)
    torch.testing.assert_close(logz.sum(), logz_p.sum(), rtol=1e-6, atol=0)
    scale = max(float(counts_p.max()), 1.0)
    torch.testing.assert_close(counts, counts_p, rtol=0, atol=1e-4 * scale)
    torch.testing.assert_close(xi, xi_p, rtol=1e-4, atol=1e-3)


def test_kernel_route_matches_plain_em(dev):
    corpus, params, _, _ = _inputs("S12", dev)
    p_k, lls_k = hmm.train(params, corpus, 3, use_kernels=True)
    p_p, lls_p = hmm.train(params, corpus, 3, use_kernels=False)
    torch.testing.assert_close(lls_k, lls_p, rtol=1e-5, atol=0)
    torch.testing.assert_close(p_k.log_emit, p_p.log_emit, rtol=1e-3, atol=1e-3)


def test_wrappers_validate_inputs(dev):
    corpus, params, concepts, _ = _inputs("S12", dev)
    with pytest.raises(TypeError, match="int32"):
        k1.table_lookup(params.log_emit, corpus.src.long(), concepts)
    with pytest.raises(ValueError, match="contiguous"):
        k1.table_lookup(params.log_emit.t().contiguous().t(), corpus.src, concepts)


def test_unported_route_raises_on_cuda(dev):
    corpus, _, _ = make_flickr8k_mini(n_utterances=6, n_concepts=200, min_concepts=33,
                                      max_concepts=34, min_word_len=2, max_word_len=2,
                                      seed=1, device=dev)
    with pytest.raises(NotImplementedError, match="K4"):
        hmm.expected_counts(hmm.init(corpus), corpus, use_kernels=True)
