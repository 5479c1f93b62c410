"""K3's plain version (the port's Viterbi decoder) vs the JAX reference.

The same corpus (numpy generator, padded with zero-length utterances) and
the same parameters (a few JAX EM steps, carried across) go through the
reference's fused decode kernel in interpret mode, its scan decoder, and
the port.  As in the reference's own test (tests/test_viterbi_pallas.py:
61-65), paths may differ at exact ties, so they must agree on >= 0.99 of
the valid frames and their scores to rtol 1e-5 atol 1e-3.  Against the
scan decoder, which takes the same float32 steps and the same tie rule,
the paths are equal when both get the very same inputs (the port's own
factored transitions differ from the reference's by a few ulps, enough to
flip a near-tie at S=128).
"""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.ops.viterbi_pallas import viterbi_pallas
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import hmm as thmm
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

CASES = {
    "S12": dict(n_utterances=24, n_concepts=60, min_concepts=3, max_concepts=6, seed=7),
    "S40": dict(n_utterances=8, n_concepts=200, min_concepts=17, max_concepts=20,
                min_word_len=2, max_word_len=3, seed=21),
    "S128": dict(n_utterances=4, n_concepts=200, min_concepts=62, max_concepts=64,
                 min_word_len=2, max_word_len=3, seed=21),
    # above 255 states, where 8-bit backpointers no longer hold a state
    "S260": dict(n_utterances=2, n_concepts=200, min_concepts=130, max_concepts=130,
                 min_word_len=2, max_word_len=2, seed=21),
}
N_EMPTY = 3


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = CASES[request.param]
    jc, _, _ = jax_make(**kw)
    tc, _, _ = torch_make(**kw, device="cpu")
    jc, tc = jc.pad_to(jc.n + N_EMPTY), tc.pad_to(tc.n + N_EMPTY)
    jp = jhmm.init(jc)
    for _ in range(3):
        jp, _ = jhmm.em_step(jp, jc)
    tp = thmm.params_from_numpy(
        np.asarray(jp.log_emit), np.asarray(jp.log_jump), np.asarray(jp.log_p0), jp.max_jump,
        device="cpu",
    )
    j_args = (jcore.build_log_init(jp.log_p0, jc),
              *jcore.factor_log_trans(jp.log_jump, jp.log_p0, jc, jp.max_jump),
              jhmm._log_emissions(jp, jc), jc.src_len)
    t_args = (tcore.build_log_init(tp.log_p0, tc),
              *tcore.factor_log_trans(tp.log_jump, tp.log_p0, tc, tp.max_jump),
              thmm._log_emissions(tp, tc), tc.src_len)
    return jc, jp, tc, tp, j_args, t_args


def _score(path, *j_args):
    """``ops/viterbi.path_score`` of a numpy path under the reference's inputs."""
    args = (torch.tensor(np.asarray(a)) for a in j_args)
    return k3.path_score(torch.tensor(np.asarray(path)), *args).numpy()


def test_plain_k3_matches_pallas_decoder(case):
    jc, _, tc, _, j_args, t_args = case
    want = np.asarray(viterbi_pallas(*j_args, interpret=True))
    before = k3.viterbi.launches
    got = k3.viterbi(*t_args)
    assert k3.viterbi.launches == before  # CPU tensors take the plain version
    assert got.dtype == torch.int32 and got.shape == (tc.n, tc.max_src_len)
    mask = np.asarray(jc.src_mask())
    assert (got.numpy() == want)[mask].mean() >= 0.99
    np.testing.assert_allclose(_score(got.numpy(), *j_args), _score(want, *j_args),
                               rtol=1e-5, atol=1e-3)


def test_plain_k3_matches_scan_decoder(case):
    """The same inputs through both decoders give the same path."""
    jc, _, _, _, j_args, _ = case
    want = np.asarray(jcore.viterbi_factored(*j_args))
    got = tcore.viterbi_factored(*(torch.tensor(np.asarray(a)) for a in j_args),
                                 use_kernels=True).numpy()
    np.testing.assert_array_equal(got, want)


def test_kernel_align_matches_jax(case):
    """hmm.align(use_kernels=True), from the port's own factored
    transitions, against the reference's decode."""
    jc, jp, tc, tp, j_args, t_args = case
    want = np.asarray(jhmm.align(jp, jc))
    got = thmm.align(tp, tc, use_kernels=True).numpy()
    mask = np.asarray(jc.src_mask())
    assert (got == want)[mask].mean() >= 0.99
    assert np.all(got[-N_EMPTY:] == 0)
    path = tcore.viterbi_factored(*t_args, use_kernels=True).numpy()
    want_path = np.asarray(jcore.viterbi_factored(*j_args))
    np.testing.assert_allclose(_score(path, *j_args), _score(want_path, *j_args),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("block", [4, 8])
def test_length_order_blocks_give_the_plain_paths(case, block):
    """What K3's warps and blocks rest on: utterances taken longest first
    (ties in index order, the order ranked on the card), each block run
    alone and only up to its longest length, its paths continued with
    their last state (the frozen tail) and put back in the caller's order,
    give the whole batch's paths, empty utterances included; and those
    agree with the reference's decode kernel in interpret mode."""
    jc, _, tc, _, j_args, t_args = case
    log_init, base, rowz, colmask, emit, src_len = t_args
    perm = torch.argsort(src_len, descending=True, stable=True)
    assert src_len[perm[-N_EMPTY:]].tolist() == [0] * N_EMPTY
    whole = k3.viterbi_plain(*t_args)
    got = torch.empty_like(whole)
    for b0 in range(0, tc.n, block):
        idx = perm[b0:b0 + block]
        tmax = max(int(src_len[idx].max()), 1)  # an empty block: argmax of init + emit[0]
        p = k3.viterbi_plain(log_init[idx], base, rowz[idx], colmask[idx], emit[idx, :tmax],
                             src_len[idx])
        got[idx] = torch.cat([p, p[:, -1:].expand(-1, tc.max_src_len - tmax)], dim=1)
    assert torch.equal(got, whole)
    want = np.asarray(viterbi_pallas(*j_args, interpret=True))
    mask = np.asarray(jc.src_mask())
    assert (got.numpy() == want)[mask].mean() >= 0.99
    np.testing.assert_allclose(_score(got.numpy(), *j_args), _score(want, *j_args),
                               rtol=1e-5, atol=1e-3)
