"""Shared pieces of the tests of the port's study drivers
(test_torch_studies.py, test_torch_crf40k.py, test_torch_self_train.py):
frame corpora built by both packages from one numpy generator, the
Gaussian HMM's parameters carried from the JAX package into the port, and
one intra-op thread while a module runs."""

import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg

FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")
# self_train's and exp_crf40k's corpus family, cut to 20 utterances
LOOP = dict(n_utterances=20, seed=11)
LOOP_FRAMES = dict(feat_dim=13, noise=0.1, seed=11)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the stages are many small ops, which torch's
    thread pool slows when the suite's other workers hold every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def both_frames(gen: dict, frames: dict):
    """(JAX frame corpus, port frame corpus, frame gold, scored-frame mask),
    the two corpora checked equal."""
    jc, jgold, _ = jax_make(**gen)
    jfc, jfg, _ = jax_frames(jc, jgold, **frames)
    pc, pg, _ = make_flickr8k_mini(**gen, device="cpu")
    fc, fg, _ = phones_to_frames(pc, pg, **frames, device="cpu")
    np.testing.assert_array_equal(fc.src.numpy(), np.asarray(jfc.src))
    np.testing.assert_array_equal(fg.alignment, jfg.alignment)
    return jfc, fc, fg, fc.src_mask().numpy() & (fg.alignment > 0)


def gauss_to_port(jp):
    return tg.params_from_numpy(*(np.asarray(getattr(jp, f)) for f in FIELDS), jp.max_jump,
                                device="cpu")
