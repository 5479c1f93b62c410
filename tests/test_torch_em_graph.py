"""``hmm.em_step`` off the card, where it never captures a CUDA graph, and
the benchmark's reader of the graph counters
(``portbench/metrics/em_graph_replay_share.py``).  The graph itself runs
only on a card: ``tests/test_torch_cuda.py``."""

import pytest
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.models import hmm
from portbench import run, spec
from portbench.tests.common import tiny_cell

COUNTERS = ("graph_calls", "captures", "replays")
METRIC = "em_graph_replay_share"


def _counters() -> dict:
    return {c: getattr(hmm.em_step, c) for c in COUNTERS}


def _cpu_corpus(n=24, seed=3):
    corpus, _, _ = make_flickr8k_mini(n_utterances=n, seed=seed, device="cpu")
    return corpus


@pytest.mark.parametrize("use_kernels", [None, True, False])
def test_em_step_off_the_card_runs_eagerly(use_kernels):
    """On a CPU corpus (the kernels' plain versions with True, the plain
    route with False) every call is the eager iteration, expected counts
    then the M-step, bit for bit, and nothing is captured or counted."""
    corpus = _cpu_corpus()
    params = hmm.init(corpus)
    graphs = list(hmm._GRAPHS)
    for _ in range(3):
        assert hmm._graph_key(params, corpus, 1e-8, use_kernels, "float32") is None
        got, stats = hmm.em_step(params, corpus, use_kernels=use_kernels)
        counts, ll = hmm.expected_counts(params, corpus, use_kernels)
        want = hmm.m_step(params, counts)
        for f in ("log_emit", "log_jump", "log_p0"):
            assert torch.equal(getattr(got, f), getattr(want, f)), f
        assert torch.equal(stats["loglik"], ll)
        params = got
    assert _counters() == dict.fromkeys(COUNTERS, 0)
    assert list(hmm._GRAPHS) == graphs


def test_reader_without_the_counters_reads_none(monkeypatch):
    for c in COUNTERS:
        monkeypatch.delattr(hmm.em_step, c)
    assert spec.reader(METRIC)(None) is None


def test_reader_after_cpu_calls_reads_none():
    corpus = _cpu_corpus(n=12)
    hmm.train(hmm.init(corpus), corpus, 2)
    assert hmm.em_step.graph_calls == 0
    assert spec.reader(METRIC)(None) is None


def test_reader_gives_the_replayed_share(monkeypatch):
    monkeypatch.setattr(hmm.em_step, "graph_calls", 16)
    monkeypatch.setattr(hmm.em_step, "replays", 14)
    assert spec.reader(METRIC)(None) == 100.0 * 14 / 16


def test_traced_cpu_line_leaves_the_share_out():
    """A traced run of the fused cell on the CPU takes no graphed call: its
    line is correct and lacks the share, and the older readers still read."""
    res = run.run_cell(tiny_cell("hmm_flickr8k.em"), 2147483713, 0.5, True, "cpu",
                       log=lambda m: None)
    assert res["correct"] is True
    assert METRIC not in res["metrics"] and "host_ms_per_iter.fused" in res["metrics"]
