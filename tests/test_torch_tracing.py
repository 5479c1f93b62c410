"""The port's spans (``utils/profiling.span``): off, the one shared no-op;
on, host time and calls by name; the models give the same bits either way;
``trace(dir)`` carries them into its Chrome trace and writes their table;
and ``_build``'s load counters on a card.  This file imports no JAX, so on a GPU host run it
without the suite's conftest:

    python -m pytest --noconftest tests/test_torch_tracing.py -q
"""

import json
import time

import pytest
import torch

from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini, phones_to_frames
from multimodalworddiscovery_tpu_torch.models import hmm, hmm_gaussian
from multimodalworddiscovery_tpu_torch.models.bucketed import chunked_expected_counts
from multimodalworddiscovery_tpu_torch.utils import profiling


def _corpus(n=24, seed=3):
    corpus, gold, _ = make_flickr8k_mini(n_utterances=n, seed=seed, device="cpu")
    return corpus, gold


def test_off_span_is_the_shared_noop_and_records_nothing():
    assert profiling.span("a") is profiling.span("b")
    with profiling.spans() as table:
        pass
    with profiling.span("mwd.test.off"):
        pass
    assert table == {}
    assert profiling.span("a") is profiling.span("b")  # off again after the block


def test_on_spans_count_and_time_nested_spans_by_name():
    with profiling.spans() as table:
        for _ in range(3):
            with profiling.span("mwd.test.outer"):
                with profiling.span("mwd.test.inner"):
                    time.sleep(0.002)
                with profiling.span("mwd.test.inner"):
                    pass
    assert set(table) == {"mwd.test.outer", "mwd.test.inner"}
    (outer_ns, outer_calls), (inner_ns, inner_calls) = (table["mwd.test.outer"],
                                                        table["mwd.test.inner"])
    assert (outer_calls, inner_calls) == (3, 6)
    assert inner_ns >= 3 * 2_000_000
    assert outer_ns >= inner_ns


def _same(a, b):
    for field in a.__dataclass_fields__:
        x, y = getattr(a, field), getattr(b, field)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), field
        else:
            assert x == y, field


def test_hmm_em_step_and_align_same_bits_with_spans_on():
    corpus, _ = _corpus()
    p0 = hmm.init(corpus)
    off, ll_off = hmm.em_step(p0, corpus)
    a_off = hmm.align(off, corpus)
    with profiling.spans() as table:
        on, ll_on = hmm.em_step(p0, corpus)
        a_on = hmm.align(on, corpus)
    _same(off, on)
    assert torch.equal(ll_off["loglik"], ll_on["loglik"])
    assert torch.equal(a_off, a_on)
    assert table["mwd.hmm.em_step"][1] == 1 and table["mwd.hmm.align"][1] == 1


def test_gaussian_chunked_step_same_bits_with_spans_on():
    corpus, gold = _corpus(n=20, seed=11)
    frames, _, _ = phones_to_frames(corpus, gold, feat_dim=8, seed=11, device="cpu")
    p0 = hmm_gaussian.init(frames, n_components=2, generator=torch.Generator().manual_seed(0))

    def step():
        stats, ll = chunked_expected_counts(hmm_gaussian, p0, frames, 3, emit_scale=0.5)
        return hmm_gaussian.m_step(p0, stats), ll

    off, ll_off = step()
    with profiling.spans() as table:
        on, ll_on = step()
    _same(off, on)
    assert torch.equal(ll_off, ll_on)
    assert {name: calls for name, (_, calls) in table.items()} == {
        "mwd.gauss.mixture": 3, "mwd.gauss.stats": 3, "mwd.gauss.m_step": 1}


def test_trace_block_writes_the_em_step_span(tmp_path):
    corpus, _ = _corpus(n=12)
    with profiling.trace(tmp_path):
        hmm.em_step(hmm.init(corpus), corpus)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "mwd.hmm.em_step" for e in events)
    table = json.loads((tmp_path / "spans.json").read_text())
    assert table["mwd.hmm.em_step"]["calls"] == 1 and table["mwd.hmm.em_step"]["host_ms"] > 0
    assert profiling.span("a") is profiling.span("b")  # spans off after the block


def test_cli_profile_trace_holds_the_em_step_span(tmp_path):
    import argparse

    from multimodalworddiscovery_tpu_torch import cli

    wd = tmp_path / "run"
    cli.cmd_train(argparse.Namespace(
        config=None, workdir=str(wd), fresh=False, device="cpu",
        override=["data.n_utterances=16", "model.name=hmm", "train.num_iterations=2",
                  "train.profile=true"]))
    trace = json.loads((wd / "profile" / "trace.json").read_text())
    assert any(e.get("name") == "mwd.hmm.em_step" for e in trace["traceEvents"])


@pytest.mark.cuda
def test_build_counters_after_load():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from multimodalworddiscovery_tpu_torch.ops import _build

    _build.load()
    assert _build.load_s > 0.0
    assert isinstance(_build.compiled, int) and 0 <= _build.compiled <= len(
        _build.library_paths())
