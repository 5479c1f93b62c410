"""The set-up metrics read from the port's kernel build counters
(``ops._build.load_s``, ``ops._build.compiled``): they appear in a traced
run's line beside the older metrics, and a program without the counters
gives a line without them, not an error."""

from __future__ import annotations

import pytest

from portbench import run, spec
from portbench.tests.common import tiny_cell

NEW = ("kernel_load_s", "kernels_compiled")


def _traced(name):
    seconds = 2.0 if name.startswith("gauss") else 0.5
    return run.run_cell(tiny_cell(name), 2147483701, seconds, True, "cpu",
                        log=lambda m: None)


@pytest.mark.parametrize("name", ["hmm_flickr8k.em", "hmm_flickr8k.align"])
def test_traced_line_carries_the_build_counters(name):
    from multimodalworddiscovery_tpu_torch.ops import _build

    res = _traced(name)
    assert res["correct"] is True
    metrics = res["metrics"]
    assert metrics["kernel_load_s"] == {"value": _build.load_s, "unit": "s"}
    assert metrics["kernels_compiled"] == {"value": _build.compiled, "unit": "libraries"}
    assert any(k.startswith("host_ms_per_") for k in metrics)  # the older readers still read


def test_program_without_counters_reads_none(monkeypatch):
    from multimodalworddiscovery_tpu_torch.ops import _build

    monkeypatch.delattr(_build, "load_s")
    monkeypatch.delattr(_build, "compiled")
    for name in NEW:
        assert spec.reader(name)(None) is None
    res = _traced("hmm_flickr8k.em")
    assert res["correct"] is True and not set(NEW) & set(res["metrics"])
