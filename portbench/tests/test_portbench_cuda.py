"""On the card, at each cell's own size: a short run is correct, and the
control (the reference in the precision below the configuration's, in the
program's place) fails one of the cell's limits.  Skips without a card;
on a CUDA host: ``python -m pytest portbench/tests/test_portbench_cuda.py``."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, compare, run, spec
from portbench.tests.common import BENCHMARK

CELLS = ("hmm_flickr8k.em", "gauss_stretch.em", "hmm_flickr8k.align")


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    res = run.run_cell(spec.load_cell(name, BENCHMARK), 2147483651, 2.0, False, card,
                       log=lambda m: None)
    assert res["correct"] is True, res["compared"]
    assert res["device"]["platform"] == "gpu" and res["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit(card, name):
    cell = spec.load_cell(name, BENCHMARK)
    reading = calibrate.control_reading(cell, 97, card)["control"]
    ok, shown = compare.judge(reading, cell.limits["compared"])
    assert not ok, shown
