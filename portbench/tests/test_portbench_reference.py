"""The plain reference against the port's plain path at a tiny size, and
the controls (the reference in the precision below the configuration's)
against the cells' limits."""

from __future__ import annotations

import pytest
import torch

from portbench import compare, gen
from portbench.families import hmm as fam_hmm
from portbench.families import hmm_gaussian as fam_gauss
from portbench.tests.common import tiny_cell

EM_CELLS = ("hmm_flickr8k.em", "gauss_stretch.em")


def _family(cell):
    return fam_gauss if cell.config["model"] == "hmm_gaussian" else fam_hmm


@pytest.mark.parametrize("name", EM_CELLS)
def test_reference_follows_the_port_plain_em(name):
    cell = tiny_cell(name)
    fam = _family(cell)
    inp = gen.make(cell.config, cell.traffic, 7, "cpu")
    prog = fam.build(cell.config, cell.traffic, inp)
    params, lls, th = prog.init, [], {0: prog.init}
    for it in range(prog.iterations):
        params, ll = prog.step(params, it)
        lls.append(float(ll))
        th[it + 1] = params
    lls_r, ps_r = fam.reference_job(cell.config, inp)
    assert sorted(ps_r) == list(range(prog.iterations + 1)) and len(lls_r) == prog.iterations
    got = fam.judge(cell.config, inp, [lls], [th], detail=True)
    assert got["loglik"] < 1e-6
    if fam is fam_gauss:
        assert got["start"] < 1e-6 and got["step"] < 1e-4
    else:
        assert got["diff_change_1"] < 1e-4 and got["diff_change_3"] < 1e-4
        assert got["diff_change_last"] < 1e-4


@pytest.mark.parametrize("name", EM_CELLS)
def test_control_fails_the_em_limits(name):
    cell = tiny_cell(name)
    fam = _family(cell)
    inp = gen.make(cell.config, cell.traffic, 8, "cpu")
    lls_c, ps_c = fam.reference_job(cell.config, inp, control=True)
    ok, shown = compare.judge(fam.judge(cell.config, inp, [lls_c], [ps_c]),
                              cell.limits["compared"])
    assert not ok, shown


def test_reference_viterbi_agrees_with_the_port_decode():
    cell = tiny_cell("hmm_flickr8k.align")
    inp = gen.make(cell.config, cell.traffic, 9, "cpu")
    prog = fam_hmm.build(cell.config, cell.traffic, inp)
    alignment = prog.decode_device(prog.train(3))
    params_r, best = fam_hmm.reference_align(cell.config, inp, 3)
    gaps = fam_hmm.align_gaps(cell.config, inp, params_r, best, alignment)
    assert float(gaps.abs().max()) < 1e-6
    # the reference's own path scores its best
    _, path = fam_hmm.ref.viterbi(params_r, gen.corpus_tuple(inp), 3, path=True)
    assert float(fam_hmm.align_gaps(cell.config, inp, params_r, best, path).abs().max()) < 1e-9


def test_control_fails_the_decode_limit():
    cell = tiny_cell("hmm_flickr8k.align")
    inp = gen.make(cell.config, cell.traffic, 10, "cpu")
    params_r, best = fam_hmm.reference_align(cell.config, inp, 3)
    gaps = fam_hmm.align_gaps(cell.config, inp, params_r, best,
                              fam_hmm.control_alignment(cell.config, inp, params_r))
    assert float(gaps.max()) > cell.limits["compared"]["viterbi_gap"]


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -9, 3.0], dtype=torch.float32)
    r = fam_hmm.ref.round_tf32(x)
    assert r.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -9, 3.0]
