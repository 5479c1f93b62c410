"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the result line's keys, ``correct`` on the sound program and
false under each fault a cell can have, no card means no result, and no
JAX in the process."""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests.common import ROOT, tiny_cell

CELLS = ("hmm_flickr8k.em", "gauss_stretch.em", "hmm_flickr8k.align")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


def _run(name, build=None, trace=False):
    # long enough for whole jobs of the tiny cell's plain CPU path
    seconds = 2.0 if name.startswith("gauss") else 0.5
    return run.run_cell(tiny_cell(name), 2147483700, seconds, trace, "cpu",
                        log=lambda m: None, build=build)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_with_the_contract_keys(name):
    res = _run(name)
    assert list(res) == KEYS
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    cell = tiny_cell(name)
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    assert set(res["compared"]) == set(cell.limits["compared"])


def _family(name):
    import importlib

    return importlib.import_module(f"portbench.families.{tiny_cell(name).config['model']}")


def _broken_build(name, fault):
    fam = _family(name)

    def build(config, traffic, inp):
        prog = fam.build(config, traffic, inp)
        if fault == "unchanged":
            step = prog.step
            prog.step = lambda p, it: (p, step(p, it)[1])
        elif fault in ("altered", "altered_last") and traffic["loop"] == "em":
            step = prog.step
            first = 0 if fault == "altered" else prog.iterations - 1

            def altered(p, it):
                p, ll = step(p, it)
                if it < first:
                    return p, ll
                field = "log_emit" if hasattr(p, "log_emit") else "log_mix"
                value = getattr(p, field).clone()
                value[1, 0] += 1.0  # phone 1 under NULL; concept 1's first weight
                return dataclasses.replace(p, **{field: value}), ll

            prog.step = altered
        elif fault == "altered":
            decode = prog.decode_device

            def altered(p):
                a = decode(p).clone()
                a[0, 0] = 1 if int(a[0, 0]) != 1 else 2
                return a

            prog.decode_device = altered
        return prog

    return build


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "altered_last"])
def test_broken_program_is_not_correct(name, fault, monkeypatch):
    if fault in ("unchanged", "altered_last") and name.endswith("align"):
        pytest.skip("a decode pass has no state to leave unchanged, and no last iteration")
    if fault == "half_batch":
        from multimodalworddiscovery_tpu_torch.models import hmm, hmm_gaussian

        mod = hmm_gaussian if name.startswith("gauss") else hmm
        orig = mod.expected_counts

        def half(params, corpus, *a, **k):
            n = corpus.n // 2
            sub = dataclasses.replace(corpus, src=corpus.src[:n], src_len=corpus.src_len[:n],
                                      trg=corpus.trg[:n], trg_len=corpus.trg_len[:n])
            counts, ll = orig(params, sub, *a, **k)
            twice = (lambda c: {key: 2 * v for key, v in c.items()}) if isinstance(
                counts, dict) else (lambda c: tuple(2 * v for v in c))
            return twice(counts), 2 * ll

        # the decode cell meets the E-step in set-up's training
        monkeypatch.setattr(mod, "expected_counts", half)
        res = _run(name)
    else:
        res = _run(name, build=_broken_build(name, fault))
    assert res["correct"] is False, res["compared"]


def test_no_card_means_no_result(capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "hmm_flickr8k.em", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_traced_run_keys():
    res = _run("hmm_flickr8k.align", trace=True)
    assert list(res)[-1] == "compared" and res["correct"] is True
    assert "host_ms_per_pass.align" in res["metrics"]


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); from portbench import run; "
            "from portbench.tests.common import tiny_cell; "
            "run.run_cell(tiny_cell('hmm_flickr8k.em'), 3, 0.3, False, 'cpu', log=lambda m: None); "
            "print(run.forbidden_modules(), 'multimodalworddiscovery_tpu_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_lookalike_test", None)
    monkeypatch.setitem(sys.modules, "multimodalworddiscovery_tpu.fake", None)
    assert run.forbidden_modules() == ["multimodalworddiscovery_tpu.fake"]
