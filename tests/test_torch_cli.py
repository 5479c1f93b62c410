"""The port's CLI (``multimodalworddiscovery_tpu_torch.cli``) against the
JAX package's, on the CPU (``--device cpu``), through the ``cmd_*``
functions as tests/test_cli.py calls them: Model-1 and the discrete HMM
step by step, the guards and flags of tests/test_cli.py, streamed against
resident, two gloo ranks against one process, checkpoints, export keys and
the full-scale pipeline script at a small size."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from multimodalworddiscovery_tpu import cli as jcli
from multimodalworddiscovery_tpu.core import config as jconfig
from multimodalworddiscovery_tpu_torch import cli as pcli
from multimodalworddiscovery_tpu_torch.core import config as pconfig
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini
from multimodalworddiscovery_tpu_torch.parallel import multihost
from multimodalworddiscovery_tpu_torch.utils import checkpoint as pckpt

import torch_parallel_workers as w

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "multimodalworddiscovery_tpu_torch"

PORT_TMPL = """
from multimodalworddiscovery_tpu_torch.core.config import base_config

def get_config():
    cfg = base_config()
    cfg.model.name = {model!r}
    cfg.data.n_utterances = 40
    cfg.data.continuous = {continuous}
    cfg.data.feat_dim = 8
    cfg.train.num_iterations = 4
    cfg.train.checkpoint_every = 2
    cfg.eval.retrieval = {retrieval}
    return cfg
"""


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: its CLI runs are many
    small ops, which torch's thread pool slows by an order of magnitude
    when the suite's other workers hold every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ns(**kw):
    kw.setdefault("device", "cpu")
    return argparse.Namespace(**kw)


def _cfg(tmp_path, model, retrieval=False, continuous=False, name="cfg.py") -> str:
    p = tmp_path / name
    p.write_text(PORT_TMPL.format(model=model, retrieval=retrieval, continuous=continuous))
    return str(p)


def _train(cfg, wd, override=(), fresh=False, cli=pcli):
    kw = {"device": "cpu"} if cli is pcli else {}
    cli.cmd_train(argparse.Namespace(config=cfg, workdir=str(wd), fresh=fresh,
                                     override=list(override), **kw))


def _lls(wd) -> list[float]:
    return [json.loads(line)["loglik"]
            for line in (Path(wd) / "train_metrics.jsonl").read_text().splitlines()]


def _flat(d, pre=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{pre}{k}/")
        else:
            yield f"{pre}{k}", v


def _close_metrics(got: dict, want: dict, tol=1e-6, skip=()):
    g = {k: v for k, v in _flat(got) if not k.startswith(skip)}
    e = {k: v for k, v in _flat(want) if not k.startswith(skip)}
    assert g.keys() == e.keys()
    for k in e:
        assert abs(g[k] - e[k]) <= tol, (k, g[k], e[k])


def _quiet(fn, *a, **kw):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(*a, **kw)


# ---------------------------------------------------------------------------
# Model-1 and the discrete HMM, step by step against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", ["model1", "hmm"])
def test_cli_parity_with_reference(tmp_path, model):
    """The mini configs at N=200 for 4 iterations (the JAX side on its scan
    path, use_pallas=off): logliks rtol 1e-5, alignments and segments equal
    (no tie differs at this size), metrics within 1e-6 (every family and
    the dense retrieval), the same export keys with values within 1e-5, and
    the same config.json."""
    runs = {}
    for tag, cli, cfg, extra in (
        ("jax", jcli, ROOT / "configs" / f"{model}_mini.py", ["model.use_pallas=off"]),
        ("port", pcli, PORT / "configs" / f"{model}_mini.py", ["model.use_pallas=off"]),
    ):
        wd = tmp_path / tag
        kw = {"device": "cpu"} if cli is pcli else {}
        _quiet(_train, str(cfg), wd, ["train.num_iterations=4", *extra], cli=cli)
        for cmd in (cli.cmd_align, cli.cmd_segment, cli.cmd_evaluate):
            _quiet(cmd, argparse.Namespace(workdir=str(wd), output=None, override=[], **kw))
        _quiet(cli.cmd_export, argparse.Namespace(workdir=str(wd), output=None, **kw))
        runs[tag] = wd
    j, p = runs["jax"], runs["port"]
    np.testing.assert_allclose(_lls(p), _lls(j), rtol=1e-5)
    for name in ("alignment.json", "segments.json", "config.json"):
        assert (p / name).read_text() == (j / name).read_text(), name
    _close_metrics(json.loads((p / "metrics.json").read_text()),
                   json.loads((j / "metrics.json").read_text()))
    with np.load(j / "model.npz") as zj, np.load(p / "model.npz") as zp:
        assert zp.files == zj.files
        for k in zj.files:
            np.testing.assert_allclose(zp[k], zj[k], rtol=1e-5, atol=1e-5, err_msg=k)
    # the JAX run's orbax checkpoints are refused, never replaced by a fresh run
    with pytest.raises(RuntimeError, match="orbax"):
        _quiet(_train, str(PORT / "configs" / f"{model}_mini.py"), j,
               ["train.num_iterations=6"])


def _jax_export(params) -> dict[str, np.ndarray]:
    """The JAX package's ``cmd_export`` flattening of a parameter tree."""
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    return {"/".join(getattr(q, "name", None) or str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path): np.asarray(leaf) for path, leaf in flat}


def _unflatten(arrays: dict) -> dict:
    tree: dict = {}
    for key, v in arrays.items():
        node = tree
        *parts, leaf = key.split("/")
        for part in parts:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def _from_export(name: str, arrays: dict, template):
    """The port's params_from_numpy on an export's arrays."""
    from multimodalworddiscovery_tpu_torch.models import (
        attention,
        grounding,
        hmm_dnn,
        hmm_gaussian,
    )

    t = _unflatten(arrays)
    if name == "hmm_gaussian":
        return hmm_gaussian.params_from_numpy(**t, max_jump=template.max_jump, device="cpu")
    if name.startswith("hmm_"):
        kw = dict(max_jump=template.max_jump, hidden=template.hidden,
                  learning_rate=template.learning_rate, n_sgd=template.n_sgd, device="cpu")
        opt = t["opt_state"]
        if "inner_states" in opt:
            m = opt["inner_states"]["mlp"]["inner_state"]["0"]
            tr = opt["inner_states"]["trans"]["inner_state"]["0"]
            kw["adam"] = {"count": m["count"], "mu": m["mu"]["0"], "nu": m["nu"]["0"]}
            kw["adam_trans"] = {"count": tr["count"], "mu": [tr["mu"]["1"], tr["mu"]["2"]],
                                "nu": [tr["nu"]["1"], tr["nu"]["2"]]}
        else:
            kw["adam"] = opt["0"]
        return hmm_dnn.params_from_numpy(t["mlp"], t["log_prior"], t["log_jump"], t["log_p0"],
                                         **kw)
    mod = attention if name == "attention" else grounding
    return mod.params_from_numpy(t["params"], adam=t["opt_state"]["0"], step=int(t["step"]),
                                 learning_rate=template.learning_rate, device="cpu")


EXPORT_MODELS = {
    "hmm_gaussian": ([], True),
    "hmm_dnn": (["model.hidden=16"], True),
    "hmm_crf": (["model.hidden=16", "model.learn_transitions=true"], True),
    "attention": (["model.dim=16"], False),
    "grounding": (["model.dim=16"], False),
}


@pytest.mark.parametrize("name", sorted(EXPORT_MODELS))
def test_export_keys_match_reference(name):
    """``mwd-torch export`` writes the JAX export's keys, shapes and dtypes
    for every model with a pytree of its own (Model-1's and the HMM's in
    test_cli_parity_with_reference), and the port's params_from_numpy
    reads both packages' exports: the port's back bit for bit."""
    extra, continuous = EXPORT_MODELS[name]
    ov = [f"model.name={name}", "data.n_utterances=12", f"data.continuous={continuous}",
          "data.feat_dim=4", *extra]
    jc, pc = jconfig.base_config(), pconfig.base_config()
    jconfig.apply_overrides(jc, ov)
    pconfig.apply_overrides(pc, ov)
    jcorpus, _ = jcli._load_data(jc)
    pcorpus, _ = pcli._load_data(pc, "cpu")
    _, jparams, _ = jcli._make_model(jc, jcorpus, init_only=True)
    pmod, pparams, pstep = pcli._make_model(pc, pcorpus, init_only=True)
    if name != "hmm_gaussian":  # non-zero optimizer moments and step counts
        pparams, _ = pstep(pparams, pcorpus)
    want, got = _jax_export(jparams), pcli._export_arrays(pparams)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
    back = _from_export(name, got, pparams)
    for a, b in zip(w.params_np(back), w.params_np(pparams)):
        np.testing.assert_array_equal(a, b)
    _from_export(name, want, pparams)


# ---------------------------------------------------------------------------
# guards and flags (counterparts of tests/test_cli.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "model", ["model1", "hmm", "hmm_gaussian", "attention", "hmm_dnn", "hmm_crf"])
def test_full_cli_pipeline(tmp_path, model):
    """Counterpart of tests/test_cli.py::test_full_cli_pipeline: train,
    align, segment, evaluate for every aligner (retrieval scored for
    Model-1 and the CRF, whose pair scores re-pair through the DNN-HMM's
    machinery)."""
    continuous = model in ("hmm_gaussian", "hmm_dnn", "hmm_crf")
    cfg = _cfg(tmp_path, model, retrieval=model in ("model1", "hmm_crf"),
               continuous=continuous)
    wd = tmp_path / "run"
    extra = ["model.hidden=32"] if model in ("hmm_dnn", "hmm_crf") else []
    _quiet(_train, cfg, wd, [*extra, "model.dim=32"] if model == "attention" else extra)
    assert (wd / "config.json").exists() and len(_lls(wd)) == 4
    _quiet(pcli.cmd_align, _ns(workdir=str(wd), output=None, override=[]))
    recs = json.loads((wd / "alignment.json").read_text())
    assert len(recs) == 40 and "alignment" in recs[0]
    _quiet(pcli.cmd_segment, _ns(workdir=str(wd), output=None, override=[]))
    assert "segments" in json.loads((wd / "segments.json").read_text())[0]
    _quiet(pcli.cmd_evaluate, _ns(workdir=str(wd), output=None, override=[]))
    metrics = json.loads((wd / "metrics.json").read_text())
    assert 0.0 <= metrics["alignment"]["f1"] <= 1.0
    assert {"boundary", "word_iou", "purity", "nmi"} <= metrics.keys()
    assert ("retrieval" in metrics) == (model in ("model1", "hmm_crf"))
    assert ("dtw" in metrics) == continuous


def test_train_resumes_from_checkpoint(tmp_path, capsys):
    cfg = _cfg(tmp_path, "model1")
    wd = tmp_path / "run"
    _train(cfg, wd)
    assert len(_lls(wd)) == 4
    _train(cfg, wd, ["train.num_iterations=6"])
    assert "resumed from iteration 4" in capsys.readouterr().out
    lines = (wd / "train_metrics.jsonl").read_text().strip().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1, 2, 3, 4, 5]
    whole = tmp_path / "whole"
    _train(cfg, whole, ["train.num_iterations=6"])
    np.testing.assert_allclose(_lls(wd), _lls(whole), rtol=1e-5)


def test_minibatch_resume_draws_what_the_uninterrupted_run_draws(tmp_path, capsys):
    """Step it's minibatch comes from (seed, it) alone."""
    cfg = _cfg(tmp_path, "attention")
    ov = ["train.batch_size=8", "model.dim=16"]
    wd, whole = tmp_path / "run", tmp_path / "whole"
    _train(cfg, wd, [*ov, "train.num_iterations=3"])
    _train(cfg, wd, [*ov, "train.num_iterations=6"])
    assert "resumed from step 3" in capsys.readouterr().out
    _train(cfg, whole, [*ov, "train.num_iterations=6"])
    assert "minibatch steps (B=8)" in capsys.readouterr().out
    np.testing.assert_allclose(_lls(wd), _lls(whole), rtol=1e-5)
    pcli.cmd_align(_ns(workdir=str(wd), output=None, override=[]))
    assert len(json.loads((wd / "alignment.json").read_text())) == 40


def test_train_path_misconfig_errors(tmp_path):
    att, hmm_cfg = _cfg(tmp_path, "attention", name="a.py"), _cfg(tmp_path, "hmm", name="h.py")
    dnn = _cfg(tmp_path, "hmm_dnn", continuous=True, name="d.py")
    for cfg, ov, msg in (
        (att, ["train.bucket_edges=12"], "bucket_edges"),
        (hmm_cfg, ["train.batch_size=8"], "batch_size"),
        (hmm_cfg, ["model.anneal_iters=2"], "anneal"),
        (dnn, ["train.corpus_chunks=2"], "corpus_chunks"),
        (hmm_cfg, ["train.distributed=true"], "data_parallel"),
        (hmm_cfg, ["data.source=stream", f"data.dir={tmp_path}", "train.corpus_chunks=2"],
         "does not compose"),
    ):
        with pytest.raises(SystemExit, match=msg):
            _quiet(_train, cfg, tmp_path / "r", ov)


def test_commands_refuse_the_cpu_unless_asked(tmp_path):
    """No command quietly runs on the CPU: without --device cpu, a host
    without CUDA is an error."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a host without CUDA")
    args = argparse.Namespace(config=_cfg(tmp_path, "hmm"), workdir=str(tmp_path / "r"),
                              fresh=False, override=[])
    with pytest.raises(SystemExit, match="--device cpu"):
        pcli.cmd_train(args)
    with pytest.raises(SystemExit, match="--device cpu"):
        pcli.main(["align", "--workdir", str(tmp_path / "r")])


def test_use_pallas_config_modes():
    """The re-derived rule: auto = the kernels on a CUDA corpus (None), on
    = the kernels (a CPU corpus refused), off = the plain versions."""
    corpus, _, _ = make_flickr8k_mini(n_utterances=10, seed=0, device="cpu")
    cfg = pconfig.base_config()
    cfg.model.use_pallas = "auto"
    assert pcli._resolve_use_pallas(cfg, corpus) is None
    assert pcli._resolve_decode_pallas(cfg, corpus) is None
    cfg.model.use_pallas = "off"
    assert pcli._resolve_use_pallas(cfg, corpus) is False
    assert pcli._resolve_decode_pallas(cfg, corpus) is False
    cfg.model.use_pallas = "on"
    with pytest.raises(ValueError, match="use_pallas=on"):
        pcli._resolve_use_pallas(cfg, corpus)
    cfg.model.use_pallas = "bogus"
    with pytest.raises(ValueError, match="use_pallas"):
        pcli._resolve_use_pallas(cfg, corpus)


def test_train_corpus_chunks_equals_unchunked(tmp_path, capsys):
    cfg = _cfg(tmp_path, "hmm")
    _train(cfg, tmp_path / "chunked", ["train.corpus_chunks=4", "train.num_iterations=6"])
    assert "scans 4 corpus chunks" in capsys.readouterr().out
    _train(cfg, tmp_path / "whole", ["train.num_iterations=6"])
    np.testing.assert_allclose(_lls(tmp_path / "chunked"), _lls(tmp_path / "whole"), rtol=1e-5)
    pcli.cmd_evaluate(_ns(workdir=str(tmp_path / "chunked"), output=None, override=[]))
    metrics = json.loads((tmp_path / "chunked" / "metrics.json").read_text())
    assert metrics["alignment"]["f1"] > 0.5


def test_train_gaussian_vq_teacher_annealed(tmp_path, capsys):
    """model.init=vq_teacher + model.anneal_iters + corpus_chunks, as the
    stretch config runs them, and again with train.data_parallel on a world
    of one rank that the CLI starts itself: the same logliks."""
    cfg = _cfg(tmp_path, "hmm_gaussian", continuous=True)
    ov = ["model.init=vq_teacher", "model.vq_codes=16", "model.teacher_iters=3",
          "model.seed_rounds=2", "model.anneal_iters=2", "train.corpus_chunks=2"]
    _train(cfg, tmp_path / "run", ov)
    out = capsys.readouterr().out
    assert "deterministic annealing" in out and "scans 2 corpus chunks" in out
    assert len(_lls(tmp_path / "run")) == 4
    _train(cfg, tmp_path / "dp", [*ov, "train.data_parallel=true"])
    assert not torch.distributed.is_initialized()
    np.testing.assert_allclose(_lls(tmp_path / "dp"), _lls(tmp_path / "run"), rtol=1e-5)
    pcli.cmd_align(_ns(workdir=str(tmp_path / "dp"), output=None, override=[]))
    assert len(json.loads((tmp_path / "dp" / "alignment.json").read_text())) == 40


def test_guided_attention_data_parallel(tmp_path, capsys):
    """The guide's closure takes and forwards mesh= under data_parallel."""
    cfg = _cfg(tmp_path, "attention")
    _train(cfg, tmp_path / "run", ["model.guide=hmm", "model.guide_iters=3", "model.dim=16",
                                   "train.data_parallel=true", "train.num_iterations=3"])
    assert "attention will be guided" in capsys.readouterr().out
    assert len(_lls(tmp_path / "run")) == 3


def test_train_profile_flag(tmp_path):
    wd = tmp_path / "run"
    pcli.cmd_train(_ns(config=None, workdir=str(wd), fresh=False,
                       override=["data.n_utterances=16", "model.name=hmm",
                                 "train.num_iterations=2", "train.profile=true"]))
    trace = json.loads((wd / "profile" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)


def test_train_bucketed_cli(tmp_path, capsys):
    cfg = _cfg(tmp_path, "hmm")
    _train(cfg, tmp_path / "run", ["train.bucket_edges=12"])
    assert "bucketed EM (2 buckets)" in capsys.readouterr().out
    pcli.cmd_evaluate(_ns(workdir=str(tmp_path / "run"), output=None, override=[]))
    assert json.loads((tmp_path / "run" / "metrics.json").read_text())["alignment"]["f1"] > 0.5


def test_vq_frontend_model1_on_frames(tmp_path):
    cfg = _cfg(tmp_path, "model1", continuous=True)
    wd = tmp_path / "run"
    with pytest.raises((SystemExit, ValueError), match="vq_frontend"):
        _train(cfg, wd)
    _train(cfg, wd, ["model.vq_frontend=true", "model.vq_codes=32"])
    assert (wd / "vq_codebook.npy").exists()
    pcli.cmd_evaluate(_ns(workdir=str(wd), output=None, override=[]))
    assert json.loads((wd / "metrics.json").read_text())["alignment"]["f1"] > 0.4
    pcli.cmd_align(_ns(workdir=str(wd), output=None, override=[]))
    assert len(json.loads((wd / "alignment.json").read_text())) == 40
    with pytest.raises(SystemExit, match="retrain with"):
        pcli.cmd_evaluate(_ns(workdir=str(wd), output=None, override=["model.vq_codes=48"]))
    with pytest.raises(SystemExit, match="discrete aligners"):
        _train(_cfg(tmp_path, "attention", continuous=True, name="a.py"), tmp_path / "r2",
               ["model.vq_frontend=true"])


@pytest.fixture(scope="module")
def hmm_run(tmp_path_factory):
    """A trained discrete HMM workdir (N=40, 10 iterations)."""
    d = tmp_path_factory.mktemp("hmm_run")
    _quiet(_train, _cfg(d, "hmm"), d / "run", ["train.num_iterations=10"])
    return d / "run"


def test_cmd_lexicon(hmm_run):
    pcli.cmd_lexicon(_ns(workdir=str(hmm_run), top_k=3, output=None))
    lex = json.loads((hmm_run / "lexicon.json").read_text())
    assert len(lex) > 5
    first = next(iter(lex.values()))[0]
    assert "phones" in first and first["count"] >= 1
    assert sum(1 for v in lex.values() if v and v[0]["count"] >= 2) > len(lex) // 2


def test_cmd_retrieve(hmm_run):
    pcli.cmd_retrieve(_ns(workdir=str(hmm_run), top_k=5, pool=0, output=None, override=[]))
    rec = json.loads((hmm_run / "retrieval.json").read_text())
    assert len(rec["rankings"]) == 40 and len(rec["rankings"][0]["top_images"]) == 5
    assert rec["recall"]["recall@5_c2i"] > 0.5, rec["recall"]
    pcli.cmd_retrieve(_ns(workdir=str(hmm_run), top_k=5, pool=8, output=None, override=[]))
    rec2 = json.loads((hmm_run / "retrieval.json").read_text())
    assert rec2["recall"]["pool_size"] == 8
    assert rec2["recall"]["recall@1_c2i"] >= rec["recall"]["recall@1_c2i"]


def test_cmd_export_and_plot(hmm_run):
    pcli.cmd_export(_ns(workdir=str(hmm_run), output=None))
    with np.load(hmm_run / "model.npz") as z:
        assert z.files == ["log_emit", "log_jump", "log_p0"]
    pcli.cmd_plot(_ns(workdir=str(hmm_run), utterance=3, output=None))
    for f in ("segmentation_3.png", "posteriors_3.png"):
        assert (hmm_run / "plots" / f).stat().st_size > 0


def test_cmd_discover(tmp_path):
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from multimodalworddiscovery_tpu_torch.core.config import base_config\n"
                   "def get_config():\n"
                   "    c = base_config()\n"
                   "    c.data.n_utterances = 20\n"
                   "    c.data.feat_dim = 8\n"
                   "    c.train.num_iterations = 3\n"
                   "    return c\n")
    wd = tmp_path / "run"
    _quiet(pcli.cmd_discover, _ns(config=str(cfg), workdir=str(wd), clusters=30, output=None,
                                  override=[]))
    recs = json.loads((wd / "discovered_segments.json").read_text())
    assert len(recs) == 20 and "segments" in recs[0]
    assert 0 <= json.loads((wd / "metrics.json").read_text())["boundary"]["f1"] <= 1


def test_cmd_preprocess_flickr8k(tmp_path):
    (tmp_path / "Flickr8k.token.txt").write_text(
        "1.jpg#0\tA dog chases the ball\n2.jpg#0\tA cat sits on grass\n")
    (tmp_path / "lexicon.txt").write_text(
        "a AH\ndog D AO G\nchases CH EY S\nthe DH AH\nball B AO L\n"
        "cat K AE T\nsits S IH T S\non AA N\ngrass G R AE S\n")
    (tmp_path / "concepts.txt").write_text("1.jpg dog ball\n2.jpg cat grass\n")
    out = tmp_path / "corpus"
    _quiet(pcli.cmd_preprocess, _ns(
        dataset="flickr8k", captions=str(tmp_path / "Flickr8k.token.txt"),
        lexicon=str(tmp_path / "lexicon.txt"), concepts=str(tmp_path / "concepts.txt"),
        instances=None, output=str(out), name="f8k"))
    assert (out / "f8k_src.txt").exists() and (out / "f8k_gold.json").exists()
    assert "dog" in json.loads((out / "f8k_vocab.json").read_text())["concepts"]
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from multimodalworddiscovery_tpu_torch.core.config import base_config\n"
                   "def get_config():\n"
                   "    c = base_config()\n"
                   "    c.data.source = 'disk'\n"
                   f"    c.data.dir = {str(out)!r}\n"
                   "    c.data.name = 'f8k'\n"
                   "    c.train.num_iterations = 3\n"
                   "    c.eval.retrieval = False\n"
                   "    return c\n")
    _quiet(_train, str(cfg), tmp_path / "run")
    _quiet(pcli.cmd_evaluate, _ns(workdir=str(tmp_path / "run"), output=None, override=[]))


def test_parser_matches_reference(monkeypatch):
    """The same 11 subcommands and flags as ``mwd``, plus --device."""
    class Got(Exception):
        pass

    def capture(self, *a, **k):
        raise Got(self)

    monkeypatch.setattr(jcli.jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(Got) as got:
        jcli.main()
    monkeypatch.undo()

    def flags(parser):
        sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
        return {name: {s for a in p._actions for s in a.option_strings} - {"-h", "--help"}
                for name, p in sub.choices.items()}

    want, have = flags(got.value.args[0]), flags(pcli.build_parser())
    assert len(want) == 11 and have.keys() == want.keys()
    for name in want:
        assert have[name] == want[name] | {"--device"}, name


def test_python_m_entry_point():
    out = subprocess.run([sys.executable, "-m", "multimodalworddiscovery_tpu_torch.cli",
                          "--help"], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr
    for name in ("train", "discover", "retrieve", "preprocess", "shard", "export", "lexicon",
                 "plot", "align", "segment", "evaluate"):
        assert name in out.stdout


# ---------------------------------------------------------------------------
# streamed against resident; shards of either package
# ---------------------------------------------------------------------------


def test_streamed_equals_resident(tmp_path):
    """shard -> streamed train -> evaluate / align / segment at N=64 in
    shards of 16 against the resident CLI: logliks rtol 1e-5, every metric
    within 1e-6, the same alignments and segments; and the port trains
    from the JAX CLI's shard directory as from its own."""
    cfg = _cfg(tmp_path, "hmm")
    base = ["data.n_utterances=64", "eval.retrieval=false"]
    _quiet(pcli.cmd_shard, _ns(config=cfg, output=str(tmp_path / "shards"), shard_size=16,
                               shuffle=None, storage_dtype=None, override=base))
    _quiet(jcli.cmd_shard, argparse.Namespace(
        config=str(ROOT / "configs" / "hmm_mini.py"), output=str(tmp_path / "jshards"),
        shard_size=16, shuffle=None, storage_dtype=None,
        override=["data.n_utterances=64", "model.max_jump=3"]))
    runs = {"resident": base,
            "streamed": [*base, "data.source=stream", f"data.dir={tmp_path / 'shards'}"],
            "jax_shards": [*base, "data.source=stream", f"data.dir={tmp_path / 'jshards'}"]}
    for tag, ov in runs.items():
        wd = tmp_path / tag
        _quiet(_train, cfg, wd, ov)
        for cmd in (pcli.cmd_evaluate, pcli.cmd_align, pcli.cmd_segment):
            _quiet(cmd, _ns(workdir=str(wd), output=None, override=[]))
        _quiet(pcli.cmd_export, _ns(workdir=str(wd), output=None))
    res, st, js = (tmp_path / t for t in runs)
    np.testing.assert_allclose(_lls(st), _lls(res), rtol=1e-5)
    np.testing.assert_allclose(_lls(js), _lls(st), rtol=1e-6)
    for name in ("alignment.json", "segments.json"):
        assert (st / name).read_text() == (res / name).read_text()
    _close_metrics(json.loads((st / "metrics.json").read_text()),
                   json.loads((res / "metrics.json").read_text()))
    # the streamed workdir's other commands
    _quiet(pcli.cmd_lexicon, _ns(workdir=str(st), top_k=3, output=None))
    _quiet(pcli.cmd_retrieve, _ns(workdir=str(st), top_k=3, pool=8, output=None, override=[]))
    assert json.loads((st / "retrieval.json").read_text())["recall"]["pool_size"] == 8
    with np.load(st / "model.npz") as a, np.load(res / "model.npz") as b:
        for k in b.files:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# two gloo ranks against one process
# ---------------------------------------------------------------------------


def test_distributed_two_ranks_equal_one_process(tmp_path):
    """train.distributed=true on 2 gloo ranks (resident EM, then streamed
    EM over the same corpus's shards) against one process: logliks rtol
    1e-5; only rank 0 writes the metrics and checkpoints."""
    cfg = _cfg(tmp_path, "hmm")
    ov = ["data.n_utterances=40", "train.num_iterations=4"]
    _quiet(pcli.cmd_shard, _ns(config=cfg, output=str(tmp_path / "shards"), shard_size=10,
                               shuffle=None, storage_dtype=None, override=ov))
    stream = ["data.source=stream", f"data.dir={tmp_path / 'shards'}"]
    dist_ov = ["train.distributed=true", "train.data_parallel=true"]
    argvs = [["train", "--device", "cpu", "--config", cfg, "--workdir", str(tmp_path / wd),
              "--override", *ov, *extra, *dist_ov]
             for wd, extra in (("dist", []), ("dist_stream", stream))]
    out = multihost.spawn(w.cli_world, 2, (argvs,), device="cpu", timeout=300,
                          store_dir=str(tmp_path))
    assert [list(map(int, r)) for r in out] == [[2, 0], [2, 1]]
    for wd, extra in (("one", []), ("one_stream", stream)):
        _quiet(_train, cfg, tmp_path / wd, [*ov, *extra])
    np.testing.assert_allclose(_lls(tmp_path / "dist"), _lls(tmp_path / "one"), rtol=1e-5)
    np.testing.assert_allclose(_lls(tmp_path / "dist_stream"), _lls(tmp_path / "one_stream"),
                               rtol=1e-5)
    assert len(_lls(tmp_path / "dist")) == 4  # written once, by rank 0
    assert pckpt.CheckpointManager(tmp_path / "dist" / "ckpt").latest_step() == 3


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


CKPT_MODELS = {
    "model1": ([], False), "hmm": ([], False), "hmm_gaussian": ([], True),
    "hmm_dnn": (["model.hidden=16"], True),
    "hmm_crf": (["model.hidden=16", "model.learn_transitions=true"], True),
    "attention": (["model.dim=16"], False), "grounding": (["model.dim=16"], False),
    "segmental_kmeans": ([], True),
}


def _same_tree(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        assert a == b


@pytest.mark.parametrize("name", sorted(CKPT_MODELS))
def test_checkpoint_round_trips_each_model(tmp_path, name):
    """A checkpoint restores each model's whole parameter tree exactly
    (weights, optimizer moments and counts, step counters) onto a fresh
    template; the newest three are kept."""
    extra, continuous = CKPT_MODELS[name]
    cfg = pconfig.base_config()
    pconfig.apply_overrides(cfg, [f"model.name={name}", "data.n_utterances=12",
                                  f"data.continuous={continuous}", "data.feat_dim=4", *extra])
    corpus, _ = pcli._load_data(cfg, "cpu")
    _, params, step = pcli._make_model(cfg, corpus)
    params, _ = step(params, corpus)
    mgr = pckpt.CheckpointManager(tmp_path / "ckpt")
    for s in range(5):
        mgr.save(s, params)
    assert mgr.latest_step() == 4
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["2", "3", "4"]
    template = pcli._make_model(cfg, corpus, init_only=True)[1]
    restored, s = mgr.restore(template)
    assert s == 4
    assert type(restored) is type(params)
    _same_tree(pckpt._to_state(restored), pckpt._to_state(params))


def test_orbax_checkpoint_is_refused(tmp_path):
    from multimodalworddiscovery_tpu.utils.checkpoint import CheckpointManager as JaxCkpt

    jm = JaxCkpt(tmp_path / "ckpt")
    jm.save(3, {"log_t": jax.numpy.zeros((3, 2))})
    jm.close()
    mgr = pckpt.CheckpointManager(tmp_path / "ckpt")
    assert mgr.latest_step() == 3
    with pytest.raises(RuntimeError, match="orbax"):
        mgr.restore({"log_t": torch.zeros(3, 2)})


# ---------------------------------------------------------------------------
# the package's imports; the full-scale pipeline script
# ---------------------------------------------------------------------------

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|flax|optax|orbax|ml_collections|"
    r"multimodalworddiscovery_tpu)(?![\w])", re.MULTILINE)


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 50
    bad = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}" for f in files
           for m in _FORBIDDEN.finditer(f.read_text())]
    assert not bad, bad


def test_run_pipeline_fullscale_small(tmp_path, capsys):
    from multimodalworddiscovery_tpu_torch.scripts import run_pipeline_fullscale as fs

    report = fs.main(["--utterances", "48", "--shard-size", "16", "--mfcc-batch", "8",
                      "--iters", "2", "--retrieval-pool", "8", "--device", "cpu",
                      "--workdir", str(tmp_path / "fs")])
    assert [s["stage"] for s in report["stages"]] == [
        "synthesize+mfcc+shard", "streamed EM", "streamed align", "streamed segment",
        "streamed evaluate", "resident/streamed cross-check"]
    assert report["synthesize"]["shards"] == 3
    assert report["crosscheck"]["max_abs_delta"] <= 1e-5
    assert report["train_loglik"][1] > report["train_loglik"][0]
    assert "retrieval" in report["metrics"] and "dtw" in report["metrics"]
