"""The port's config system against the JAX package's: the same base tree,
the same nine configs, the same override coercion and the same
``config.json``."""

from __future__ import annotations

import json
from pathlib import Path

import pytest
from ml_collections import ConfigDict as MLConfigDict

from multimodalworddiscovery_tpu import cli as jcli
from multimodalworddiscovery_tpu.core import config as jconfig
from multimodalworddiscovery_tpu_torch import cli as pcli
from multimodalworddiscovery_tpu_torch.core import config as pconfig

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.name for p in (ROOT / "configs").glob("*.py"))
PORT_CONFIGS = ROOT / "multimodalworddiscovery_tpu_torch" / "configs"

OVERRIDES = ["train.num_iterations=7", "model.smoothing=0.5", "train.data_parallel=true",
             "model.name=hmm", "model.learning_rate=2", "eval.retrieval=0",
             "train.bucket_edges=12,20", "data.dir=/data/x", "seed=3"]


def _types(tree):
    return {k: _types(v) if isinstance(v, dict) else type(v).__name__ for k, v in tree.items()}


def test_base_config_equals_reference():
    j, p = jconfig.base_config(), pconfig.base_config()
    assert p.to_dict() == j.to_dict()
    assert _types(p.to_dict()) == _types(j.to_dict())
    assert p.to_json(indent=2) == j.to_json(indent=2)
    assert p.to_json() == j.to_json()


def test_nine_configs_on_disk():
    assert len(CONFIGS) == 9
    assert sorted(p.name for p in PORT_CONFIGS.glob("*.py") if p.name != "__init__.py") == CONFIGS


@pytest.mark.parametrize("name", CONFIGS)
def test_port_config_equals_root_config(name):
    j = jconfig.load_config(ROOT / "configs" / name)
    p = pconfig.load_config(PORT_CONFIGS / name)
    assert p.to_dict() == j.to_dict()
    assert _types(p.to_dict()) == _types(j.to_dict())
    assert p.to_json(indent=2) == j.to_json(indent=2)
    # the reference's file is refused before it runs, naming the port's copy
    with pytest.raises(SystemExit, match=f"configs/{name}"):
        pconfig.load_config(ROOT / "configs" / name)


@pytest.mark.parametrize("name", CONFIGS)
def test_overrides_coerce_as_reference(name):
    j = jconfig.load_config(ROOT / "configs" / name)
    p = pconfig.load_config(PORT_CONFIGS / name)
    jconfig.apply_overrides(j, OVERRIDES)
    pconfig.apply_overrides(p, OVERRIDES)
    assert p.to_dict() == j.to_dict()
    assert _types(p.to_dict()) == _types(j.to_dict())
    assert p.train.num_iterations == 7 and p.model.smoothing == 0.5
    assert p.train.data_parallel is True and p.eval.retrieval is False
    assert p.model.learning_rate == 2.0 and isinstance(p.model.learning_rate, float)


def test_override_types():
    """Counterpart of tests/test_cli.py::test_override_types."""
    cfg = pconfig.base_config()
    pconfig.apply_overrides(
        cfg, ["train.num_iterations=7", "model.smoothing=0.5", "train.data_parallel=true",
              "model.name=hmm"])
    assert cfg.train.num_iterations == 7
    assert cfg.model.smoothing == 0.5
    assert cfg.train.data_parallel is True
    assert cfg.model.name == "hmm"
    with pytest.raises(ValueError, match="key=value"):
        pconfig.apply_overrides(cfg, ["train.num_iterations"])
    with pytest.raises(ValueError):
        pconfig.apply_overrides(cfg, ["train.num_iterations=seven"])


@pytest.mark.parametrize("name", ["hmm_mini.py", "stretch_hubert_clip.py"])
def test_config_json_identical(tmp_path, name):
    """The config.json each CLI writes for the same config and overrides is
    the same JSON, and each CLI reads the other's back."""
    j = jconfig.load_config(ROOT / "configs" / name)
    p = pconfig.load_config(PORT_CONFIGS / name)
    for cfg, mod in ((j, jconfig), (p, pconfig)):
        mod.apply_overrides(cfg, OVERRIDES)
    (tmp_path / "j").mkdir()
    (tmp_path / "p").mkdir()
    jcli._save_config(j, tmp_path / "j")
    pcli._save_config(p, tmp_path / "p")
    jtext = (tmp_path / "j" / "config.json").read_text()
    assert (tmp_path / "p" / "config.json").read_text() == jtext
    assert pcli._load_workdir_config(tmp_path / "j").to_dict() == json.loads(jtext)
    assert jcli._load_workdir_config(tmp_path / "p").to_dict() == json.loads(jtext)


def test_configdict_follows_ml_collections():
    """Overwrite rules, get, unlocked, missing keys: as ml_collections."""
    for cls in (pconfig.ConfigDict, MLConfigDict):
        c = cls()
        c.f = 1.0
        c.f = 2  # an int into a float field becomes a float
        assert c.f == 2.0 and isinstance(c.f, float)
        c.i = 1
        c.i = True  # a bool is an int
        assert c.i is True
        c.s = "x"
        c.s = None
        c.n = None
        c.n = 3
        assert c.n == 3
        for field, bad in (("i", 2.5), ("i", "x"), ("f", "x")):
            with pytest.raises(TypeError):
                setattr(c, field, bad)
        c.sub = cls()
        c.sub.z = 1
        assert c.get("missing", 5) == 5 and c.sub.get("z") == 1
        with pytest.raises(AttributeError):
            _ = c.missing
        with c.unlocked():
            c.extra = 3
        assert c.extra == 3 and not c.is_locked
    p, m = pconfig.ConfigDict(), MLConfigDict()
    for c in (p, m):
        c.a = 1e-8
        c.b = {"z": [1, 2], "y": "s"}
        c.c = float("inf")
    assert p.to_json(indent=2) == m.to_json(indent=2)
    assert p.to_dict() == m.to_dict()
    p.lock()
    with pytest.raises(AttributeError):
        p.new_key = 1
    with p.unlocked():
        p.new_key = 1
    assert p.is_locked and p.new_key == 1
