"""Config system.

Counterpart of ``multimodalworddiscovery_tpu/core/config.py``.  One
``ConfigDict`` describes a run end to end (data, model, training, eval);
config files under ``multimodalworddiscovery_tpu_torch/configs/`` are
python modules with a ``get_config()`` returning one.

The reference builds on ``ml_collections.ConfigDict``, which the CUDA
host lacks, so this module carries a small ``ConfigDict`` of its own with
the parts the CLI uses: attribute access, ``get``, ``to_dict``,
``to_json`` (the same JSON as ml_collections'), ``unlocked()`` and
ml_collections' type rules on overwrite (an int into a float field becomes
a float; any other change of type is a TypeError).  ``base_config()`` is
the reference's tree key for key, value for value and type for type, so a
``config.json`` written by either CLI, every ``key=value`` override and the
documented commands carry over unchanged.  There is no device key: the
CLI takes ``--device``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Any

# an import of the reference package (the port's own name, which extends
# it, does not match)
_REFERENCE_IMPORT = re.compile(r"^\s*(from|import)\s+multimodalworddiscovery_tpu(?!_torch)\b",
                               re.MULTILINE)


class ConfigDict:
    """Nested attribute dictionary with ml_collections' overwrite rules."""

    def __init__(self, initial: dict | None = None):
        object.__setattr__(self, "_fields", {})
        object.__setattr__(self, "_locked", False)
        for k, v in (initial or {}).items():
            setattr(self, k, v)

    def __getattr__(self, key: str) -> Any:
        try:
            return self._fields[key]
        except KeyError:
            raise AttributeError(repr(key)) from None

    def __setattr__(self, key: str, value: Any) -> None:
        if isinstance(value, dict):
            value = ConfigDict(value)
        fields = self._fields
        if key not in fields:
            if self._locked:
                raise AttributeError(f"key {key!r} does not exist and the config is locked")
            fields[key] = value
            return
        old = fields[key]
        if old is None or value is None or isinstance(value, type(old)):
            fields[key] = value
        elif isinstance(old, float) and isinstance(value, int) and not isinstance(value, bool):
            fields[key] = float(value)
        elif isinstance(old, int) and not isinstance(old, bool) and isinstance(value, bool):
            fields[key] = value
        else:
            raise TypeError(f"Could not override field {key!r}: {value!r} is of type "
                            f"{type(value)} and cannot be cast to type {type(old)}")

    def __repr__(self) -> str:
        return f"ConfigDict({self.to_dict()!r})"

    def get(self, key: str, default: Any = None) -> Any:
        return self._fields.get(key, default)

    def to_dict(self) -> dict:
        """Plain nested dicts (sub-configs included)."""
        return {k: v.to_dict() if isinstance(v, ConfigDict) else v
                for k, v in self._fields.items()}

    def to_json(self, indent: int | None = None, **kw) -> str:
        """``json.dumps`` of the tree in insertion order, as ml_collections
        writes it."""
        return json.dumps(self.to_dict(), indent=indent, **kw)

    def lock(self) -> ConfigDict:
        """Refuse new keys (existing ones stay writable), here and below."""
        object.__setattr__(self, "_locked", True)
        for v in self._fields.values():
            if isinstance(v, ConfigDict):
                v.lock()
        return self

    def unlock(self) -> ConfigDict:
        object.__setattr__(self, "_locked", False)
        for v in self._fields.values():
            if isinstance(v, ConfigDict):
                v.unlock()
        return self

    @property
    def is_locked(self) -> bool:
        return self._locked

    @contextlib.contextmanager
    def unlocked(self):
        """New keys may be added inside; the lock state is restored after."""
        was = self._locked
        self.unlock()
        try:
            yield self
        finally:
            if was:
                self.lock()


def base_config() -> ConfigDict:
    cfg = ConfigDict()

    cfg.seed = 0

    cfg.data = ConfigDict()
    cfg.data.source = "synthetic"  # synthetic | disk | stream
    cfg.data.dir = ""
    cfg.data.name = "flickr8k_mini"
    cfg.data.n_utterances = 200
    cfg.data.n_concepts = 40
    cfg.data.n_phones = 48
    cfg.data.min_concepts = 2  # concepts per image (synthetic generator);
    cfg.data.max_concepts = 4  # state space S = 2 * max concepts per image
    cfg.data.continuous = False  # expand phones to acoustic frames
    cfg.data.feat_dim = 16  # frame dim for the continuous variant
    cfg.data.shard_pad_multiple = 1  # pad N to multiple (devices) for sharding

    cfg.model = ConfigDict()
    cfg.model.name = "model1"
    cfg.model.smoothing = 1e-8
    # HMM-specific knobs (unused by model1)
    cfg.model.max_jump = 3
    cfg.model.self_loop_prob = 0.0
    cfg.model.emission = "discrete"  # discrete | gaussian
    cfg.model.n_components = 2  # GMM components per concept (hmm_gaussian)
    # hmm_gaussian seeding: global | diagonal (flat-start) | vq_teacher
    # (k-means codebook -> discrete-HMM teacher -> emission fit)
    cfg.model.init = "global"
    # k-means-quantize continuous [N,Ts,D] frames into model.vq_codes ids
    # for the DISCRETE aligners (model1/hmm); the codebook persists in the
    # workdir (vq_codebook.npy) so decode/eval re-quantize identically
    cfg.model.vq_frontend = False
    cfg.model.vq_codes = 64  # vq_teacher / vq_frontend codebook size
    cfg.model.teacher_iters = 10  # vq_teacher discrete-HMM EM iterations
    cfg.model.seed_rounds = 3  # vq_teacher emission-fit rounds
    # deterministic annealing (hmm_gaussian): emission temperature ramps
    # anneal_beta0 -> 1 over the first anneal_iters EM iterations (0 = off)
    cfg.model.anneal_beta0 = 0.25
    cfg.model.anneal_iters = 0
    # the hand-written kernels of the HMM family's E-step and decode, under
    # the reference's key name: auto = the kernels on a CUDA corpus, on =
    # required (a CPU corpus raises), off = the plain PyTorch versions
    cfg.model.use_pallas = "auto"  # auto | on | off
    cfg.model.dot_dtype = "float32"  # float32 | bfloat16 E-step product inputs
    # teacher-guided attention (DNN-HMM-DNN hybrid): "" | hmm | hmm_gaussian
    # (the Gaussian teacher is the one for continuous/frame corpora)
    cfg.model.guide = ""
    cfg.model.guide_iters = 15
    cfg.model.guide_weight = 1.0
    # neural aligner knobs (attention / grounding / hmm_dnn)
    cfg.model.dim = 128
    cfg.model.learning_rate = 3e-4
    cfg.model.entropy_weight = 0.0
    cfg.model.subsample = 1  # conv-subsampled encoder stride (attention)
    cfg.model.null_threshold = 0.0  # attention alignment NULL cutoff
    cfg.model.hidden = 256  # hmm_dnn emission MLP width
    cfg.model.n_sgd = 4  # hmm_dnn Adam steps per generalized-EM M-step
    # hmm_crf only: learn log_jump/log_p0 by Adam through the marginal
    # instead of the closed-form count M-step
    cfg.model.learn_transitions = False
    cfg.model.margin = 1.0  # grounding ranking-loss margin
    cfg.model.feat_dim = 0

    cfg.train = ConfigDict()
    cfg.train.num_iterations = 20
    cfg.train.checkpoint_every = 10
    cfg.train.data_parallel = False  # one rank per device over a mesh
    # multi-process run: every rank runs this CLI under torchrun (RANK,
    # WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each rank computes
    # its own corpus slice (parallel/multihost.py)
    cfg.train.distributed = False
    # comma-separated src-length bucket edges ("" = no bucketing); exact
    # bucketed EM for model1/hmm/hmm_gaussian/hmm_dnn (models/bucketed.py)
    cfg.train.bucket_edges = ""
    # minibatch size for the gradient models (attention/grounding/hmm_crf);
    # 0 = full-batch.  With data_parallel, must divide by the rank count.
    cfg.train.batch_size = 0
    # EM models: the E-step over this many corpus chunks per iteration
    # (additive counts): activation memory / num_chunks, exact results
    cfg.train.corpus_chunks = 1
    # also emit TensorBoard scalars to <workdir>/tb (JSONL stays canonical)
    cfg.train.tensorboard = False
    # data.source=stream: shards loaded ahead of compute by the reader
    # thread (out-of-core EM, data/stream.py); 1 = plain double buffering
    cfg.train.stream_prefetch = 1
    # write a torch.profiler trace of the whole training run to
    # <workdir>/profile (open in Perfetto or chrome://tracing)
    cfg.train.profile = False

    cfg.eval = ConfigDict()
    cfg.eval.boundary_tolerance = 1
    cfg.eval.iou_threshold = 0.5
    cfg.eval.retrieval = True
    # 0 = dense N x N retrieval scoring; >0 = recall@k over fixed-size
    # candidate pools (the scalable protocol for MSCOCO-sized corpora)
    cfg.eval.retrieval_pool = 0
    # DTW scoring of discovered units (continuous corpora only): within- vs
    # across-cluster coherence + distance to the closest gold unit
    cfg.eval.dtw = True
    cfg.eval.dtw_max_seg_len = 32
    # the all-pairs DTW matrix is O((utts*segs)^2) DPs: score an explicit
    # sample (logged)
    cfg.eval.dtw_utterances = 64
    cfg.eval.dtw_segments = 8

    return cfg


def port_config_path(path: str | Path) -> Path:
    """The port's copy of a config file of the reference (same file name)."""
    return Path(__file__).resolve().parent.parent / "configs" / Path(path).name


def load_config(path: str | Path) -> ConfigDict:
    """Load ``get_config()`` from a python config file.

    A file that imports the reference package (the repo's root
    ``configs/``) is refused before it runs: it needs JAX and
    ml_collections.  The error names the port's copy."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(path)
    if _REFERENCE_IMPORT.search(path.read_text()):
        copy = port_config_path(path)
        hint = (f"use the port's copy, {copy}" if copy.exists()
                else "build it on multimodalworddiscovery_tpu_torch.core.config.base_config")
        raise SystemExit(f"{path} imports the JAX package (multimodalworddiscovery_tpu), "
                         f"which the port does not load; {hint}")
    spec = importlib.util.spec_from_file_location(path.stem, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.get_config()


def apply_overrides(cfg: ConfigDict, overrides: list[str]) -> ConfigDict:
    """Apply ``key.path=value`` CLI overrides with type coercion (the old
    value's type: bool, then int, then float, else the string)."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not _:
            raise ValueError(f"override must be key=value, got {ov!r}")
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = getattr(node, p)
        old = getattr(node, parts[-1])
        if isinstance(old, bool):
            val = raw.lower() in ("1", "true", "yes")
        elif isinstance(old, int):
            val = int(raw)
        elif isinstance(old, float):
            val = float(raw)
        else:
            val = raw
        setattr(node, parts[-1], val)
    return cfg
