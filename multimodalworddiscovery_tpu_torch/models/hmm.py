"""Discrete HMM aligner: multinomial emissions over the phone vocabulary.

Counterpart of ``multimodalworddiscovery_tpu/models/hmm.py``.  States are
the paired image's concepts (plus paired NULL states), emissions are
multinomial over phones, transitions are Vogel-style jump-width weights;
trained with batched forward-backward EM and decoded with Viterbi.

One EM step on the kernel route (``use_kernels=True``, the default for a
CUDA corpus: None resolves to ``corpus.device.type == "cuda"``) inside the fused
gate is the K1 lookup kernel (ops/counts.py) followed by the K2 fused
E-step kernel (ops/hmm_fwdbwd.py), which hands back the pooled emission
counts and transition posteriors; then one projection onto jump widths and
the M-step.  Outside the gate it is K1, then K4, the general E-step kernel,
then K7 (ops/counts.pair_counts), which adds K4's posteriors into the
(phone, concept) counts.  ``dot_dtype="bfloat16"`` runs the bf16 variants
of K2 and K4 (K7 stays float32).  ``use_kernels=False`` runs the plain
dense fwd-bwd (hmm_core.estep) and the plain count scatter-add.  Decode with
``use_kernels=True`` runs K3 (ops/viterbi.py).

``em_step`` on the fused route on the card replays the iteration as one
CUDA graph: K1, the transition factors, K2 with its length ranking, the
width projection, the M-step and the loglik's sum, some 45 launches that
the host would otherwise enqueue one by one.  A key (the corpus tensors by
identity, address, shape, stride and dtype; the parameters' shapes, strides,
dtypes and device; the vocabularies, ``max_jump``, ``smoothing``,
``dot_dtype``) runs eagerly on its first call, which fills the caches the
iteration reads, and is captured on its own memory pool on its second;
every later call copies the parameters into the graph's input buffers,
replays, and returns clones of its outputs, so what an earlier call
returned is never overwritten.  The graph holds the corpus
it read, and the last ``MAX_GRAPHS`` keys are kept.  A replay adds to each
kernel's ``.launches`` what the capture added, so the counters still count
kernels that ran; ``em_step.graph_calls``, ``.captures`` and ``.replays``
count the calls on this path.  Every other call (a CPU corpus, the plain or
general route, the callers of ``expected_counts``) runs eagerly as before.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.counts import pair_counts, table_lookup
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import hmm_core
from multimodalworddiscovery_tpu_torch.ops import counts as counts_ops
from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd, kernels_for
from multimodalworddiscovery_tpu_torch.utils.profiling import span

# The fused route's gate, as in the reference (models/hmm.py:110-115).
FUSED_MAX_STATES = 64
FUSED_MAX_SRC_VOCAB = 128
FUSED_MAX_TRG_VOCAB = 256
# The fused iterations' CUDA graphs (``_IterationGraph``) by ``_graph_key``,
# least recently used first; a key's entry is None from its first call (run
# eagerly) to its second (the capture).
MAX_GRAPHS = 4
_GRAPHS: collections.OrderedDict = collections.OrderedDict()


@dataclasses.dataclass(frozen=True)
class HMMParams:
    """log emission table [V_src, V_trg] (col 0 = NULL concept), unnormalized
    log jump weights [2*max_jump+1], scalar log null weight."""

    log_emit: torch.Tensor
    log_jump: torch.Tensor
    log_p0: torch.Tensor
    max_jump: int = 3


def init(corpus: Corpus, max_jump: int = 3) -> HMMParams:
    if corpus.src.ndim != 2:
        raise ValueError(
            "the discrete HMM's emissions are multinomial over token ids "
            f"(src must be [N, Ts], got {tuple(corpus.src.shape)})"
        )
    f32 = dict(dtype=torch.float32, device=corpus.device)
    v_src, v_trg = corpus.src_vocab, corpus.trg_vocab
    w = 2 * max_jump + 1
    log_v = torch.log(torch.tensor(float(v_src), **f32))
    return HMMParams(
        log_emit=(-log_v).expand(v_src, v_trg).contiguous(),
        # mild preference for +1 jumps breaks the uniform-EM symmetry
        log_jump=-0.5 * torch.abs(torch.arange(w, **f32) - max_jump - 1),
        log_p0=torch.log(torch.tensor(0.2, **f32)),
        max_jump=max_jump,
    )


def params_from_numpy(
    log_emit, log_jump, log_p0, max_jump: int = 3, device="cuda"
) -> HMMParams:
    """Carry parameters across from host arrays (e.g. the JAX reference's)
    onto ``device``."""
    def t(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    return HMMParams(
        log_emit=t(log_emit).contiguous(), log_jump=t(log_jump),
        log_p0=t(log_p0).reshape(()), max_jump=int(max_jump),
    )


def _log_emissions(
    params: HMMParams, corpus: Corpus, concepts: torch.Tensor | None = None
) -> torch.Tensor:
    """[N, Ts, S]: log p(phone at t | state s), plain gather."""
    if concepts is None:
        concepts = hmm_core.state_concepts(corpus)
    return table_lookup(params.log_emit, corpus.src, concepts)


def _machinery(params: HMMParams, corpus: Corpus):
    log_trans = hmm_core.build_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return log_init, log_trans, _log_emissions(params, corpus)


def loglik(params: HMMParams, corpus: Corpus) -> torch.Tensor:
    log_init, log_trans, log_emit = _machinery(params, corpus)
    _, logz = hmm_core.forward(log_init, log_trans, log_emit, corpus.src_len)
    return logz.sum()


def estep_route(
    s: int, v_src: int, v_trg: int, use_kernels: bool, dot_dtype: str,
) -> str:
    """Which E-step runs: "fused" (K1 + K2), "general" (K1 + K4 + K7) or
    "plain" (hmm_core.estep and the plain count scatter, which ignore
    ``dot_dtype``).  The kernel routes run their E-step in ``dot_dtype``:
    "bfloat16" takes K2-bf16, or K4-bf16 followed by the float32 K7."""
    if not use_kernels:
        return "plain"
    if dot_dtype not in hmm_fwdbwd.DOT_DTYPES:
        raise ValueError(f"dot_dtype must be one of {hmm_fwdbwd.DOT_DTYPES}, got {dot_dtype!r}")
    if (
        s <= FUSED_MAX_STATES
        and v_src <= FUSED_MAX_SRC_VOCAB
        and v_trg <= FUSED_MAX_TRG_VOCAB
    ):
        return "fused"
    return "general"


def expected_counts(
    params: HMMParams,
    corpus: Corpus,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """E-step only: ((emission counts [V, V], jump-width counts [W+2]), loglik).

    Counts are additive across corpus shards.  ``use_kernels`` mirrors the
    reference's ``use_pallas``: inside the gate (S <= 64, V_src <= 128,
    V_trg <= 256) the step runs through K1 and K2, outside it through K1,
    K4 and K7 (K2's and K4's bf16 variants with ``dot_dtype="bfloat16"``).
    None means True on a CUDA corpus.
    """
    v_src, v_trg = params.log_emit.shape
    concepts = hmm_core.state_concepts(corpus)  # [N, S]
    route = estep_route(concepts.shape[1], v_src, v_trg,
                        kernels_for(use_kernels, corpus.device), dot_dtype)
    if route == "fused":
        return _expected_counts_fused(params, corpus, concepts, dot_dtype)
    if route == "general":
        log_emit = counts_ops.table_lookup(params.log_emit, corpus.src, concepts)
    else:
        log_emit = _log_emissions(params, corpus, concepts)
    gamma, width_counts, logz = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump, log_emit, corpus,
        use_kernels=route == "general", dot_dtype=dot_dtype,
    )
    count = counts_ops.pair_counts if route == "general" else pair_counts
    emit_counts = count(gamma, corpus.src, concepts, v_src, v_trg)
    return (emit_counts, width_counts), logz.sum()


def _expected_counts_fused(
    params: HMMParams, corpus: Corpus, concepts: torch.Tensor,
    dot_dtype: str = "float32",
) -> tuple[tuple[torch.Tensor, torch.Tensor], torch.Tensor]:
    """Kernel E-step: K1 lookup -> K2 fwd-bwd with fused counts.  gamma
    never exists in device memory; only the small [N, S] factored-transition
    terms are built around the kernels."""
    v_src, v_trg = params.log_emit.shape
    emit = counts_ops.table_lookup(params.log_emit, corpus.src, concepts)
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    emit_counts, xi_pooled, logz = hmm_fwdbwd.hmm_estep_counts(
        log_init, base, rowz, colmask, emit, corpus.src, concepts,
        corpus.src_len, v_src, v_trg, dot_dtype,
    )
    width_counts = hmm_core.project_widths(
        xi_pooled, corpus.max_trg_len, params.max_jump
    )
    return (emit_counts, width_counts), logz.sum()


def m_step(
    params: HMMParams,
    counts: tuple[torch.Tensor, torch.Tensor],
    smoothing: float = 1e-8,
) -> HMMParams:
    emit_counts, width_counts = counts
    emit_counts = emit_counts + smoothing
    new_log_emit = torch.log(emit_counts) - torch.log(
        emit_counts.sum(dim=0, keepdim=True)
    )
    W = 2 * params.max_jump + 1
    return HMMParams(
        log_emit=new_log_emit,
        log_jump=torch.log(width_counts[:W] + smoothing),
        log_p0=torch.log(width_counts[W] + smoothing),
        max_jump=params.max_jump,
    )


def em_step(
    params: HMMParams,
    corpus: Corpus,
    smoothing: float = 1e-8,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[HMMParams, dict[str, torch.Tensor]]:
    """One batched forward-backward EM iteration; on the fused route on the
    card, a CUDA graph's replay from a key's second call on (module
    docstring).  Every call returns tensors of its own."""
    with span("mwd.hmm.em_step"):
        key = _graph_key(params, corpus, smoothing, use_kernels, dot_dtype)
        if key is None:
            return _step(params, corpus, smoothing, use_kernels, dot_dtype)
        em_step.graph_calls += 1
        if key not in _GRAPHS:
            out = _step(params, corpus, smoothing, True, dot_dtype)
            _GRAPHS[key] = None
            if len(_GRAPHS) > MAX_GRAPHS:
                _, old = _GRAPHS.popitem(last=False)
                if old is not None:  # its pool is freed: let its last replay end first
                    torch.cuda.synchronize(old.corpus.device)
            return out
        _GRAPHS.move_to_end(key)
        graph = _GRAPHS[key]
        if graph is None:
            graph = _GRAPHS[key] = _IterationGraph(params, corpus, smoothing, dot_dtype)
            em_step.captures += 1
        em_step.replays += 1
        return graph.replay(params)


em_step.graph_calls = 0  # fused-route calls on the card
em_step.captures = 0
em_step.replays = 0


def _step(params, corpus, smoothing, use_kernels, dot_dtype):
    counts, ll = expected_counts(params, corpus, use_kernels, dot_dtype)
    return m_step(params, counts, smoothing), {"loglik": ll}


def _fields(params: HMMParams) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return params.log_emit, params.log_jump, params.log_p0


def _graph_key(params, corpus, smoothing, use_kernels, dot_dtype):
    """The key of the graph that serves this call, or None for a call that
    runs eagerly: off the card or off the fused route."""
    dev = corpus.device
    if dev.type != "cuda" or not kernels_for(use_kernels, dev):
        return None
    v_src, v_trg = params.log_emit.shape
    if estep_route(2 * corpus.max_trg_len, v_src, v_trg, True, dot_dtype) != "fused":
        return None
    data = (corpus.src, corpus.src_len, corpus.trg, corpus.trg_len)
    return (tuple((id(t), t.data_ptr(), t.shape, t.stride(), t.dtype) for t in data),
            tuple((t.shape, t.stride(), t.dtype, t.device) for t in _fields(params)),
            corpus.src_vocab, corpus.trg_vocab, params.max_jump, smoothing, dot_dtype)


# each launch counter the fused iteration's wrappers can advance
_LAUNCH_COUNTERS = ((counts_ops.table_lookup, "launches"),
                    (hmm_fwdbwd.hmm_estep_counts, "launches"),
                    (hmm_fwdbwd.hmm_estep_counts, "launches_bf16"))


class _IterationGraph:
    """One fused-route EM iteration captured as a CUDA graph on its own
    memory pool, over input buffers for the parameters.  It holds the corpus
    it was captured on, so the addresses it reads stay that corpus's, and
    what the capture added to each launch counter, which every replay adds
    again (a capture runs no kernel)."""

    def __init__(self, params, corpus, smoothing, dot_dtype):
        self.corpus = corpus
        self.max_jump = params.max_jump
        self.inputs = tuple(t.clone() for t in _fields(params))
        before = [getattr(w, a) for w, a in _LAUNCH_COUNTERS]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(corpus.device), torch.cuda.graph(
                    self.graph, capture_error_mode="thread_local"):
                new, stats = _step(HMMParams(*self.inputs, max_jump=self.max_jump), corpus,
                                   smoothing, True, dot_dtype)
                self.outputs = (*_fields(new), stats["loglik"])
        finally:
            added = [getattr(w, a) - b for (w, a), b in zip(_LAUNCH_COUNTERS, before)]
            for (w, a), b in zip(_LAUNCH_COUNTERS, before):
                setattr(w, a, b)
        self.launches = [(w, a, d) for (w, a), d in zip(_LAUNCH_COUNTERS, added) if d]

    def replay(self, params: HMMParams) -> tuple[HMMParams, dict[str, torch.Tensor]]:
        for buf, t in zip(self.inputs, _fields(params)):
            buf.copy_(t)
        self.graph.replay()
        for w, a, d in self.launches:
            setattr(w, a, getattr(w, a) + d)
        log_emit, log_jump, log_p0, ll = (t.clone() for t in self.outputs)
        return HMMParams(log_emit, log_jump, log_p0, self.max_jump), {"loglik": ll}


def train(
    params: HMMParams,
    corpus: Corpus,
    num_iterations: int,
    smoothing: float = 1e-8,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[HMMParams, torch.Tensor]:
    """``num_iterations`` EM steps -> (params, per-iteration logliks).

    The logliks stay on the device and are stacked once at the end, so the
    loop never waits on the device."""
    lls = []
    for _ in range(num_iterations):
        params, stats = em_step(
            params, corpus, smoothing=smoothing, use_kernels=use_kernels,
            dot_dtype=dot_dtype,
        )
        lls.append(stats["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)


def align(
    params: HMMParams, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """Viterbi decode -> [N, Ts] int32 alignment (0 = NULL, else 1-based
    trg position), through the factored-transition decoder (K3 with
    ``use_kernels=True``, the default on a CUDA corpus)."""
    with span("mwd.hmm.align"):
        base, rowz, colmask = hmm_core.factor_log_trans(
            params.log_jump, params.log_p0, corpus, params.max_jump
        )
        log_init = hmm_core.build_log_init(params.log_p0, corpus)
        path = hmm_core.viterbi_factored(
            log_init, base, rowz, colmask, _log_emissions(params, corpus),
            corpus.src_len, use_kernels=use_kernels,
        )
        return hmm_core.path_to_alignment(path, corpus)


def posteriors(
    params: HMMParams, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """State posteriors [N, Ts, S]: with ``use_kernels=True`` (None: on a
    CUDA corpus) K4's gamma (``hmm_core.estep``) on K1's emissions, else
    the plain forward-backward, as in the reference."""
    if kernels_for(use_kernels, corpus.device):
        emit = counts_ops.table_lookup(params.log_emit, corpus.src, hmm_core.state_concepts(corpus))
        return hmm_core.estep(params.log_jump, params.log_p0, params.max_jump, emit, corpus,
                              use_kernels=True)[0]
    log_init, log_trans, log_emit = _machinery(params, corpus)
    return hmm_core.posteriors_from(log_init, log_trans, log_emit, corpus)
