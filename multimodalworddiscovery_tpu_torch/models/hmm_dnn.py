"""DNN-HMM hybrid aligner: emissions from a frame-level MLP.

Counterpart of ``multimodalworddiscovery_tpu/models/hmm_dnn.py``, its
resident trainer and its streamed one (``train_streaming`` over
``data/stream`` shards).  The Vogel HMM skeleton of the other aligners,
with emissions from an MLP that predicts concept posteriors, turned into
scaled likelihoods
log p(x|c) ~ log p(c|x) - log p(c).

Training is generalized EM:
  E-step  forward-backward (K4 on the kernel route) -> frame-level concept
          posteriors r
  M-step  (a) ``n_sgd`` Adam steps on CE(r, MLP(x)),
          (b) concept priors re-estimated from r,
          (c) jump-width transition counts as in the other HMMs.

The MLP is an ``nn.Module`` initialised as flax initialises ``nn.Dense``
(lecun normal: a normal truncated at +-2 sigma, sigma = 1/sqrt(fan_in) /
0.87962566, biases 0), drawn from a CPU ``torch.Generator`` so one seed
gives the same weights on every machine.  Adam is optax's (b1 0.9, b2
0.999, eps 1e-8 added to sqrt(nu_hat), bias-corrected), written out in
``adam_init`` / ``adam_update`` so its state can be carried across from the
reference.  The entry points are functional, as in the reference: a step
returns new parameters (with a new MLP) and leaves its input untouched.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
from torch import nn

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
from multimodalworddiscovery_tpu_torch.core.counts import pool_columns, select_columns
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import hmm_core

# flax's lecun_normal: the std of a unit normal truncated at +-2
TRUNC_STD = 0.87962566103423978
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class EmissionMLP(nn.Module):
    """[..., D] frames -> [..., C] concept logits: Dense(hidden), relu,
    Dense(hidden), relu, Dense(C)."""

    def __init__(self, in_dim: int, n_concepts: int, hidden: int = 256):
        super().__init__()
        self.dense = nn.ModuleList([
            nn.Linear(in_dim, hidden), nn.Linear(hidden, hidden),
            nn.Linear(hidden, n_concepts),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense[0](x))
        h = torch.relu(self.dense[1](h))
        return self.dense[2](h)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's nn.Dense initialisation, drawn on the CPU from
        ``generator`` (Dense_0, Dense_1, Dense_2 in order)."""
        with torch.no_grad():
            for layer in self.dense:
                std = 1.0 / math.sqrt(layer.in_features) / TRUNC_STD
                layer.weight.copy_(truncated_normal(layer.weight.shape, generator) * std)
                layer.bias.zero_()


def truncated_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Unit normals truncated at +-2, on the CPU: ``torch.randn`` draws with
    the draws outside the interval drawn again.  (``nn.init.trunc_normal_``
    is not used: its algorithm, and so its numbers for one seed, changed
    between torch releases.)"""
    out = torch.randn(shape, generator=generator, dtype=torch.float32)
    bad = out.abs() > 2.0
    while bool(bad.any()):
        out[bad] = torch.randn(int(bad.sum()), generator=generator, dtype=torch.float32)
        bad = out.abs() > 2.0
    return out


@dataclasses.dataclass(frozen=True)
class AdamState:
    """optax.scale_by_adam's state: the step count and the two moments,
    one tensor per parameter (in the order of the parameters updated)."""

    count: int
    mu: tuple[torch.Tensor, ...]
    nu: tuple[torch.Tensor, ...]


def adam_init(tensors) -> AdamState:
    zeros = tuple(torch.zeros_like(t, dtype=torch.float32) for t in tensors)
    return AdamState(count=0, mu=zeros, nu=tuple(torch.zeros_like(z) for z in zeros))


def adam_update(
    grads, state: AdamState, lr: float, weight_decay: float = 0.0, params=None, group=None,
) -> tuple[list[torch.Tensor], AdamState]:
    """optax.adam(lr)'s update: (updates to add to the parameters, state).
    With ``weight_decay`` it is optax.adamw(lr, weight_decay=...)'s: the
    decay times ``params`` (every parameter, biases and norm scales too)
    is added to the Adam direction before the learning rate scales it.

    ``group`` (a data-parallel step's process group) sums ``grads`` over
    its ranks first (one all_reduce), so every rank takes the step of the
    global batch; the caller scales each rank's gradient by the global
    normaliser.  This is the one place a gradient step all-reduces its
    gradients."""
    grads = all_sum(list(grads), group)
    count = state.count + 1
    mu = tuple((1 - ADAM_B1) * g + ADAM_B1 * m for g, m in zip(grads, state.mu))
    nu = tuple((1 - ADAM_B2) * g * g + ADAM_B2 * v for g, v in zip(grads, state.nu))
    # the bias corrections once a step, in float32 as optax rounds them,
    # then as Python floats (exact), so no tensor is sent to the device
    bc1 = float(1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** count)
    bc2 = float(1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** count)
    direction = [(m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS) for m, v in zip(mu, nu)]
    if weight_decay:
        direction = [u + weight_decay * p.detach() for u, p in zip(direction, params)]
    return [-lr * u for u in direction], AdamState(count=count, mu=mu, nu=nu)


@dataclasses.dataclass(frozen=True)
class DnnHMMParams:
    """The emission MLP, the Adam state ({"mlp": AdamState} and, for the
    fully end-to-end CRF, "trans" over (log_jump, log_p0)), concept
    log-priors [C], log jump weights [2*max_jump+1], scalar log null weight,
    and the static fields."""

    mlp: EmissionMLP
    opt_state: dict
    log_prior: torch.Tensor
    log_jump: torch.Tensor
    log_p0: torch.Tensor
    max_jump: int = 3
    hidden: int = 256
    learning_rate: float = 1e-3
    n_sgd: int = 4


def _require_frames(corpus: Corpus) -> None:
    if corpus.src.ndim != 3:
        raise ValueError(
            "the DNN-HMM's emission MLP reads continuous frames (src must be "
            f"[N, Ts, D], got {tuple(corpus.src.shape)})"
        )


def init(
    corpus: Corpus,
    max_jump: int = 3,
    hidden: int = 256,
    learning_rate: float = 1e-3,
    n_sgd: int = 4,
    generator: torch.Generator | None = None,
) -> DnnHMMParams:
    """Initial parameters on the corpus's device; the MLP's weights come
    from ``generator`` (a CPU generator seeded 0 when None)."""
    _require_frames(corpus)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    mlp = EmissionMLP(corpus.src.shape[-1], corpus.trg_vocab, hidden)
    mlp.reset_parameters(generator)
    mlp = mlp.to(corpus.device)
    f32 = dict(dtype=torch.float32, device=corpus.device)
    c = corpus.trg_vocab
    w = 2 * max_jump + 1
    return DnnHMMParams(
        mlp=mlp,
        opt_state={"mlp": adam_init(mlp.parameters())},
        log_prior=torch.full((c,), -math.log(c), **f32),
        log_jump=-0.5 * torch.abs(torch.arange(w, **f32) - max_jump - 1),
        log_p0=torch.log(torch.tensor(0.2, **f32)),
        max_jump=max_jump, hidden=hidden, learning_rate=learning_rate, n_sgd=n_sgd,
    )


def _dense_names(mlp: EmissionMLP) -> list[str]:
    return [f"Dense_{i}" for i in range(len(mlp.dense))]


def params_from_numpy(
    mlp: dict,
    log_prior,
    log_jump,
    log_p0,
    max_jump: int = 3,
    hidden: int = 256,
    learning_rate: float = 1e-3,
    n_sgd: int = 4,
    adam: dict | None = None,
    adam_trans: dict | None = None,
    device="cuda",
) -> DnnHMMParams:
    """Carry parameters across from host arrays in the reference's layout
    onto ``device``.

    ``mlp`` is flax's tree {"Dense_i": {"kernel": [in, out], "bias":
    [out]}} (optionally under "params"); each kernel becomes the transposed
    torch ``weight`` [out, in].  ``adam`` is the MLP's Adam state
    {"count", "mu", "nu"} with mu and nu trees of the same layout (fresh
    when None); ``adam_trans`` that of (log_jump, log_p0) for the fully
    end-to-end CRF, with mu and nu pairs."""
    tree = mlp.get("params", mlp)

    def f32(x):
        return torch.as_tensor(np.array(x, dtype=np.float32), device=device)

    names = sorted(tree)
    d_in = np.asarray(tree[names[0]]["kernel"]).shape[0]
    n_concepts = np.asarray(tree[names[-1]]["kernel"]).shape[1]
    module = EmissionMLP(d_in, n_concepts, hidden).to(device)

    def flat(t):  # a flax-layout tree -> tensors in torch parameter order
        t = t.get("params", t)
        out = []
        for name in _dense_names(module):
            out += [np.asarray(t[name]["kernel"]).T, np.asarray(t[name]["bias"])]
        return out

    with torch.no_grad():
        for p, x in zip(module.parameters(), flat(tree)):
            p.copy_(f32(x))
    opt = {"mlp": adam_init(module.parameters()) if adam is None else AdamState(
        count=int(np.asarray(adam["count"])),
        mu=tuple(f32(x) for x in flat(adam["mu"])),
        nu=tuple(f32(x) for x in flat(adam["nu"])))}
    lj, lp0 = f32(log_jump), f32(log_p0).reshape(())
    if adam_trans is not None:
        opt["trans"] = AdamState(
            count=int(np.asarray(adam_trans["count"])),
            mu=(f32(adam_trans["mu"][0]), f32(adam_trans["mu"][1]).reshape(())),
            nu=(f32(adam_trans["nu"][0]), f32(adam_trans["nu"][1]).reshape(())))
    return DnnHMMParams(
        mlp=module, opt_state=opt, log_prior=f32(log_prior), log_jump=lj, log_p0=lp0,
        max_jump=int(max_jump), hidden=int(hidden), learning_rate=float(learning_rate),
        n_sgd=int(n_sgd),
    )


def _concept_loglik(params: DnnHMMParams, corpus: Corpus) -> torch.Tensor:
    """[N, Ts, C] scaled log-likelihoods log p(c|x) - log p(c)."""
    _require_frames(corpus)
    with torch.no_grad():
        logpost = torch.log_softmax(params.mlp(corpus.src), dim=-1)
    return logpost - params.log_prior[None, None, :]


def _log_emissions(params: DnnHMMParams, corpus: Corpus) -> torch.Tensor:
    """[N, Ts, S]: each state's column of the scaled log-likelihoods."""
    return select_columns(_concept_loglik(params, corpus), hmm_core.state_concepts(corpus))


def _machinery(params: DnnHMMParams, corpus: Corpus):
    log_trans = hmm_core.build_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    return log_init, log_trans, _log_emissions(params, corpus)


def loglik(params: DnnHMMParams, corpus: Corpus) -> torch.Tensor:
    log_init, log_trans, log_emit = _machinery(params, corpus)
    _, logz = hmm_core.forward(log_init, log_trans, log_emit, corpus.src_len)
    return logz.sum()


def frame_posteriors(
    params: DnnHMMParams,
    corpus: Corpus,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """E-step core: (frame concept posteriors r [N, Ts, C], width counts,
    logz [N]).  r is the CE target of the neural M-step.  The E-step runs
    through K4 with ``use_kernels=True`` (None: on a CUDA corpus)."""
    concepts = hmm_core.state_concepts(corpus)
    log_emit = select_columns(_concept_loglik(params, corpus), concepts)
    gamma, width_counts, logz = hmm_core.estep(
        params.log_jump, params.log_p0, params.max_jump, log_emit, corpus,
        use_kernels=use_kernels, dot_dtype=dot_dtype,
    )
    # r[n, t, c] = sum over the states s of concept c of gamma[n, t, s]
    return pool_columns(gamma, concepts, corpus.trg_vocab), width_counts, logz


def _frame_weights(corpus: Corpus) -> torch.Tensor:
    return corpus.src_mask().to(torch.float32)[..., None]


def expected_counts(
    params: DnnHMMParams,
    corpus: Corpus,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Additive E-step counts: concept-prior counts [C] and jump-width
    counts; and the loglik.  The neural part of the M-step is not
    summarized by additive counts (``neural_m_step`` takes (corpus, r)
    pairs instead)."""
    r, width_counts, logz = frame_posteriors(params, corpus, use_kernels, dot_dtype)
    return {"prior": (r * _frame_weights(corpus)).sum(dim=(0, 1)),
            "width": width_counts}, logz.sum()


def m_step(
    params: DnnHMMParams, counts: dict[str, torch.Tensor], smoothing: float = 1e-6
) -> DnnHMMParams:
    """Closed-form part of the generalized M-step (priors + transitions);
    the MLP is updated separately by ``neural_m_step``."""
    prior_counts = counts["prior"] + smoothing
    width_counts = counts["width"]
    w = 2 * params.max_jump + 1
    return dataclasses.replace(
        params,
        log_prior=torch.log(prior_counts) - torch.log(prior_counts.sum()),
        log_jump=torch.log(width_counts[:w] + smoothing),
        log_p0=torch.log(width_counts[w] + smoothing),
    )


def _ce_num(mlp: EmissionMLP, src: torch.Tensor, r: torch.Tensor, w: torch.Tensor):
    """Unnormalized CE sum (additive across batches and shards)."""
    logq = torch.log_softmax(mlp(src), dim=-1)
    return -(r * logq * w).sum()


def apply_updates(mlp: EmissionMLP, updates) -> None:
    """Add Adam's updates to the MLP's weights in place (optax.apply_updates)."""
    with torch.no_grad():
        for p, u in zip(mlp.parameters(), updates):
            p.add_(u)


def neural_m_step(
    params: DnnHMMParams, batches: list[tuple[Corpus, torch.Tensor]], mesh=None
) -> tuple[DnnHMMParams, torch.Tensor]:
    """``n_sgd`` Adam steps of CE(r, MLP(x)) pooled over ``batches`` of
    (corpus, r): gradients of the unnormalized CE are summed over the
    batches and scaled by the total frame weight, so with one batch this is
    the single-corpus neural M-step.  With ``mesh`` the batches are this
    rank's: the frame weight, each step's gradients (in ``adam_update``)
    and the last step's CE are summed over the ranks too."""
    group = group_of(mesh)
    ws = [_frame_weights(c) for c, _ in batches]
    total_w = torch.clamp(all_sum(sum(w.sum() for w in ws), group), min=1.0)
    mlp, state = copy.deepcopy(params.mlp), params.opt_state["mlp"]
    num = torch.zeros((), device=total_w.device)
    for _ in range(params.n_sgd):
        num, grads = 0.0, None
        for (c, r), w in zip(batches, ws):
            n_b = _ce_num(mlp, c.src, r, w)
            g_b = torch.autograd.grad(n_b, list(mlp.parameters()))
            num = num + n_b.detach()
            grads = g_b if grads is None else [a + b for a, b in zip(grads, g_b)]
        updates, state = adam_update([g / total_w for g in grads], state,
                                     params.learning_rate, group=group)
        apply_updates(mlp, updates)
    opt = dict(params.opt_state, mlp=state)
    return dataclasses.replace(params, mlp=mlp, opt_state=opt), all_sum(num, group) / total_w


def em_step(
    params: DnnHMMParams,
    corpus: Corpus,
    smoothing: float = 1e-6,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
    mesh=None,
) -> tuple[DnnHMMParams, dict[str, torch.Tensor]]:
    """One generalized-EM iteration: E-step, the closed-form M-step, then
    ``n_sgd`` Adam steps of the CE on the full corpus.  With ``mesh`` the
    corpus is this rank's rows: the counts and loglik are summed over the
    ranks (one all_reduce) and the neural M-step all-reduces its
    gradients."""
    r, width_counts, logz = frame_posteriors(params, corpus, use_kernels, dot_dtype)
    w = _frame_weights(corpus)
    counts, ll = all_sum(({"prior": (r * w).sum(dim=(0, 1)), "width": width_counts},
                          logz.sum()), group_of(mesh))
    params = m_step(params, counts, smoothing)
    params, ce = neural_m_step(params, [(corpus, r)], mesh)
    return params, {"loglik": ll, "ce": ce}


def align(
    params: DnnHMMParams, corpus: Corpus, use_kernels: bool | None = None
) -> torch.Tensor:
    """Viterbi decode -> [N, Ts] int32 alignment (0 = NULL, else 1-based
    trg position), through K3 with ``use_kernels=True`` (None: on a CUDA
    corpus)."""
    base, rowz, colmask = hmm_core.factor_log_trans(
        params.log_jump, params.log_p0, corpus, params.max_jump
    )
    log_init = hmm_core.build_log_init(params.log_p0, corpus)
    path = hmm_core.viterbi_factored(
        log_init, base, rowz, colmask, _log_emissions(params, corpus), corpus.src_len,
        use_kernels=use_kernels,
    )
    return hmm_core.path_to_alignment(path, corpus)


def posteriors(params: DnnHMMParams, corpus: Corpus) -> torch.Tensor:
    """State posteriors [N, Ts, S] (plain fwd-bwd, as in the reference)."""
    log_init, log_trans, log_emit = _machinery(params, corpus)
    return hmm_core.posteriors_from(log_init, log_trans, log_emit, corpus)


def train(
    params: DnnHMMParams,
    corpus: Corpus,
    num_iterations: int,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[DnnHMMParams, torch.Tensor]:
    """``num_iterations`` generalized-EM steps -> (params, per-iteration
    logliks, stacked on the device once at the end)."""
    lls = []
    for _ in range(num_iterations):
        params, stats = em_step(params, corpus, use_kernels=use_kernels,
                                dot_dtype=dot_dtype)
        lls.append(stats["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)


def streamed_shard_step(
    params: DnnHMMParams,
    corpus: Corpus,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
) -> tuple[DnnHMMParams, dict[str, torch.Tensor], torch.Tensor]:
    """One shard's part of an out-of-core generalized-EM iteration ->
    (params with the MLP stepped and the new Adam state, additive counts,
    loglik on the device).

    The closed-form statistics (concept-prior and jump-width counts, the
    loglik) pool exactly across shards; the neural M-step does not (its CE
    targets are the whole corpus's posteriors), so each shard takes
    ``n_sgd`` Adam steps on its own CE(r, MLP(x)): incremental generalized
    EM at shard granularity, whose convergence, not its numbers, matches
    the resident trainer.  The steps update ``params.mlp`` IN PLACE (no
    copy a shard: ``train_streaming`` copies the module once a call), so
    the weights and the Adam state chain from shard to shard.
    """
    r, width_counts, logz = frame_posteriors(params, corpus, use_kernels, dot_dtype)
    w = _frame_weights(corpus)
    counts = {"prior": (r * w).sum(dim=(0, 1)), "width": width_counts}
    total_w = torch.clamp(w.sum(), min=1.0)
    mlp, state = params.mlp, params.opt_state["mlp"]
    for _ in range(params.n_sgd):
        grads = torch.autograd.grad(_ce_num(mlp, corpus.src, r, w), list(mlp.parameters()))
        updates, state = adam_update([g / total_w for g in grads], state, params.learning_rate)
        apply_updates(mlp, updates)
    opt = dict(params.opt_state, mlp=state)
    return dataclasses.replace(params, opt_state=opt), counts, logz.sum()


def train_streaming(
    params: DnnHMMParams,
    reader,
    num_iterations: int,
    smoothing: float = 1e-6,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
    prefetch: int = 1,
    on_iteration=None,
) -> tuple[DnnHMMParams, list[float]]:
    """Out-of-core generalized EM for the DNN-HMM over a
    ``data.stream.ShardedCorpusReader`` corpus: per-shard incremental
    neural updates (``streamed_shard_step``, chained through the MLP and
    Adam state), exact pooled counts, one prior and transition M-step an
    iteration.  The MLP is copied once, so the caller's parameters stay as
    they were; the loglik is read once an iteration.  Returns (params,
    [loglik per iteration])."""
    params = dataclasses.replace(params, mlp=copy.deepcopy(params.mlp))
    lls: list[float] = []
    for it in range(num_iterations):
        total, ll = None, None
        for shard in reader.shards(prefetch):
            params, counts, ll_k = streamed_shard_step(params, shard, use_kernels, dot_dtype)
            total = counts if total is None else {k: total[k] + v for k, v in counts.items()}
            ll = ll_k if ll is None else ll + ll_k
        params = m_step(params, total, smoothing)
        lls.append(float(ll))
        if on_iteration is not None:
            on_iteration(it, params, lls[-1])
    return params, lls
