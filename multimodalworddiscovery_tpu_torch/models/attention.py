"""Attention-based neural aligner (seq2seq speech -> image concepts).

Counterpart of ``multimodalworddiscovery_tpu/models/attention.py``: a small
transformer encoder-decoder translates the source sequence (phones or
frames) into the image's concept sequence; the final decoder layer's
cross-attention weights, averaged over heads, are the alignment matrix.
Training is AdamW steps under the functional step API of the EM aligners
(``em_step`` = one gradient step; 'loglik' = -CE * tokens).

The networks are ``nn.Module``s laid out as the reference's flax modules
(``params_from_numpy`` maps a flax tree onto them): LayerNorm with epsilon
1e-6, the tanh approximation of gelu, masking with NEG_INF (a fully masked
decoder row gets uniform weights) and a stride-s conv front end of width
2s-1 with "SAME" padding.  The attention is the reference's own
einsum/softmax in plain torch: ``align`` needs the weights, which a fused
attention does not return.  The embeddings' gradients sum in a fixed order
and a step's convolution backward runs cuDNN's deterministic algorithms
(``core.determinism``), so one seed gives the same step bits in every run.

Optional guidance (``em_step(guide=...)``): cross-entropy between the
attention rows and a teacher alignment distribution, ``hmm_guide_matrix``
of a trained HMM's state posteriors.  On a CUDA corpus the teacher's
posteriors come from K4's gamma (``hmm_core.estep``; the discrete teacher's
emissions from K1), with ``use_kernels=False`` from the plain
forward-backward.
"""

from __future__ import annotations

import copy
import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
from multimodalworddiscovery_tpu_torch.core.determinism import (
    FixedOrderEmbedding,
    deterministic_convolutions,
)
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import flax_params, hmm_dnn

BOS = 0  # concept id 0 (NULL/pad) doubles as BOS for the shifted decoder input
LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
WEIGHT_DECAY = 1e-4  # optax.adamw(lr, weight_decay=1e-4)


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax nn.gelu's default


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=LN_EPS)


def same_pad(x: torch.Tensor, width: int, stride: int) -> torch.Tensor:
    """Pad [N, C, T] on T as XLA's "SAME" convolution does: the output has
    ceil(T / stride) positions, the total padding is max((out-1) * stride +
    width - T, 0) and its smaller half goes on the left."""
    t = x.shape[-1]
    out = -(-t // stride)
    total = max((out - 1) * stride + width - t, 0)
    return F.pad(x, (total // 2, total - total // 2))


class _Attention(nn.Module):
    """Multi-head attention that returns its weights [N, heads, Tq, Tk]."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.heads, self.head_dim = heads, dim // heads
        inner = heads * self.head_dim
        self.q, self.k, self.v = (nn.Linear(dim, inner) for _ in range(3))
        self.o = nn.Linear(inner, dim)

    def forward(self, q_in, kv_in, mask):
        n, tq, _ = q_in.shape
        tk = kv_in.shape[1]
        h, d = self.heads, self.head_dim
        q = self.q(q_in).view(n, tq, h, d)
        k = self.k(kv_in).view(n, tk, h, d)
        v = self.v(kv_in).view(n, tk, h, d)
        logits = torch.einsum("nqhd,nkhd->nhqk", q, k) / math.sqrt(d)
        logits = torch.where(mask[:, None, :, :], logits, NEG_INF)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("nhqk,nkhd->nqhd", weights, v).reshape(n, tq, h * d)
        return self.o(out), weights


class _Block(nn.Module):
    """Pre-norm transformer block: self-attention (its queries and keys
    from two LayerNorms), then a gelu MLP of width 4 * dim."""

    def __init__(self, dim: int, heads: int = 4):
        super().__init__()
        self.ln_q, self.ln_kv, self.ln_ff = (_layer_norm(dim) for _ in range(3))
        self.self_attn = _Attention(dim, heads)
        self.dense_0 = nn.Linear(dim, 4 * dim)
        self.dense_1 = nn.Linear(4 * dim, dim)

    def forward(self, x, mask):
        a, _ = self.self_attn(self.ln_q(x), self.ln_kv(x), mask)
        x = x + a
        return x + self.dense_1(_gelu(self.dense_0(self.ln_ff(x))))


class AttentionAligner(nn.Module):
    """Transformer encoder-decoder; returns (logits [N, Tt, V_trg],
    cross-attention weights averaged over heads [N, Tt, Ts'])."""

    def __init__(self, src_vocab: int, trg_vocab: int, ts: int, tt: int, dim: int = 128,
                 heads: int = 4, enc_layers: int = 2, feat_dim: int = 0, subsample: int = 1):
        super().__init__()
        self.dim, self.subsample = dim, subsample
        if src_vocab > 0:
            self.src_embed = FixedOrderEmbedding(src_vocab, dim)
        else:
            self.src_proj = nn.Linear(feat_dim, dim)
        if subsample > 1:
            self.subsample_conv = nn.Conv1d(dim, dim, 2 * subsample - 1, stride=subsample)
            ts = -(-ts // subsample)
        # positions sized by the padded lengths the model is built for
        self.src_pos = nn.Parameter(torch.zeros(1, ts, dim))
        self.enc = nn.ModuleList(_Block(dim, heads) for _ in range(enc_layers))
        self.enc_norm = _layer_norm(dim)
        self.trg_embed = FixedOrderEmbedding(trg_vocab, dim)
        self.trg_pos = nn.Parameter(torch.zeros(1, tt, dim))
        self.dec_self = _Block(dim, heads)
        self.ln_cross, self.ln_mlp, self.ln_out = (_layer_norm(dim) for _ in range(3))
        self.cross_attn = _Attention(dim, heads)
        self.dense_0 = nn.Linear(dim, 4 * dim)
        self.dense_1 = nn.Linear(4 * dim, dim)
        self.out = nn.Linear(dim, trg_vocab)

    def forward(self, src, src_mask, trg_in, trg_mask):
        n = src.shape[0]
        tt = trg_in.shape[1]
        # --- encoder ---
        x = self.src_embed(src.long()) if hasattr(self, "src_embed") else self.src_proj(src)
        if self.subsample > 1:
            s = self.subsample
            y = same_pad(_gelu(x).transpose(1, 2), 2 * s - 1, s)
            x = self.subsample_conv(y).transpose(1, 2)
            # a subsampled position is valid if ANY covered frame is valid
            ts = x.shape[1]
            m = F.pad(src_mask, (0, ts * s - src_mask.shape[1]))
            src_mask = m.reshape(n, ts, s).any(dim=-1)
        x = x + self.src_pos
        enc_mask = src_mask[:, None, :] & src_mask[:, :, None]
        for block in self.enc:
            x = block(x, enc_mask)
        enc = self.enc_norm(x)
        # --- decoder ---
        y = self.trg_embed(trg_in.long()) + self.trg_pos
        causal = torch.tril(torch.ones((tt, tt), dtype=torch.bool, device=y.device))
        y = self.dec_self(y, causal[None] & trg_mask[:, None, :])
        cross_mask = trg_mask[:, :, None] & src_mask[:, None, :]
        c, attn = self.cross_attn(self.ln_cross(y), enc, cross_mask)
        y = y + c
        y = y + self.dense_1(_gelu(self.dense_0(self.ln_mlp(y))))
        return self.out(self.ln_out(y)), attn.mean(dim=1)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's initialisation (``flax_params.flax_init``), drawn on the
        CPU from ``generator``; the position tables normal with std 0.02."""
        flax_params.flax_init(self, generator)
        with torch.no_grad():
            for pos in (self.src_pos, self.trg_pos):
                pos.copy_(torch.randn(pos.shape, generator=generator) * 0.02)


@dataclasses.dataclass(frozen=True)
class AttentionParams:
    """The model, its AdamW state and step count, and the static fields.

    entropy_weight: a penalty on the entropy of column-normalized
    cross-attention (0 = plain CE, the reference's objective; measured by
    the reference to hurt alignment accuracy, so off by default)."""

    model: AttentionAligner
    opt_state: hmm_dnn.AdamState
    step: int = 0
    dim: int = 128
    learning_rate: float = 3e-4
    entropy_weight: float = 0.0
    subsample: int = 1


def _inputs(corpus: Corpus):
    trg_in = F.pad(corpus.trg[:, :-1], (1, 0), value=BOS)
    return corpus.src, corpus.src_mask(), trg_in, corpus.trg_mask()


def init(
    corpus: Corpus,
    dim: int = 128,
    learning_rate: float = 3e-4,
    entropy_weight: float = 0.0,
    subsample: int = 1,
    generator: torch.Generator | None = None,
) -> AttentionParams:
    """Initial model on the corpus's device, its weights from ``generator``
    (a CPU generator seeded 0 when None); positions sized by the corpus's
    padded lengths."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    discrete = corpus.src.ndim == 2
    model = AttentionAligner(
        src_vocab=corpus.src_vocab if discrete else 0, trg_vocab=corpus.trg_vocab,
        ts=corpus.max_src_len, tt=corpus.max_trg_len, dim=dim,
        feat_dim=0 if discrete else corpus.src.shape[-1], subsample=subsample,
    )
    model.reset_parameters(generator)
    model = model.to(corpus.device)
    return AttentionParams(model=model, opt_state=hmm_dnn.adam_init(model.parameters()),
                           dim=dim, learning_rate=learning_rate,
                           entropy_weight=entropy_weight, subsample=subsample)


# flax names of the torch submodules that flax named automatically
_FLAX_NAMES = dict(ln_q="LayerNorm_0", ln_kv="LayerNorm_1", ln_ff="LayerNorm_2",
                   ln_cross="LayerNorm_0", ln_mlp="LayerNorm_1", ln_out="LayerNorm_2",
                   dense_0="Dense_0", dense_1="Dense_1")


def params_from_numpy(
    params: dict,
    adam: dict | None = None,
    step: int = 0,
    learning_rate: float = 3e-4,
    entropy_weight: float = 0.0,
    device="cuda",
) -> AttentionParams:
    """Carry a flax parameter tree (numpy arrays, optionally under
    "params") onto a new model on ``device``; the model's sizes come from
    the tree's shapes.  ``adam`` is the AdamW state {"count", "mu", "nu"}
    with mu and nu trees of the same layout (fresh when None)."""
    t = params.get("params", params)
    discrete = "src_embed" in t
    first = np.asarray(t["src_embed"]["embedding"] if discrete else t["src_proj"]["kernel"])
    dim = first.shape[1]
    subsample = (np.asarray(t["subsample_conv"]["kernel"]).shape[0] + 1) // 2 \
        if "subsample_conv" in t else 1
    ts = np.asarray(t["src_pos"]).shape[1] * subsample
    model = AttentionAligner(
        src_vocab=first.shape[0] if discrete else 0,
        trg_vocab=np.asarray(t["trg_embed"]["embedding"]).shape[0], ts=ts,
        tt=np.asarray(t["trg_pos"]).shape[1], dim=dim,
        heads=np.asarray(t["cross_attn"]["q"]["kernel"]).shape[1],
        enc_layers=sum(k.startswith("enc_") and k != "enc_norm" for k in t),
        feat_dim=0 if discrete else first.shape[0], subsample=subsample,
    ).to(device)
    flax_params.copy_into(model, flax_params.load_flax_tree(model, t, _FLAX_NAMES, device))
    if adam is None:
        opt = hmm_dnn.adam_init(model.parameters())
    else:
        opt = hmm_dnn.AdamState(
            count=int(np.asarray(adam["count"])),
            mu=tuple(flax_params.load_flax_tree(model, adam["mu"], _FLAX_NAMES, device)),
            nu=tuple(flax_params.load_flax_tree(model, adam["nu"], _FLAX_NAMES, device)))
    return AttentionParams(model=model, opt_state=opt, step=int(step), dim=dim,
                           learning_rate=float(learning_rate),
                           entropy_weight=float(entropy_weight), subsample=subsample)


def _subsampled_mask(src_mask: torch.Tensor, ts_sub: int) -> torch.Tensor:
    """Frame mask -> subsampled-position mask (any covered frame valid), in
    the reference's layout."""
    n, ts = src_mask.shape
    ss = -(-ts // ts_sub)
    m = F.pad(src_mask, (0, ts_sub * ss - ts))
    return m.reshape(n, ts_sub, ss).any(dim=-1)


def _loss_fn(model, src, src_mask, trg_in, trg_mask, trg, entropy_weight=0.0,
             guide=None, guide_weight: float = 1.0, norms=None):
    """The batch's mean loss; with ``norms`` = (target tokens, source
    positions) of a larger batch, this batch's share of that batch's loss
    (a data-parallel rank's part of the global batch)."""
    logits, attn = model(src, src_mask, trg_in, trg_mask)
    logp = torch.log_softmax(logits, dim=-1)
    # gather's backward adds each element once into zeros: exact in any order
    nll = -torch.gather(logp, 2, trg.long()[..., None])[..., 0]
    nll = torch.where(trg_mask, nll, 0.0)
    ntok = torch.clamp(trg_mask.sum() if norms is None else norms[0], min=1)
    loss = nll.sum() / ntok
    if guide is not None:
        # guided attention: cross-entropy between the decoder's attention
        # rows and a teacher alignment distribution at the attention's
        # resolution (em_step pools it when the encoder subsamples)
        sm = (src_mask if attn.shape[-1] == src_mask.shape[-1]
              else _subsampled_mask(src_mask, attn.shape[-1]))
        valid = trg_mask[:, :, None] & sm[:, None, :]
        ce = -torch.where(valid, guide * torch.log(attn + 1e-9), 0.0)
        loss = loss + guide_weight * ce.sum() / ntok
    if entropy_weight:
        # column-normalized attention over valid decoder rows; entropy per
        # valid source position
        attn = torch.where(trg_mask[:, :, None], attn, 0.0)
        col = attn / torch.clamp(attn.sum(dim=1, keepdim=True), min=1e-9)
        ent = -torch.sum(col * torch.log(col + 1e-9), dim=1)
        ent = torch.where(src_mask, ent, 0.0)
        nsrc = src_mask.sum() if norms is None else norms[1]
        loss = loss + entropy_weight * ent.sum() / torch.clamp(nsrc, min=1)
    return loss


def pool_guide(guide: torch.Tensor, subsample: int) -> torch.Tensor:
    """A frame-resolution guide [N, Tt, Ts] -> the subsampled positions:
    mass summed over each stride and the rows renormalized."""
    n, tt, ts = guide.shape
    ts_sub = -(-ts // subsample)
    g = F.pad(guide, (0, ts_sub * subsample - ts))
    g = g.reshape(n, tt, ts_sub, subsample).sum(dim=-1)
    return g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-9)


def em_step(
    state: AttentionParams,
    corpus: Corpus,
    guide: torch.Tensor | None = None,
    guide_weight: float = 1.0,
    mesh=None,
) -> tuple[AttentionParams, dict]:
    """One AdamW step on the corpus or a gathered minibatch
    (models/minibatch.py) -> (new state, {"loglik", "loss"} on the device).
    The input state is left untouched.

    guide: optional [N, Tt, Ts] frame-resolution teacher attention (see
    ``hmm_guide_matrix``), pooled onto the subsampled positions when the
    encoder subsamples.

    With ``mesh`` the corpus is this rank's part of a global batch and the
    state is identical on every rank: the loss's normalisers are the global
    batch's token and position counts (one all_reduce), the gradients
    (in ``hmm_dnn.adam_update``) and the loss are summed over the ranks,
    so every rank takes the step the global batch gives and reports its
    statistics.
    """
    if guide is not None and state.subsample != 1:
        guide = pool_guide(guide, state.subsample)
    group = group_of(mesh)
    model = copy.deepcopy(state.model)
    src, src_mask, trg_in, trg_mask = _inputs(corpus)
    ntok = trg_mask.sum()
    norms = None
    if group is not None:
        norms = all_sum(torch.stack([ntok, src_mask.sum()]), group)
        ntok = norms[0]
    weights = list(model.parameters())
    with deterministic_convolutions():
        loss = _loss_fn(model, src, src_mask, trg_in, trg_mask, corpus.trg,
                        state.entropy_weight, guide, guide_weight, norms)
        grads = torch.autograd.grad(loss, weights)
    updates, opt = hmm_dnn.adam_update(grads, state.opt_state, state.learning_rate,
                                       WEIGHT_DECAY, weights, group)
    hmm_dnn.apply_updates(model, updates)
    loss = all_sum(loss.detach(), group)
    new = dataclasses.replace(state, model=model, opt_state=opt, step=state.step + 1)
    return new, {"loglik": -loss * ntok, "loss": loss}


def loglik(state: AttentionParams, corpus: Corpus) -> torch.Tensor:
    src, src_mask, trg_in, trg_mask = _inputs(corpus)
    with torch.no_grad():
        loss = _loss_fn(state.model, src, src_mask, trg_in, trg_mask, corpus.trg)
    return -loss * trg_mask.sum()


def attention_matrix(state: AttentionParams, corpus: Corpus) -> torch.Tensor:
    """[N, Tt, Ts] teacher-forced cross-attention weights, upsampled
    (nearest) to frame resolution when the encoder subsamples."""
    with torch.no_grad():
        _, attn = state.model(*_inputs(corpus))
    if state.subsample > 1:
        attn = attn.repeat_interleave(state.subsample, dim=2)[:, :, : corpus.max_src_len]
    return attn


def align(
    state: AttentionParams, corpus: Corpus, null_threshold: float = 0.0
) -> torch.Tensor:
    """Alignment from the attention argmax per source position -> [N, Ts]
    int32: a_i = argmax_j attn[j, i] + 1 (the first maximum), NULL where the
    winning weight (renormalized over valid decoder steps) is below
    ``null_threshold``."""
    attn = attention_matrix(state, corpus)
    attn = torch.where(corpus.trg_mask()[:, :, None], attn, 0.0)
    col = attn / torch.clamp(attn.sum(dim=1, keepdim=True), min=1e-9)
    best = torch.argmax(col, dim=1).to(torch.int32)
    a = torch.where(torch.amax(col, dim=1) >= null_threshold, best + 1, 0)
    return torch.where(corpus.src_mask(), a, 0).to(torch.int32)


def train(
    state: AttentionParams,
    corpus: Corpus,
    num_iterations: int,
    guide: torch.Tensor | None = None,
    guide_weight: float = 1.0,
) -> tuple[AttentionParams, torch.Tensor]:
    """``num_iterations`` full-batch steps -> (state, per-step logliks,
    stacked on the device once at the end)."""
    lls = []
    for _ in range(num_iterations):
        state, stats = em_step(state, corpus, guide, guide_weight)
        lls.append(stats["loglik"])
    if not lls:
        return state, torch.empty(0, device=corpus.device)
    return state, torch.stack(lls)


def hmm_guide_matrix(
    hmm_params, corpus: Corpus, posteriors_fn=None, use_kernels: bool | None = None
) -> torch.Tensor:
    """Teacher attention [N, Tt, Ts] from a trained HMM's state posteriors:
    gamma [N, Ts, S] on the real states (positions 0..Tt-1; NULL mass
    dropped), rows renormalized over the source.

    posteriors_fn: any HMM-family ``posteriors(params, corpus,
    use_kernels)`` (default the discrete HMM's; ``hmm_gaussian.posteriors``
    for frames).  ``use_kernels`` (None: on a CUDA corpus) takes gamma from
    K4, else from the plain forward-backward.
    """
    if posteriors_fn is None:
        from multimodalworddiscovery_tpu_torch.models import hmm

        posteriors_fn = hmm.posteriors
    gamma = posteriors_fn(hmm_params, corpus, use_kernels=use_kernels)  # [N, Ts, S]
    guide = gamma[..., : corpus.max_trg_len].transpose(1, 2)  # [N, Tt, Ts]
    guide = guide / torch.clamp(guide.sum(dim=2, keepdim=True), min=1e-9)
    valid = corpus.trg_mask()[:, :, None] & corpus.src_mask()[:, None, :]
    return torch.where(valid, guide, 0.0)
