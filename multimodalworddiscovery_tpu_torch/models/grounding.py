"""Audio-visual grounding baseline (Harwath & Glass style).

Counterpart of ``multimodalworddiscovery_tpu/models/grounding.py``: speech
and image regions are embedded into a shared space and trained with a
max-margin ranking loss over matched vs mismatched pairs; alignments are
read off the frame-region similarity matrix.  The speech encoder is a small
1-D conv stack, the region encoder an embedding (or an MLP over region
features); one training step scores every pair of the batch at once
(the in-batch contrastive setup).  Training uses Adam (optax.adam, no
decay).  The networks are ``nn.Module``s laid out as the reference's flax
modules, so ``params_from_numpy`` maps a flax tree onto them.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multimodalworddiscovery_tpu_torch.core.collectives import gather_rows, group_of
from multimodalworddiscovery_tpu_torch.core.masking import lengths_to_mask
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import flax_params, hmm_dnn

# Rows of the candidate axis one pooled-retrieval chunk scores at a time,
# sized by the [rows, C, Ts, Tt] similarity block's bytes.
POOL_CHUNK_BYTES = 1 << 28


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    """x * rsqrt(sum x^2 + 1e-12): finite in value and gradient at a zero
    row (``x / max(||x||, eps)`` has a NaN gradient there, and zero-padded
    region slots are routine)."""
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def _conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Width-5, stride-1 "SAME" convolution over [N, T, D]."""
    return conv(F.pad(x.transpose(1, 2), (2, 2))).transpose(1, 2)


class SpeechEncoder(nn.Module):
    """Embedding (ids) or Dense (frames), two relu convs of width 5, Dense,
    L2-normalized -> [N, Ts, dim]."""

    def __init__(self, dim: int = 128, vocab: int = 0, feat_dim: int = 0):
        super().__init__()
        if vocab > 0:
            self.embed = nn.Embedding(vocab, dim)
        else:
            self.proj = nn.Linear(feat_dim, dim)
        self.conv_0 = nn.Conv1d(dim, dim, 5)
        self.conv_1 = nn.Conv1d(dim, dim, 5)
        self.dense = nn.Linear(dim, dim)

    def forward(self, src):
        x = self.embed(src.long()) if hasattr(self, "embed") else self.proj(src)
        x = torch.relu(_conv_same(self.conv_0, x))
        x = torch.relu(_conv_same(self.conv_1, x))
        return _l2_normalize(self.dense(x))


class RegionEncoder(nn.Module):
    """Embedding (concept ids) or Dense-relu-Dense (region features),
    L2-normalized -> [N, Tt, dim]."""

    def __init__(self, dim: int = 128, vocab: int = 0, feat_dim: int = 0):
        super().__init__()
        if vocab > 0:
            self.embed = nn.Embedding(vocab, dim)
        else:
            self.hidden = nn.Linear(feat_dim, dim)
            self.proj = nn.Linear(dim, dim)

    def forward(self, trg):
        if hasattr(self, "embed"):
            return _l2_normalize(self.embed(trg.long()))
        return _l2_normalize(self.proj(torch.relu(self.hidden(trg))))


class GroundingModel(nn.Module):
    def __init__(self, dim: int = 128, src_vocab: int = 0, trg_vocab: int = 0,
                 src_feat_dim: int = 0, trg_feat_dim: int = 0):
        super().__init__()
        self.speech = SpeechEncoder(dim, src_vocab, src_feat_dim)
        self.region = RegionEncoder(dim, trg_vocab, trg_feat_dim)

    def forward(self, src, trg):
        return self.speech(src), self.region(trg)  # [N, Ts, D], [N, Tt, D]


@dataclasses.dataclass(frozen=True)
class GroundingParams:
    model: GroundingModel
    opt_state: hmm_dnn.AdamState
    step: int = 0
    dim: int = 128
    learning_rate: float = 1e-3
    margin: float = 1.0


def _make_model(corpus: Corpus, dim: int) -> GroundingModel:
    ids_src, ids_trg = corpus.src.ndim == 2, corpus.trg.ndim == 2
    return GroundingModel(
        dim=dim, src_vocab=corpus.src_vocab if ids_src else 0,
        trg_vocab=corpus.trg_vocab if ids_trg else 0,
        src_feat_dim=0 if ids_src else corpus.src.shape[-1],
        trg_feat_dim=0 if ids_trg else corpus.trg.shape[-1],
    )


def init(
    corpus: Corpus,
    dim: int = 128,
    learning_rate: float = 1e-3,
    margin: float = 1.0,
    generator: torch.Generator | None = None,
) -> GroundingParams:
    """Initial model on the corpus's device, its weights drawn as flax
    initialises them from ``generator`` (a CPU generator seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = _make_model(corpus, dim)
    flax_params.flax_init(model, generator)
    model = model.to(corpus.device)
    return GroundingParams(model=model, opt_state=hmm_dnn.adam_init(model.parameters()),
                           dim=dim, learning_rate=learning_rate, margin=margin)


# flax names of the torch submodules; the region MLP's outer Dense is
# Dense_0 (flax names it first, as it is built first), its inner Dense_1
_FLAX_NAMES = dict(embed="Embed_0", conv_0="Conv_0", conv_1="Conv_1", proj="Dense_0",
                   hidden="Dense_1")


def _flax_names(model: GroundingModel) -> dict[str, str]:
    """The speech encoder's final Dense is Dense_0 after an embedding and
    Dense_1 after an input Dense (Dense_0)."""
    return dict(_FLAX_NAMES, dense="Dense_0" if hasattr(model.speech, "embed") else "Dense_1")


def params_from_numpy(
    params: dict,
    adam: dict | None = None,
    step: int = 0,
    learning_rate: float = 1e-3,
    margin: float = 1.0,
    device="cuda",
) -> GroundingParams:
    """Carry a flax parameter tree (numpy arrays, optionally under
    "params") onto a new model on ``device``; sizes come from the tree's
    shapes.  ``adam`` is the Adam state {"count", "mu", "nu"} with mu and nu
    trees of the same layout (fresh when None)."""
    t = params.get("params", params)
    sp, rg = t["speech"], t["region"]
    dim = np.asarray(sp["Conv_0"]["kernel"]).shape[-1]
    model = GroundingModel(
        dim=dim,
        src_vocab=np.asarray(sp["Embed_0"]["embedding"]).shape[0] if "Embed_0" in sp else 0,
        trg_vocab=np.asarray(rg["Embed_0"]["embedding"]).shape[0] if "Embed_0" in rg else 0,
        src_feat_dim=0 if "Embed_0" in sp else np.asarray(sp["Dense_0"]["kernel"]).shape[0],
        trg_feat_dim=0 if "Embed_0" in rg else np.asarray(rg["Dense_1"]["kernel"]).shape[0],
    ).to(device)
    names = _flax_names(model)
    flax_params.copy_into(model, flax_params.load_flax_tree(model, t, names, device))
    if adam is None:
        opt = hmm_dnn.adam_init(model.parameters())
    else:
        opt = hmm_dnn.AdamState(
            count=int(np.asarray(adam["count"])),
            mu=tuple(flax_params.load_flax_tree(model, adam["mu"], names, device)),
            nu=tuple(flax_params.load_flax_tree(model, adam["nu"], names, device)))
    return GroundingParams(model=model, opt_state=opt, step=int(step), dim=dim,
                           learning_rate=float(learning_rate), margin=float(margin))


def _pair_score(s, r, src_mask, trg_mask):
    """Matchmap score of every (speech i, image j) pair -> [N, N]: the max
    over regions (``torch.amax``, which splits the gradient over ties as
    JAX does), the mean over valid frames.  Builds [N, N, Ts, Tt]: for
    training batches and evaluation-sized corpora."""
    sim = torch.einsum("itd,jrd->ijtr", s, r)
    sim = torch.where(trg_mask[None, :, None, :], sim, -1.0)
    best = torch.where(src_mask[:, None, :], torch.amax(sim, dim=-1), 0.0)
    denom = torch.clamp(src_mask.sum(dim=1), min=1)[:, None]
    return best.sum(dim=-1) / denom


def _loss_fn(model, corpus: Corpus, margin: float, group=None):
    """The batch's max-margin loss.  With ``group`` the batch is the ranks'
    rows together: every rank's embeddings and lengths are gathered
    (differentiably), so the impostors are the whole global batch and every
    rank computes that batch's loss, its gradient flowing to its own rows."""
    s, r = model(corpus.src, corpus.trg)
    s, r, src_len, trg_len = gather_rows((s, r, corpus.src_len, corpus.trg_len), group)
    scores = _pair_score(s, r, lengths_to_mask(src_len, s.shape[1]),
                         lengths_to_mask(trg_len, r.shape[1]))
    pos = torch.diagonal(scores)
    n = scores.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=scores.device)
    # max-margin over impostors, both directions
    viol_c = torch.clamp(margin + scores - pos[:, None], min=0.0)
    viol_i = torch.clamp(margin + scores - pos[None, :], min=0.0)
    total = torch.where(off, viol_c, 0.0).sum() + torch.where(off, viol_i, 0.0).sum()
    return total / (2 * n * max(n - 1, 1))


def em_step(state: GroundingParams, corpus: Corpus,
            mesh=None) -> tuple[GroundingParams, dict]:
    """One Adam step on the corpus or a gathered minibatch -> (new state,
    {"loglik", "loss"} on the device); the input state is left untouched.
    With ``mesh`` the corpus is this rank's part of a global batch: the
    loss is the global batch's (``_loss_fn``) and the gradients are summed
    over the ranks (in ``hmm_dnn.adam_update``), so every rank takes the
    same step."""
    group = group_of(mesh)
    model = copy.deepcopy(state.model)
    loss = _loss_fn(model, corpus, state.margin, group)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    updates, opt = hmm_dnn.adam_update(grads, state.opt_state, state.learning_rate,
                                       group=group)
    hmm_dnn.apply_updates(model, updates)
    loss = loss.detach()
    new = dataclasses.replace(state, model=model, opt_state=opt, step=state.step + 1)
    return new, {"loglik": -loss, "loss": loss}


def _embed(state: GroundingParams, corpus: Corpus):
    with torch.no_grad():
        return state.model(corpus.src, corpus.trg)


def align(state: GroundingParams, corpus: Corpus, null_threshold: float = 0.0) -> torch.Tensor:
    """Frame -> best-region alignment from the matched pair's matchmap ->
    [N, Ts] int32 (0 = NULL, else 1-based trg position)."""
    s, r = _embed(state, corpus)
    sim = torch.einsum("ntd,nrd->ntr", s, r)
    sim = torch.where(corpus.trg_mask()[:, None, :], sim, -torch.inf)
    best = torch.argmax(sim, dim=-1).to(torch.int32) + 1
    a = torch.where(torch.amax(sim, dim=-1) >= null_threshold, best, 0)
    return torch.where(corpus.src_mask(), a, 0).to(torch.int32)


def retrieval_scores(state: GroundingParams, corpus: Corpus) -> torch.Tensor:
    """[N, N] matchmap scores (caption i, image j); the diagonal is true."""
    s, r = _embed(state, corpus)
    return _pair_score(s, r, corpus.src_mask(), corpus.trg_mask())


def retrieval_scores_pooled(
    state: GroundingParams,
    corpus: Corpus,
    candidates: torch.Tensor,  # [N, C] indices; column 0 = the true pairing
    direction: str = "c2i",
) -> torch.Tensor:
    """Pooled matchmap scores -> [N, C]: "c2i" scores caption i against its
    candidate images, "i2c" image i against its candidate captions.  The
    embeddings are computed once; each chunk of rows scores only its pools
    (O(N * C * Ts * Tt) in bounded blocks)."""
    if direction not in ("c2i", "i2c"):
        raise ValueError(f"direction must be c2i|i2c, got {direction!r}")
    s, r = _embed(state, corpus)
    src_mask, trg_mask = corpus.src_mask(), corpus.trg_mask()
    candidates = candidates.to(corpus.device).long()
    n, c = candidates.shape
    rows = max(1, POOL_CHUNK_BYTES // (4 * c * corpus.max_src_len * corpus.max_trg_len))
    out = torch.empty((n, c), dtype=s.dtype, device=s.device)
    for i in range(0, n, rows):
        cand = candidates[i:i + rows]
        if direction == "c2i":  # s_i against r_cand
            s_p, sm = s[i:i + rows, None], src_mask[i:i + rows, None]
            r_p, tm = r[cand], trg_mask[cand]
        else:  # r_i against s_cand
            s_p, sm = s[cand], src_mask[cand]
            r_p, tm = r[i:i + rows, None], trg_mask[i:i + rows, None]
        sim = torch.einsum("bctd,bcrd->bctr", s_p.expand(-1, c, -1, -1),
                           r_p.expand(-1, c, -1, -1))
        sim = torch.where(tm.expand(-1, c, -1)[:, :, None, :], sim, -1.0)
        sm = sm.expand(-1, c, -1)
        best = torch.where(sm, torch.amax(sim, dim=-1), 0.0)
        out[i:i + rows] = best.sum(dim=-1) / torch.clamp(sm.sum(dim=-1), min=1)
    return out


def train(state: GroundingParams, corpus: Corpus, num_iterations: int):
    """``num_iterations`` full-batch steps -> (state, per-step logliks,
    stacked on the device once at the end)."""
    lls = []
    for _ in range(num_iterations):
        state, stats = em_step(state, corpus)
        lls.append(stats["loglik"])
    if not lls:
        return state, torch.empty(0, device=corpus.device)
    return state, torch.stack(lls)
