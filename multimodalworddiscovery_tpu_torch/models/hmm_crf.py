"""End-to-end differentiable HMM aligner: CRF-style marginal-likelihood
training of the neural emission scorer.

Counterpart of ``multimodalworddiscovery_tpu/models/hmm_crf.py``.  The
DNN-HMM of ``hmm_dnn`` trains its MLP against frozen per-iteration
posterior targets; here the MLP gets exact gradients through the aligner's
marginal log-likelihood: d logZ / d log_emit[n, t, s] = gamma[n, t, s], the
state posterior the E-step already computes.  ``logmarginal`` is a
``torch.autograd.Function`` (the reference's ``jax.custom_vjp``) whose
forward is ``hmm_core.estep`` (K4, or K4-bf16, on the kernel route) and
whose backward is one more read of its gamma.

Transitions are constants inside that gradient and re-estimated by the
closed-form M-step from expected counts; ``logmarginal_e2e`` also
differentiates them, with the CRF moment difference, and
``em_step(learn_transitions=True)`` trains them by Adam at their own rate
(``TRANSITION_LR``).

The scaled-likelihood prior is self-consistent and differentiable: the
emission potentials are log p(c|x) - log E_frames[p(c|x)] under the
current MLP.  Parameters and decoding are ``hmm_dnn``'s.

The moment product of ``logmarginal_e2e``'s backward is a float32 matmul:
keep ``torch.backends.cuda.matmul.allow_tf32`` off (its default).
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of, sum_ranks
from multimodalworddiscovery_tpu_torch.core.counts import select_columns
from multimodalworddiscovery_tpu_torch.core.logsemiring import NEG_INF
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
from multimodalworddiscovery_tpu_torch.models import hmm_core, hmm_dnn

# re-exported so the model surface matches the other aligners
DnnHMMParams = hmm_dnn.DnnHMMParams
init = hmm_dnn.init
align = hmm_dnn.align
posteriors = hmm_dnn.posteriors
loglik = hmm_dnn.loglik
_machinery = hmm_dnn._machinery  # retrieval re-pairing path

# Adam's rate on (log_jump, log_p0) with learn_transitions: Adam is
# invariant to the gradient's scale, so at the MLP's rate the handful of
# transition scalars crawl; they get their own rate instead
TRANSITION_LR = 2e-2


class _LogMarginal(torch.autograd.Function):
    """sum_n logZ_n; backward: zeros for the transitions, ct * gamma for
    log_emit."""

    @staticmethod
    def forward(ctx, log_jump, log_p0, log_emit, max_jump, corpus, use_kernels, dot_dtype):
        gamma, _, logz = hmm_core.estep(log_jump, log_p0, max_jump, log_emit, corpus,
                                        use_kernels=use_kernels, dot_dtype=dot_dtype)
        ctx.save_for_backward(gamma, log_jump, log_p0)
        return logz.sum()

    @staticmethod
    def backward(ctx, ct):
        gamma, log_jump, log_p0 = ctx.saved_tensors
        return (torch.zeros_like(log_jump), torch.zeros_like(log_p0), ct * gamma,
                None, None, None, None)


class _LogMarginalE2E(torch.autograd.Function):
    """sum_n logZ_n; backward: ct * gamma for log_emit and the CRF moment
    difference for (log_jump, log_p0)."""

    @staticmethod
    def forward(ctx, log_jump, log_p0, log_emit, max_jump, corpus, use_kernels, dot_dtype):
        gamma, width_counts, logz = hmm_core.estep(
            log_jump, log_p0, max_jump, log_emit, corpus,
            use_kernels=use_kernels, dot_dtype=dot_dtype,
        )
        ctx.save_for_backward(gamma, width_counts, log_jump, log_p0)
        ctx.max_jump, ctx.corpus = max_jump, corpus
        return logz.sum()

    @staticmethod
    def backward(ctx, ct):
        gamma, width_counts, log_jump, log_p0 = ctx.saved_tensors
        d_jump, d_p0 = _transition_moments(gamma, width_counts, log_jump, log_p0,
                                           ctx.corpus, ctx.max_jump)
        return ct * d_jump, ct * d_p0, ct * gamma, None, None, None, None


def _transition_moments(gamma, width_counts, log_jump, log_p0, corpus: Corpus,
                        max_jump: int):
    """d logZ / d (log_jump, log_p0): the expected jump counts under the
    posterior (``width_counts``) minus their expectation under the current
    rows, sum_{n,s} occ_out[n, s] p_n(w | s), with occ_out[n, s] =
    sum_{t+1<len} gamma[n, t, s]; log_p0 also takes the initial
    distribution's moment, E[null at t=0] - p_init(null).  The model term
    never builds [N, S, S]: with exp(trans) = exp(base) exp(-rowz) valid it
    is one [S, N] x [N, S] product summed onto width ids."""
    tt = corpus.max_trg_len
    ts = gamma.shape[1]
    w_jump = 2 * max_jump + 1
    base, rowz, colmask = hmm_core.factor_log_trans(log_jump, log_p0, corpus, max_jump)

    t_idx = torch.arange(ts, device=gamma.device)
    not_last = (t_idx[None, :] + 1) < corpus.src_len[:, None]
    occ_out = (gamma * not_last[:, :, None].to(gamma.dtype)).sum(dim=1)  # [N, S]
    a = occ_out * torch.exp(torch.clamp(-rowz, max=60.0))
    valid = (colmask > NEG_INF / 2).to(a.dtype)  # [N, S']
    m = torch.exp(base) * (a.T @ valid)
    e_model = hmm_core.project_widths(m, tt, max_jump)
    d_table = width_counts - e_model  # [W + 2]; the impossible slot is 0 - 0

    _, is_null = hmm_core.state_positions(tt, gamma.device)
    null_f = is_null[None, :].to(gamma.dtype)
    e_null0 = (gamma[:, 0] * null_f).sum()
    log_init = hmm_core.build_log_init(log_p0, corpus)
    nonempty = (corpus.src_len > 0).to(gamma.dtype)
    p_null0 = (torch.exp(log_init) * null_f).sum(dim=1)  # [N]
    d_p0_init = e_null0 - (p_null0 * nonempty).sum()
    return d_table[:w_jump], d_table[w_jump] + d_p0_init


def logmarginal(
    max_jump: int,
    use_kernels: bool | None,
    dot_dtype: str,
    log_jump: torch.Tensor,
    log_p0: torch.Tensor,
    log_emit: torch.Tensor,  # [N, Ts, S]
    corpus: Corpus,
) -> torch.Tensor:
    """sum_n log p(x_n) under the Vogel HMM, differentiable in ``log_emit``
    (gradient: the state posteriors; the transitions get zero gradients
    and are re-estimated by the M-step)."""
    return _LogMarginal.apply(log_jump, log_p0, log_emit, max_jump, corpus,
                              use_kernels, dot_dtype)


def logmarginal_e2e(
    max_jump: int,
    use_kernels: bool | None,
    dot_dtype: str,
    log_jump: torch.Tensor,
    log_p0: torch.Tensor,
    log_emit: torch.Tensor,  # [N, Ts, S]
    corpus: Corpus,
) -> torch.Tensor:
    """sum_n log p(x_n), differentiable in ``log_emit`` and in the
    transition parameters (``log_jump``, ``log_p0``), whose gradient is the
    CRF moment difference (``_transition_moments``)."""
    return _LogMarginalE2E.apply(log_jump, log_p0, log_emit, max_jump, corpus,
                                 use_kernels, dot_dtype)


def _log_emit_from_mlp(mlp: hmm_dnn.EmissionMLP, corpus: Corpus, group=None) -> torch.Tensor:
    """Emission potentials with the self-consistent prior: the log-prior is
    the MLP's own masked mean posterior over the batch, differentiated
    through (no stop-gradient).  With ``group`` the batch is the ranks'
    rows together: the mean's sums run over every rank (``sum_ranks``)."""
    logpost = torch.log_softmax(mlp(corpus.src), dim=-1)
    w = corpus.src_mask().to(logpost.dtype)[..., None]
    sums = sum_ranks(torch.cat([(torch.exp(logpost) * w).sum(dim=(0, 1)), w.sum()[None]]),
                     group)
    prior = sums[:-1] / torch.clamp(sums[-1], min=1.0)
    logb = logpost - torch.log(prior + 1e-8)[None, None, :]
    return select_columns(logb, hmm_core.state_concepts(corpus))


def init_e2e(corpus: Corpus, **kw) -> DnnHMMParams:
    """Parameters for the fully end-to-end mode (``learn_transitions=True``):
    the Adam state also covers (log_jump, log_p0), at ``TRANSITION_LR``."""
    p = hmm_dnn.init(corpus, **kw)
    opt = dict(p.opt_state, trans=hmm_dnn.adam_init((p.log_jump, p.log_p0)))
    return dataclasses.replace(p, opt_state=opt)


def em_step(
    params: DnnHMMParams,
    corpus: Corpus,
    smoothing: float = 1e-6,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
    learn_transitions: bool = False,
    mesh=None,
) -> tuple[DnnHMMParams, dict[str, torch.Tensor]]:
    """One hybrid iteration: ``n_sgd`` Adam steps on -logZ / frames through
    the aligner (``logmarginal``), then the closed-form prior and
    transition M-step from fresh expected counts.

    ``learn_transitions=True`` trains ``log_jump`` / ``log_p0`` by Adam
    through ``logmarginal_e2e`` instead of the closed-form transition
    update; the parameters must come from ``init_e2e``.  The E-steps run
    through K4 with ``use_kernels=True`` (None: on a CUDA corpus).

    With ``mesh`` the corpus is this rank's part of a global batch: the
    frame count is the global one (one all_reduce), each Adam step's
    gradients are summed over the ranks (in ``hmm_dnn.adam_update``), and
    so are the counts, the loglik and the last step's loss (one
    all_reduce)."""
    group = group_of(mesh)
    n_frames = torch.clamp(all_sum(corpus.src_mask().sum(), group), min=1).to(torch.float32)
    mlp = copy.deepcopy(params.mlp)
    weights = list(mlp.parameters())
    if learn_transitions:
        if "trans" not in params.opt_state:
            raise ValueError("learn_transitions=True needs parameters from init_e2e")
        lj = params.log_jump.detach().clone().requires_grad_()
        lp0 = params.log_p0.detach().clone().requires_grad_()
        marginal, trans = logmarginal_e2e, [lj, lp0]
    else:
        marginal, trans = logmarginal, []
        lj, lp0 = params.log_jump, params.log_p0
    opt = dict(params.opt_state)
    for _ in range(params.n_sgd):
        log_emit = _log_emit_from_mlp(mlp, corpus, group)
        loss = -marginal(params.max_jump, use_kernels, dot_dtype, lj, lp0, log_emit,
                         corpus) / n_frames
        grads = torch.autograd.grad(loss, weights + trans)
        updates, opt["mlp"] = hmm_dnn.adam_update(grads[:len(weights)], opt["mlp"],
                                                  params.learning_rate, group=group)
        hmm_dnn.apply_updates(mlp, updates)
        if learn_transitions:
            updates, opt["trans"] = hmm_dnn.adam_update(grads[len(weights):], opt["trans"],
                                                        TRANSITION_LR, group=group)
            with torch.no_grad():
                lj.add_(updates[0])
                lp0.add_(updates[1])
    params = dataclasses.replace(params, mlp=mlp, opt_state=opt, log_jump=lj.detach(),
                                 log_p0=lp0.detach())
    (counts, ll), loss = all_sum((hmm_dnn.expected_counts(params, corpus, use_kernels,
                                                           dot_dtype), loss.detach()), group)
    if learn_transitions:
        # closed-form update of the decode-time prior only
        prior = counts["prior"] + smoothing
        params = dataclasses.replace(params, log_prior=torch.log(prior) - torch.log(prior.sum()))
    else:
        params = hmm_dnn.m_step(params, counts, smoothing)
    return params, {"loglik": ll, "nll_per_frame": loss}


def train(
    params: DnnHMMParams,
    corpus: Corpus,
    num_iterations: int,
    use_kernels: bool | None = None,
    dot_dtype: str = "float32",
    learn_transitions: bool = False,
) -> tuple[DnnHMMParams, torch.Tensor]:
    """``num_iterations`` hybrid iterations -> (params, per-iteration
    logliks, stacked on the device once at the end)."""
    lls = []
    for _ in range(num_iterations):
        params, stats = em_step(params, corpus, use_kernels=use_kernels,
                                dot_dtype=dot_dtype, learn_transitions=learn_transitions)
        lls.append(stats["loglik"])
    if not lls:
        return params, torch.empty(0, device=corpus.device)
    return params, torch.stack(lls)
