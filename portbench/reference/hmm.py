"""Plain reference of the paired-NULL Vogel HMM aligner, discrete and
Gaussian-mixture emissions: EM and Viterbi scores.

Written from the model's definition (the float64 oracle's equations: states
are the image's concepts and a NULL state paired with each, transitions
are jump-width weights plus a null weight, each row normalised over the
utterance's states), in plain torch, batched over utterances in blocks of
rows.  It imports nothing of the program and takes nothing the program
made: it is handed the corpus and the initial draws, and works out every
parameter again.

The recursions run in the scaled probability domain, so each time step is
one product with the shared [S, S] jump matrix: the transition of
utterance n is ``B[s, s'] * valid[n, s'] / rz[n, s]``.  ``mm`` is the
product: ``exact`` (in the reference's dtype, float64) or ``tf32``, which
rounds both operands to TF32's 10-bit mantissa before a float32 product,
as the tensor cores do: the control of a float32 program whose products
run with TF32 off.  ``viterbi_scores(..., bf16=True)`` is the control of
the float32 decode, whose max-plus recursion has no product.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = 1.8378770664093453


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to the nearest TF32 value (10 mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def matmul(mode: str):
    if mode == "exact":
        return torch.matmul
    if mode == "tf32":
        return lambda a, b: torch.matmul(round_tf32(a.float()), round_tf32(b.float()))
    raise ValueError(f"unknown product mode {mode!r}")


def states(trg: torch.Tensor, trg_len: torch.Tensor):
    """(concept of each state [N, S], valid [N, S], pos [S], is_null [S])
    for S = 2 * Tt: state s < Tt is the concept at position s, state Tt + p
    the NULL state paired with position p."""
    tt = trg.shape[1]
    s = torch.arange(2 * tt, device=trg.device)
    pos, is_null = s % tt, s >= tt
    concept = torch.where(is_null[None, :], 0, trg[:, pos].long())
    valid = pos[None, :] < trg_len[:, None]
    return concept, valid, pos, is_null


def width_ids(pos, is_null, max_jump: int) -> torch.Tensor:
    """[S, S] slot of each transition: its jump width (0..W-1), W for the
    null weight (into the NULL state of the same position), W + 1 for an
    impossible one."""
    w = torch.clamp(pos[None, :] - pos[:, None], -max_jump, max_jump) + max_jump
    w_slots = 2 * max_jump + 1
    same = pos[None, :] == pos[:, None]
    return torch.where(is_null[None, :], torch.where(same, w_slots, w_slots + 1), w)


def transition(log_jump, log_p0, ids, is_null, valid, dtype):
    """(B [S, S], rz [N, S], init [N, S]) in ``dtype``: the init weight is 1
    on a concept's state and the null weight on a NULL state, normalised
    over the utterance's states."""
    table = torch.cat([torch.exp(log_jump.to(dtype)), torch.exp(log_p0.to(dtype)).reshape(1),
                       torch.zeros(1, dtype=dtype, device=log_jump.device)])
    b = table[ids]
    v = valid.to(dtype)
    rz = v @ b.T
    w = torch.where(is_null[None, :], torch.exp(log_p0.to(dtype)), torch.ones((), dtype=dtype,
                                                                           device=b.device))
    init = w * v
    return b, rz, init / init.sum(dim=1, keepdim=True)


def forward_backward(init, b, rz, valid, log_e, src_len, mm):
    """Scaled forward-backward over one block of rows.

    log_e [N, T, S]: each state's emission log-probability.  Returns (logZ
    [N], gamma [N, T, S], xi summed over rows and steps [S, S])."""
    n, t_max, s = log_e.shape
    dtype = init.dtype
    v = valid.to(dtype)
    live = torch.arange(t_max, device=log_e.device)[None, :] < src_len[:, None]  # [N, T]
    m = torch.where(valid[:, None, :], log_e, -math.inf).amax(dim=2)  # [N, T]
    m = torch.where(live, m, 0.0)
    e = torch.exp(log_e - m[..., None]) * v[:, None, :]
    a = init * e[:, 0]
    c0 = a.sum(dim=1)
    alphas, cs = [a / c0[:, None]], [c0]
    for t in range(1, t_max):
        a = mm(alphas[-1] / rz, b).to(dtype) * e[:, t]
        c = a.sum(dim=1)
        alive = live[:, t]
        alphas.append(torch.where(alive[:, None], a / c[:, None], alphas[-1]))
        cs.append(torch.where(alive, c, 1.0))
    c = torch.stack(cs, dim=1)  # [N, T]
    logz = torch.where(live, torch.log(c) + m, 0.0).sum(dim=1)
    beta = v.clone()
    gammas = [None] * t_max
    gammas[t_max - 1] = alphas[t_max - 1] * beta
    xi = torch.zeros((s, s), dtype=dtype, device=log_e.device)
    for t in range(t_max - 2, -1, -1):
        alive = live[:, t + 1]
        y = torch.where(alive[:, None], e[:, t + 1] * beta / c[:, t + 1, None], 0.0)
        xi = xi + mm((alphas[t] / rz).T, y).to(dtype)
        beta = torch.where(alive[:, None], mm(y, b.T).to(dtype) / rz, v)
        gammas[t] = alphas[t] * beta
    gamma = torch.stack(gammas, dim=1) * (live[..., None] & valid[:, None, :]).to(dtype)
    return logz, gamma, xi * b


def widths(xi, ids, max_jump: int) -> torch.Tensor:
    """[W + 1] expected counts of each jump width and of the null weight."""
    slots = 2 * max_jump + 2
    onehot = (ids.reshape(-1, 1) == torch.arange(slots, device=ids.device)).to(xi.dtype)
    return xi.reshape(1, -1) @ onehot


# --- discrete emissions --------------------------------------------------


def discrete_estep(p, corpus, max_jump, dtype, mm, block):
    """(emission counts [V_src, V_trg], width counts [W + 1], loglik)."""
    src, src_len, trg, trg_len = corpus
    concept, valid, pos, is_null = states(trg, trg_len)
    ids = width_ids(pos, is_null, max_jump)
    v_src, v_trg = p["log_emit"].shape
    log_emit = p["log_emit"].to(dtype)
    counts = torch.zeros(v_src * v_trg, dtype=dtype, device=src.device)
    xi = torch.zeros(ids.shape, dtype=dtype, device=src.device)
    ll = torch.zeros((), dtype=dtype, device=src.device)
    for lo in range(0, src.shape[0], block):
        sl = slice(lo, lo + block)
        b, rz, init = transition(p["log_jump"], p["log_p0"], ids, is_null, valid[sl], dtype)
        ids_src = src[sl].long()
        log_e = log_emit[ids_src[:, :, None], concept[sl][:, None, :]]
        logz, gamma, xib = forward_backward(init, b, rz, valid[sl], log_e, src_len[sl], mm)
        flat = ids_src[:, :, None] * v_trg + concept[sl][:, None, :]
        counts.index_add_(0, flat.reshape(-1), gamma.reshape(-1))
        xi += xib
        ll += logz.sum()
    return counts.reshape(v_src, v_trg), widths(xi, ids, max_jump)[0], ll


def discrete_mstep(counts, width_counts, smoothing, max_jump):
    emit = counts + smoothing
    w = 2 * max_jump + 1
    return {"log_emit": torch.log(emit) - torch.log(emit.sum(dim=0, keepdim=True)),
            "log_jump": torch.log(width_counts[:w] + smoothing),
            "log_p0": torch.log(width_counts[w] + smoothing)}


def discrete_init(v_src, v_trg, max_jump, dtype, device):
    w = 2 * max_jump + 1
    return {"log_emit": torch.full((v_src, v_trg), -math.log(v_src), dtype=dtype, device=device),
            "log_jump": -0.5 * torch.abs(torch.arange(w, dtype=dtype, device=device)
                                         - max_jump - 1),
            "log_p0": torch.tensor(math.log(0.2), dtype=dtype, device=device)}


def discrete_em(corpus, cfg, iterations, dtype=torch.float64, mode="exact", block=8192,
                after_step=None):
    """``iterations`` EM steps from the initial parameters -> (parameters
    after each step, loglik of each step).  ``after_step(params)`` may
    replace each step's parameters (a planted fault)."""
    src = corpus[0]
    v_src, v_trg = cfg["src_vocab"], cfg["trg_vocab"]
    p = discrete_init(v_src, v_trg, cfg["max_jump"], dtype, src.device)
    mm = matmul(mode)
    out, lls = [p], []
    for _ in range(iterations):
        counts, wc, ll = discrete_estep(p, corpus, cfg["max_jump"], dtype, mm, block)
        p = discrete_mstep(counts, wc, cfg["smoothing"], cfg["max_jump"])
        p = after_step(p) if after_step is not None else p
        out.append(p)
        lls.append(float(ll))
    return out, lls


# --- Gaussian-mixture emissions ------------------------------------------


def component_logdensity(p, x, mm):
    """[N, T, C*K] per-component log-densities, as two products."""
    c, k, d = p["means"].shape
    means = p["means"].reshape(c * k, d)
    log_vars = p["log_vars"].reshape(c * k, d)
    inv_var = torch.exp(-log_vars)
    const = -0.5 * (log_vars.sum(-1) + (means ** 2 * inv_var).sum(-1) + d * LOG_2PI)
    out = mm(x, (means * inv_var).T).to(x.dtype) - mm(x * x, (0.5 * inv_var).T).to(x.dtype)
    return out + const


def gauss_estep(p, corpus, max_jump, scale, dtype, mm, block):
    """(sufficient statistics, loglik) of one E-step at emission scale
    ``scale``."""
    x_all, src_len, trg, trg_len = corpus
    concept, valid, pos, is_null = states(trg, trg_len)
    ids = width_ids(pos, is_null, max_jump)
    c, k, d = p["means"].shape
    logw = torch.log_softmax(p["log_mix"].to(dtype), dim=-1)
    stats = {"c0": 0.0, "c1": 0.0, "c2": 0.0, "xi": 0.0, "fsum": 0.0, "fsq": 0.0, "fcnt": 0.0}
    ll = torch.zeros((), dtype=dtype, device=x_all.device)
    pd = {key: val.to(dtype) for key, val in p.items()}
    for lo in range(0, x_all.shape[0], block):
        sl = slice(lo, lo + block)
        x = x_all[sl].to(dtype)
        comp = component_logdensity(pd, x, mm).reshape(*x.shape[:2], c, k)
        dens = torch.logsumexp(comp + logw, dim=-1)  # [B, T, C]
        log_e = torch.gather(dens, 2, concept[sl][:, None, :].expand(-1, x.shape[1], -1))
        b, rz, init = transition(pd["log_jump"], pd["log_p0"], ids, is_null, valid[sl], dtype)
        logz, gamma, xib = forward_backward(init, b, rz, valid[sl], log_e * scale,
                                            src_len[sl], mm)
        r = torch.zeros((*gamma.shape[:2], c), dtype=dtype, device=x.device)
        r.scatter_add_(2, concept[sl][:, None, :].expand_as(gamma), gamma)
        comb = (r[..., None] * torch.softmax(comp + logw, dim=-1)).reshape(-1, c * k)
        xf = x.reshape(-1, d)
        live = (torch.arange(x.shape[1], device=x.device)[None, :]
                < src_len[sl][:, None]).reshape(-1, 1).to(dtype)
        stats["c0"] = stats["c0"] + comb.sum(0).reshape(c, k)
        stats["c1"] = stats["c1"] + mm(comb.T, xf).to(dtype).reshape(c, k, d)
        stats["c2"] = stats["c2"] + mm(comb.T, xf * xf).to(dtype).reshape(c, k, d)
        stats["xi"] = stats["xi"] + xib
        stats["fsum"] = stats["fsum"] + (xf * live).sum(0)
        stats["fsq"] = stats["fsq"] + (xf * xf * live).sum(0)
        stats["fcnt"] = stats["fcnt"] + live.sum()
        ll += logz.sum()
    stats["width"] = widths(stats.pop("xi"), ids, max_jump)[0]
    return stats, ll


def gauss_mstep(stats, max_jump, smoothing, var_floor, var_floor_rel):
    c0 = stats["c0"] + smoothing
    means = stats["c1"] / c0[..., None]
    tot = torch.clamp(stats["fcnt"], min=1.0)
    gmean = stats["fsum"] / tot
    gvar = stats["fsq"] / tot - gmean ** 2
    floor = torch.clamp(var_floor_rel * gvar, min=var_floor)[None, None, :]
    var = torch.maximum(stats["c2"] / c0[..., None] - means ** 2, floor)
    w = 2 * max_jump + 1
    return {"means": means, "log_vars": torch.log(var),
            "log_mix": torch.log(c0) - torch.log(c0.sum(dim=-1, keepdim=True)),
            "log_jump": torch.log(stats["width"][:w] + smoothing),
            "log_p0": torch.log(stats["width"][w] + smoothing)}


def gauss_init(x, src_len, n_concepts, n_components, max_jump, jitter, dtype):
    """Means = corpus mean + the jitter draws (``jitter`` [C, K, D], standard
    normals: 0.1 of a concept's draw, plus 0.3 of a component's, times the
    feature deviation), variances the corpus variance, uniform mixtures."""
    xd = x.to(dtype)
    live = (torch.arange(x.shape[1], device=x.device)[None, :] < src_len[:, None])[..., None]
    cnt = live.sum().to(dtype)
    mean = torch.where(live, xd, 0.0).sum(dim=(0, 1)) / cnt
    var = torch.where(live, (xd - mean) ** 2, 0.0).sum(dim=(0, 1)) / cnt
    sd = torch.sqrt(var)
    w = 2 * max_jump + 1
    return {"means": mean + sd * jitter.to(dtype),
            "log_vars": torch.log(var + 1e-6).expand(n_concepts, n_components, -1).clone(),
            "log_mix": torch.full((n_concepts, n_components), -math.log(n_components),
                                  dtype=dtype, device=x.device),
            "log_jump": -0.5 * torch.abs(torch.arange(w, dtype=dtype, device=x.device)
                                         - max_jump - 1),
            "log_p0": torch.tensor(math.log(0.2), dtype=dtype, device=x.device)}


def gauss_em(corpus, cfg, jitter, scales, dtype=torch.float64, mode="exact", block=1000,
             after_step=None):
    """EM steps at the emission scales ``scales`` -> (parameters before and
    after each step, loglik of each step).  ``after_step(params)`` may
    replace each step's parameters (a planted fault)."""
    x, src_len = corpus[0], corpus[1]
    p = gauss_init(x, src_len, cfg["trg_vocab"], cfg["n_components"], cfg["max_jump"],
                   jitter, dtype)
    mm = matmul(mode)
    out, lls = [p], []
    for scale in scales:
        stats, ll = gauss_estep(p, corpus, cfg["max_jump"], scale, dtype, mm, block)
        p = gauss_mstep(stats, cfg["max_jump"], cfg["smoothing"], cfg["var_floor"],
                        cfg["var_floor_rel"])
        p = after_step(p) if after_step is not None else p
        out.append(p)
        lls.append(float(ll))
    return out, lls


# --- Viterbi -------------------------------------------------------------


def viterbi(p, corpus, max_jump, alignment=None, bf16=False, path=False, block=1000):
    """Best path log-score per utterance [N] under the discrete model;
    with ``alignment`` [N, T] (0 = NULL, else 1-based concept position) the
    best score among the paths that give that alignment (-inf where none
    does).  With ``path`` also the best path's alignment [N, T] (ties to
    the lowest state).  ``bf16`` rounds every score to bfloat16 as it is
    made (the control of a float32 decode)."""
    src, src_len, trg, trg_len = corpus
    concept, valid, pos, is_null = states(trg, trg_len)
    ids = width_ids(pos, is_null, max_jump)
    dtype = torch.float64
    rnd = (lambda z: z.to(torch.bfloat16).to(dtype)) if bf16 else (lambda z: z)
    log_emit = rnd(p["log_emit"].to(dtype))
    scores, aligns = [], []
    t_max = src.shape[1]
    for lo in range(0, src.shape[0], block):
        sl = slice(lo, lo + block)
        b, rz, init = transition(p["log_jump"], p["log_p0"], ids, is_null, valid[sl], dtype)
        log_b, log_rz = rnd(torch.log(b)), rnd(torch.log(rz))
        ids_src = src[sl].long()
        log_e = log_emit[ids_src[:, :, None], concept[sl][:, None, :]]
        allow = valid[sl][:, None, :].expand_as(log_e)
        if alignment is not None:
            a = alignment[sl].long()[:, :, None]
            allow = allow & torch.where(a == 0, is_null[None, None, :],
                                        (~is_null[None, None, :]) & (pos[None, None, :] == a - 1))
        log_e = torch.where(allow, log_e, -math.inf)
        live = torch.arange(t_max, device=src.device)[None, :] < src_len[sl][:, None]
        delta = rnd(torch.log(init) + log_e[:, 0])
        ident = torch.arange(delta.shape[1], device=src.device).expand_as(delta)
        bps = []
        for t in range(1, t_max):
            step = (delta - log_rz)[:, :, None] + log_b[None]
            best, arg = step.max(dim=1)
            nxt = rnd(best + log_e[:, t])
            delta = torch.where(live[:, t, None], nxt, delta)
            if path:
                bps.append(torch.where(live[:, t, None], arg, ident).to(torch.int16))
        score, state = delta.max(dim=1)
        scores.append(score)
        if path:
            states_t = [state]
            for bp in reversed(bps):
                state = bp.long().gather(1, state[:, None])[:, 0]
                states_t.append(state)
            st = torch.stack(states_t[::-1], dim=1)  # [B, T]
            al = torch.where(is_null[st], 0, pos[st] + 1)
            aligns.append(torch.where(live, al, 0).to(torch.int32))
    scores = torch.cat(scores)
    return (scores, torch.cat(aligns)) if path else scores
