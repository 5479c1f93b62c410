"""The Gaussian-mixture HMM aligner (``models.hmm_gaussian`` of the port)
on the stand-in acoustic frames: the system under test for the EM window,
and its plain reference.

One iteration is the step the port's CLI composes for a configuration with
``train.corpus_chunks``: ``models.bucketed.chunked_expected_counts`` over
the chunks (the two float32 log-density products, K4 on each chunk, the
moments' products), then ``hmm_gaussian.m_step``.  The first
``anneal_iters`` iterations scale the emissions from ``anneal_beta0`` to 1.
"""

from __future__ import annotations

import types

import numpy as np
import torch

from portbench import compare, counts
from portbench.gen import corpus_tuple
from portbench.families.hmm import transition_weights
from portbench.reference import hmm as ref


def scales(config: dict) -> list[float]:
    """The emission scale of each iteration of a job (float32 values)."""
    total, ramp = config["num_iterations"], config["anneal_iters"]
    sched = np.concatenate([np.linspace(config["anneal_beta0"], 1.0, max(ramp, 1)),
                            np.ones(max(total - ramp, 0))])[:total]
    return [float(v) for v in sched.astype(np.float32)]


def leaves(p) -> dict:
    """The parameters as the comparison reads them: means, variances,
    mixture weights, and the jump-width and null weights normalised
    together (as the discrete family's)."""
    get = p.__getitem__ if isinstance(p, dict) else lambda k: getattr(p, k)
    return {"means": get("means"), "vars": torch.exp(get("log_vars")),
            "mix": torch.exp(get("log_mix")), "trans": transition_weights(get)}


def launches() -> dict:
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd

    return {"K2": hmm_fwdbwd.hmm_estep_counts.launches, "K4": hmm_fwdbwd.hmm_estep.launches}


def jitter(config: dict, inp: dict) -> torch.Tensor:
    """The initial means' standard-normal draws, as ``hmm_gaussian.init``
    takes them from a CPU generator seeded with the run's seed."""
    gen = torch.Generator().manual_seed(int(inp["seed"]))
    c, k, d = inp["trg_vocab"], config["n_components"], config["frames"]["feat_dim"]
    z = 0.1 * torch.randn((c, 1, d), generator=gen)
    if k > 1:
        z = z + 0.3 * torch.randn((c, k, d), generator=gen)
    return z.expand(c, k, d).to(inp["src"].device)


def build(config: dict, traffic: dict, inp: dict, use_kernels=None):
    """The program around the inputs; ``use_kernels`` as the port takes it
    (None: the kernels on a CUDA corpus; False: the plain path, a witness)."""
    from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
    from multimodalworddiscovery_tpu_torch.models import hmm_gaussian
    from multimodalworddiscovery_tpu_torch.models.bucketed import chunked_expected_counts

    corpus = Corpus(src=inp["src"], src_len=inp["src_len"], trg=inp["trg"],
                    trg_len=inp["trg_len"], src_vocab=0, trg_vocab=inp["trg_vocab"])
    chunks, smoothing = config["corpus_chunks"], config["smoothing"]
    sched = scales(config)

    def step(params, it):
        stats, ll = chunked_expected_counts(hmm_gaussian, params, corpus, chunks,
                                            use_kernels=use_kernels, emit_scale=sched[it])
        return hmm_gaussian.m_step(params, stats, smoothing, config["var_floor"],
                                   config["var_floor_rel"]), ll

    init = hmm_gaussian.init(corpus, max_jump=config["max_jump"],
                             n_components=config["n_components"],
                             generator=torch.Generator().manual_seed(int(inp["seed"])))
    sl, tl = inp["src_len_host"], inp["trg_len_host"]
    n, tt = corpus.n, corpus.max_trg_len
    per = -(-n // chunks)
    k4 = sum(counts.k4_bound_ms(sl[i:i + per], tl[i:i + per], per, tt)
             for i in range(0, n, per))
    frames = float(np.sum(sl))
    prod = counts.gauss_product_ops(frames, config["frames"]["feat_dim"],
                                    inp["trg_vocab"] * config["n_components"])
    return types.SimpleNamespace(
        n=n, iterations=config["num_iterations"], init=init, step=step, leaves=leaves,
        launches=launches, route="general",
        work={"em": {"step_ops": counts.estep_ops(sl, tl) + prod, "bounds_ms": {"K4": k4}}})


FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")


def _as_dict(p, dtype=torch.float64) -> dict:
    get = p.__getitem__ if isinstance(p, dict) else lambda k: getattr(p, k)
    return {f: get(f).to(dtype) for f in FIELDS}


def reference_job(config: dict, inp: dict, control: bool = False, after_step=None):
    """One job from the initial parameters: (loglik of each step,
    {k: parameters after step k}), float64, or the control (float32 with
    TF32-rounded products).  ``after_step`` as the reference's EM takes it."""
    dtype, mode = (torch.float32, "tf32") if control else (torch.float64, "exact")
    cfg = {**config, "trg_vocab": inp["trg_vocab"]}
    ps, lls = ref.gauss_em(corpus_tuple(inp), cfg, jitter(config, inp), scales(config), dtype,
                           mode, after_step=after_step)
    return lls, dict(enumerate(ps))


def judge(config: dict, inp: dict, jobs_lls, kept, detail: bool = False) -> dict:
    """The numbers compared.  Over a whole job the float32 trajectory and
    the float64 one part (at 768 dimensions a frame's log-density is some
    10^3 nats and a caption's 10^5, so the log-space E-step's rounding moves
    the mixture's near-tied responsibilities), and rounding alone would
    read as large as a fault.  So the reference follows the program step by
    step from its own parameters, and checks the start by itself:

    - ``start``: the worst leaf's ‖θ0 - θ0_ref‖ / ‖θ0_ref‖, θ0_ref made by
      the reference from the corpus and the initial draws;
    - each step k: the reference's float64 E-step and M-step from the
      program's θ_{k-1} at the step's emission scale give ll_k and θ_k;
      ``loglik_1`` is step 1's relative loglik gap and ``loglik`` the worst
      of every step of every job (each job has the kept job's start and
      steps: EM is deterministic); ``step_1`` and ``step`` (the worst step)
      are the worst leaf's ‖θ_k - θ_k_ref‖ against the reference step's
      change of that leaf or of the median leaf, whichever is larger.

    Leaves the reference step moves by less than a thousandth of the median
    leaf's change are left out.  ``detail`` adds each step's gaps."""
    cfg = {**config, "trg_vocab": inp["trg_vocab"]}
    x, src_len = inp["src"], inp["src_len"]
    p0 = ref.gauss_init(x, src_len, cfg["trg_vocab"], config["n_components"],
                        config["max_jump"], jitter(config, inp), torch.float64)
    sched, mj = scales(config), config["max_jump"]
    th = kept[0]
    l0, lp = leaves(p0), leaves(_as_dict(th[0]))
    out = {"start": compare.worst(compare.norm(lp[k] - l0[k]) / compare.norm(l0[k]) for k in l0)}
    lls_r, steps = [], []
    for k in range(1, len(sched) + 1):
        prev = _as_dict(th[k - 1])
        stats, ll = ref.gauss_estep(prev, corpus_tuple(inp), mj, sched[k - 1], torch.float64,
                                    torch.matmul, 1000)
        p_r = ref.gauss_mstep(stats, mj, config["smoothing"], config["var_floor"],
                              config["var_floor_rel"])
        lls_r.append(float(ll))
        lr, lprev, lk = leaves(p_r), leaves(prev), leaves(_as_dict(th[k]))
        ch = {leaf: compare.norm(lr[leaf] - lprev[leaf]) for leaf in lr}
        med = float(torch.tensor(list(ch.values())).median())
        steps.append(compare.worst(compare.norm(lk[leaf] - lr[leaf]) / max(c, med)
                                   for leaf, c in ch.items() if c >= 1e-3 * med))
    each = [compare.worst([abs(lls[i] - b) / abs(b) for lls in jobs_lls if len(lls) > i])
            for i, b in enumerate(lls_r)]
    out.update(loglik_1=each[0], loglik=compare.worst(each), step_1=steps[0],
               step=compare.worst(steps))
    if detail:
        out.update(loglik_each=each, step_each=steps)
    return out
