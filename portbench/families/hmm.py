"""The discrete HMM aligner (``models.hmm`` of the port): the system under
test for the EM and decode windows, and its plain reference.

The program is entered as its users enter it: ``hmm.em_step`` on the
corpus (``use_kernels`` left at its default, the kernels on a CUDA
corpus: K1 -> K2 inside the fused gate, K1 -> K4 -> K7 outside it), and
``hmm.align`` (K3) for decode.
"""

from __future__ import annotations

import types

import torch

from portbench import compare, counts
from portbench.gen import corpus_tuple
from portbench.reference import hmm as ref


def _cfg(config: dict, inp: dict) -> dict:
    return {**config, "src_vocab": inp["src_vocab"], "trg_vocab": inp["trg_vocab"]}


def leaves(p) -> dict:
    """The parameters as the comparison reads them, each a distribution:
    the emission probabilities, and the jump-width and null weights
    normalised together (the M-step keeps them as log counts, whose scale
    the transitions' row normalisation removes)."""
    get = p.__getitem__ if isinstance(p, dict) else lambda k: getattr(p, k)
    return {"emit": torch.exp(get("log_emit")), "trans": transition_weights(get)}


def transition_weights(get) -> torch.Tensor:
    w = torch.exp(torch.cat([get("log_jump").double(), get("log_p0").double().reshape(1)]))
    return w / w.sum()


def launches() -> dict:
    from multimodalworddiscovery_tpu_torch.ops import counts as k17
    from multimodalworddiscovery_tpu_torch.ops import hmm_fwdbwd
    from multimodalworddiscovery_tpu_torch.ops import viterbi as k3

    return {"K1": k17.table_lookup.launches, "K2": hmm_fwdbwd.hmm_estep_counts.launches,
            "K4": hmm_fwdbwd.hmm_estep.launches, "K7": k17.pair_counts.launches,
            "K3": k3.viterbi.launches}


def build(config: dict, traffic: dict, inp: dict, use_kernels=None):
    """The program around the inputs; ``use_kernels`` as the port takes it
    (None: the kernels on a CUDA corpus; False: the plain path, a witness)."""
    from multimodalworddiscovery_tpu_torch.data.corpus import Corpus
    from multimodalworddiscovery_tpu_torch.models import hmm

    corpus = Corpus(src=inp["src"], src_len=inp["src_len"], trg=inp["trg"],
                    trg_len=inp["trg_len"], src_vocab=inp["src_vocab"],
                    trg_vocab=inp["trg_vocab"])
    mj, smoothing = config["max_jump"], config["smoothing"]
    n, ts = corpus.n, corpus.max_src_len
    tt, vs, vt = corpus.max_trg_len, corpus.src_vocab, corpus.trg_vocab
    sl, tl = inp["src_len_host"], inp["trg_len_host"]
    route = hmm.estep_route(2 * tt, vs, vt, corpus.device.type == "cuda", "float32")

    def step(params, it):
        params, stats = hmm.em_step(params, corpus, smoothing=smoothing,
                                    use_kernels=use_kernels)
        return params, stats["loglik"]

    def decode_device(params):
        return hmm.align(params, corpus, use_kernels=use_kernels)

    def train(iterations):
        params = hmm.init(corpus, max_jump=mj)
        for it in range(iterations):
            params, _ = step(params, it)
        return params

    estep = {"fused": {"K2": counts.k2_bound_ms(sl, tl, n, ts, tt, vs, vt)},
             "general": {"K4": counts.k4_bound_ms(sl, tl, n, tt),
                         "K7": counts.k7_bound_ms(sl, tl, n, ts, tt, vs, vt)}}.get(route, {})
    return types.SimpleNamespace(
        n=n, iterations=config["num_iterations"], init=hmm.init(corpus, max_jump=mj),
        step=step, decode_device=decode_device, train=train, leaves=leaves, launches=launches,
        route=route,
        work={"em": {"step_ops": counts.estep_ops(sl, tl), "bounds_ms": estep},
              "align": {"step_ops": 2.0 * counts.state_steps(sl, tl)[1],
                        "bounds_ms": {"K3": counts.k3_bound_ms(sl, tl, n, ts, tt)}}})


def reference_job(config: dict, inp: dict, control: bool = False, after_step=None):
    """One job from the initial parameters: (loglik of each step,
    {k: parameters after step k}), float64, or the control (float32 with
    TF32-rounded products).  ``after_step`` as the reference's EM takes it."""
    dtype, mode = (torch.float32, "tf32") if control else (torch.float64, "exact")
    ps, lls = ref.discrete_em(corpus_tuple(inp), _cfg(config, inp), config["num_iterations"],
                              dtype, mode, after_step=after_step)
    return lls, dict(enumerate(ps))


def judge(config: dict, inp: dict, jobs_lls, kept, detail: bool = False) -> dict:
    """The numbers compared (``compare.em_numbers``): every job's logliks,
    and each kept job's parameters ({k: parameters} for k = 0..last),
    against one float64 reference job from the same start."""
    lls_r, ps_r = reference_job(config, inp)
    steps = (0, 1, 3, config["num_iterations"])
    th_r = {k: leaves(ps_r[k]) for k in steps}
    jobs_th = [{k: leaves(th[k]) for k in steps} for th in kept]
    return compare.em_numbers(jobs_lls, lls_r, jobs_th, th_r, detail)


def reference_align(config: dict, inp: dict, iterations: int):
    """The reference's own parameters after ``iterations`` float64 EM steps
    from the initial ones, and each utterance's best path score."""
    ps, _ = ref.discrete_em(corpus_tuple(inp), _cfg(config, inp), iterations)
    return ps[-1], ref.viterbi(ps[-1], corpus_tuple(inp), config["max_jump"])


def align_gaps(config: dict, inp: dict, params, best, alignment) -> torch.Tensor:
    """[N] how far below the best path's score (under the reference's
    parameters) the best path that gives ``alignment`` lies, in nats."""
    a = torch.as_tensor(alignment, device=best.device)
    got = ref.viterbi(params, corpus_tuple(inp), config["max_jump"], alignment=a)
    return best - got


def control_alignment(config: dict, inp: dict, params):
    """The control's decode: the reference's Viterbi in bfloat16."""
    return ref.viterbi(params, corpus_tuple(inp), config["max_jump"], bf16=True, path=True)[1]
