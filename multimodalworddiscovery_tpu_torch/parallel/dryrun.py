"""Multi-rank dry run of the parallel paths on tiny shapes.

Counterpart of the JAX package's ``dryrun_multichip(n)``
(``__graft_entry__.py``): spawns ``n`` ranks on the cards (NCCL when ``n``
is at most the card count, else gloo on CUDA tensors, rank r on card r
modulo the count) or, with ``--device cpu``, gloo ranks on the CPU; runs
the reference's compositions on every rank and prints the device and
backend, then rank 0's lines, the reference's wording:

    python -m multimodalworddiscovery_tpu_torch.parallel.dryrun 4 [--device cpu]

1.  data-parallel EM; 1b. the data-parallel minibatch attention step;
2.  the explicit per-shard EM through the kernels (their plain versions on
    the CPU) against the single-process step;
3.  bucketed EM over the mesh and a chunked E-step per shard;
4.  the minibatch CRF with learned transitions;
5.  the time-sharded forward and E-step against the sequential E-step;
6.  streaming EM over the mesh against resident EM;
7.  the multi-rank bucketed EM and the streamed minibatch trainer;
8.  streamed annealed Gaussian EM over the mesh;
9.  Model-1 and segmental k-means EM over the mesh;
10. the multi-rank VQ-teacher recipe with annealed Gaussian EM; and the
    data-parallel minibatch grounding step.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F


def _expect(ok: bool, what: str) -> None:
    """Fail the composition (and so the dry run) unless ``ok``."""
    if not ok:
        raise RuntimeError(what)


def _tiny(n_utterances: int, device):
    from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini

    return make_flickr8k_mini(n_utterances=n_utterances, n_concepts=10, n_phones=16, seed=0,
                              device=device)


def compositions(n: int, device: str, tmp: str) -> list[str]:
    """Run every composition on this rank; returns the lines it reports."""
    from multimodalworddiscovery_tpu_torch.core.collectives import (
        all_sum,
        group_of,
        max_disagreement,
    )
    from multimodalworddiscovery_tpu_torch.core.mesh import make_mesh
    from multimodalworddiscovery_tpu_torch.data import phones_to_frames
    from multimodalworddiscovery_tpu_torch.data.stream import (
        ShardedCorpusReader,
        train_streaming,
        write_shards,
    )
    from multimodalworddiscovery_tpu_torch.models import (
        attention,
        grounding,
        hmm,
        hmm_core,
        hmm_crf,
        hmm_gaussian,
        model1,
        segmental_kmeans,
    )
    from multimodalworddiscovery_tpu_torch.models.bucketed import (
        chunked_expected_counts,
        train_bucketed,
    )
    from multimodalworddiscovery_tpu_torch.models.minibatch import make_minibatch_step
    from multimodalworddiscovery_tpu_torch.parallel import (
        make_data_parallel_step,
        make_shard_map_em_step,
        multihost,
        shard_corpus,
    )
    from multimodalworddiscovery_tpu_torch.parallel.data_parallel import take_rows
    from multimodalworddiscovery_tpu_torch.parallel.sequence import (
        estep_time_sharded,
        forward_time_sharded,
    )

    lines = []

    def say(what: str) -> None:
        lines.append(f"dryrun_multichip({n}): {what}")

    def rel(a, b) -> float:
        return abs(float(a) - float(b)) / max(abs(float(b)), 1.0)

    gen = lambda seed: torch.Generator().manual_seed(seed)  # noqa: E731
    mesh = make_mesh(n)
    group = group_of(mesh)

    # --- 1. data-parallel EM step ---
    corpus, gold, _ = _tiny(2 * n, device)
    sharded = shard_corpus(corpus, mesh)
    params = hmm.init(corpus)
    new, stats = make_data_parallel_step(hmm.em_step, mesh)(params, sharded)
    ll = float(stats["loglik"])
    _expect(ll == ll, "loglik is NaN")
    agree = max_disagreement(new, group)
    _expect(agree == 0.0, f"ranks disagree by {agree}")
    say(f"dp EM ok, loglik={ll:.3f}, ranks agree")

    # --- 1b. data-parallel minibatch attention step ---
    state = attention.init(corpus, dim=32, generator=gen(0))
    mb = make_minibatch_step(attention.em_step, sharded, batch_size=n, mesh=mesh)
    state, st = mb(state, gen(1))
    loss = float(st["loss"])
    _expect(loss == loss, "minibatch loss is NaN")
    say(f"dp minibatch attention ok, loss={loss:.3f}")

    # --- 2. explicit per-shard EM through the kernels ---
    p_ref, s_ref = hmm.em_step(params, corpus)
    p_sm, s_sm = make_shard_map_em_step(hmm, mesh, count_kwargs={"use_kernels": True})(
        params, sharded)
    err = float((p_sm.log_emit - p_ref.log_emit).abs().max())
    _expect(err < 1e-3, f"per-shard EM through the kernels against one process: {err}")
    say(f"shard_map fused-kernel EM ok, loglik={float(s_sm['loglik']):.3f}, err={err:.2e}")

    # --- 3. bucketed EM over the mesh; a chunked E-step per shard ---
    _, lls = train_bucketed(hmm, params, corpus, [corpus.max_src_len // 2], 1, mesh=mesh)
    _expect(lls[0] == lls[0], "bucketed loglik is NaN")
    say(f"bucketed EM over mesh ok, loglik={lls[0]:.3f}")
    _, ll_c = all_sum(chunked_expected_counts(hmm, params, sharded, num_chunks=2), group)
    err = rel(ll_c, s_ref["loglik"])
    _expect(err < 1e-5, f"chunked-per-shard E-step loglik mismatch: {err}")
    say(f"chunked E-step per shard ok, loglik={float(ll_c):.3f}")

    # --- 4. minibatch CRF step with learned transitions ---
    fc, _, _ = phones_to_frames(corpus, gold, feat_dim=8, noise=0.1, seed=0, device=device)
    crf = hmm_crf.init_e2e(fc, hidden=16, n_sgd=2, generator=gen(2))
    crf_step = make_minibatch_step(functools.partial(hmm_crf.em_step, learn_transitions=True),
                                   shard_corpus(fc, mesh), batch_size=n, mesh=mesh)
    crf, crf_stats = crf_step(crf, gen(3))
    nll = float(crf_stats["nll_per_frame"])
    _expect(nll == nll, "CRF nll is NaN")
    say(f"dp minibatch CRF (e2e) ok, nll/frame={nll:.3f}")

    # --- 5. time-sharded forward and full E-step ---
    seq_mesh = make_mesh(n, "seq")
    ts = corpus.max_src_len
    ts_pad = -(-ts // n) * n
    corpus_p = dataclasses.replace(corpus, src=F.pad(corpus.src, (0, ts_pad - ts)))
    log_init, log_trans, log_emit = hmm._machinery(params, corpus_p)
    _, logz_fwd = forward_time_sharded(log_init, log_trans, log_emit, corpus.src_len, seq_mesh)
    gamma, xi, logz = estep_time_sharded(log_init, log_trans, log_emit, corpus.src_len,
                                         hmm_core.state_mask(corpus_p), seq_mesh)
    gamma_ref, width_ref, logz_ref = hmm_core.estep(params.log_jump, params.log_p0,
                                                    params.max_jump, log_emit, corpus_p,
                                                    use_kernels=False)
    lo = seq_mesh.get_local_rank() * (ts_pad // n)
    width = hmm_core.project_widths(xi, corpus_p.max_trg_len, params.max_jump)
    err = max(float((logz - logz_ref).abs().max()), float((logz_fwd - logz_ref).abs().max()),
              float((gamma - gamma_ref[:, lo:lo + ts_pad // n]).abs().max()),
              float((width - width_ref).abs().max()) / max(float(width_ref.max()), 1.0))
    _expect(err < 1e-2, f"time-sharded E-step mismatch: {err}")
    say(f"seq-parallel FULL E-step ok, err={err:.2e}")

    # --- 6. streaming EM over the mesh ---
    stream_dir = os.path.join(tmp, "stream")
    frames_dir = os.path.join(tmp, "frames")
    fc2, _, _ = phones_to_frames(corpus, gold, feat_dim=8, noise=0.1, seed=1, device=device)
    if dist.get_rank() == 0:
        write_shards(corpus, stream_dir, shard_size=n)
        write_shards(fc2, frames_dir, shard_size=n, shuffle=3)
    dist.barrier()
    reader = ShardedCorpusReader(stream_dir, device=device)
    _, lls_stream = train_streaming(hmm, hmm.init(corpus), reader, 2, mesh=mesh, prefetch=2)
    _, lls_res = hmm.train(hmm.init(corpus), corpus, 2)
    err = max(rel(a, b) for a, b in zip(lls_stream, lls_res.tolist()))
    _expect(err < 1e-5, f"streamed-over-mesh EM loglik mismatch: {err}")
    say(f"streamed EM over mesh ok, loglik={lls_stream[-1]:.3f}")

    # --- 7. the multi-rank bucketed EM and streamed minibatch trainer ---
    local = take_rows(corpus, *multihost.process_slice(corpus.n))
    _, lls_mh = multihost.train_bucketed_multihost(hmm, hmm.init(corpus), local,
                                                   [corpus.max_src_len // 2], 2, mesh=mesh)
    err = rel(lls_mh[-1], lls_res[-1])
    _expect(err < 1e-5, f"multihost-bucketed EM loglik mismatch: {err}")
    say(f"multihost bucketed EM ok, loglik={lls_mh[-1]:.3f}")
    att = attention.init(corpus, dim=16, generator=gen(4))
    _, losses = multihost.train_minibatch_streaming_multihost(
        attention.em_step, att, reader, batch_size=n, num_steps=3, seed=5, mesh=mesh)
    _expect(all(x == x for x in losses), f"streamed minibatch losses {losses}")
    say(f"streamed x distributed minibatch ok, loss={losses[-1]:.3f}")

    # --- 8. streamed annealed Gaussian EM over the mesh ---
    freader = ShardedCorpusReader(frames_dir, device=device)
    gp0 = hmm_gaussian.init(fc2, generator=gen(6))
    _, glls = train_streaming(hmm_gaussian, gp0, freader, 3, mesh=mesh,
                              scale_schedule=np.array([0.3, 0.65, 1.0]))
    _expect(all(x == x for x in glls), f"streamed Gaussian logliks {glls}")
    say(f"streamed annealed Gaussian EM over mesh ok, loglik={glls[-1]:.3f}")

    # --- 9. Model-1 and segmental k-means EM over the mesh ---
    m1 = model1.init(corpus)
    _, m1s_ref = model1.em_step(m1, corpus)
    _, m1s_sm = make_shard_map_em_step(model1, mesh)(m1, sharded)
    err = rel(m1s_sm["loglik"], m1s_ref["loglik"])
    _expect(err < 1e-5, f"model1 shard_map loglik mismatch: {err}")
    say(f"model1 shard_map EM ok, loglik={float(m1s_sm['loglik']):.3f}, err={err:.2e}")
    skm0 = segmental_kmeans.init(fc, n_clusters=8, generator=gen(7))
    _, skm_st = make_shard_map_em_step(segmental_kmeans, mesh)(skm0, shard_corpus(fc, mesh))
    _, skm_ref = segmental_kmeans.em_step(skm0, fc)
    err = rel(skm_st["loglik"], skm_ref["loglik"])
    _expect(err < 1e-5, f"segkmeans shard_map loglik mismatch: {err}")
    say(f"segmental-kmeans shard_map EM ok, loglik={float(skm_st['loglik']):.3f}, "
        f"err={err:.2e}")

    # --- 10. the multi-rank VQ-teacher recipe, then annealed EM ---
    gseed = multihost.init_vq_teacher_streaming_multihost(
        freader, os.path.join(tmp, "codes"), max_jump=3, n_components=2, generator=gen(10),
        n_codes=8, teacher_iters=2, seed_rounds=1, mesh=mesh)
    _, podlls = multihost.train_streaming_multihost(
        hmm_gaussian, gseed, freader, 2, mesh=mesh, scale_schedule=np.array([0.5, 1.0]))
    _expect(all(x == x for x in podlls), f"pod-scale recipe logliks {podlls}")
    say(f"pod-scale vq_teacher recipe (distributed seed + annealed EM) ok, "
        f"loglik={podlls[-1]:.3f}")
    g_state = grounding.init(corpus, dim=16, generator=gen(8))
    g_step = make_minibatch_step(grounding.em_step, sharded, batch_size=n, mesh=mesh)
    _, g_stats = g_step(g_state, gen(9))
    g_loss = float(g_stats["loss"])
    _expect(g_loss == g_loss, "grounding loss is NaN")
    say(f"dp minibatch grounding ok, loss={g_loss:.3f}")
    return lines


def run(n: int, device="cuda", store_dir=None) -> list[str]:
    """Spawn ``n`` ranks on ``device``, run the compositions, return the
    line naming the device and backend, then rank 0's lines.  The backend:
    gloo on the CPU; on CUDA NCCL when ``n`` is at most the card count,
    else gloo (NCCL refuses two ranks on one card)."""
    from multimodalworddiscovery_tpu_torch.parallel.multihost import spawn

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun on device 'cuda' on a host without CUDA; pass --device cpu")
    backend = "nccl" if kind == "cuda" and n <= torch.cuda.device_count() else "gloo"
    head = f"dryrun_multichip({n}): {n} ranks on {kind} over {backend}"
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        return [head] + spawn(compositions, n, (n, kind, tmp), device=kind, backend=backend,
                              store_dir=store_dir)[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="number of ranks")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    for line in run(args.n, args.device):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
