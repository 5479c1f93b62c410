"""The port's data-parallel layer (core/mesh, core/collectives,
parallel/data_parallel, the mesh forms of models/minibatch, the gradient
all-reduce of the minibatch steps, parallel/dryrun) on local gloo worlds of
2 and 4 CPU ranks, against the JAX package's single-device steps and the
port's single-process ones.

Each world runs every scenario in one spawn (tests/torch_parallel_workers.py)
and the tests assert on its ranks' results.  Bounds, and why:

- data-parallel EM against the JAX package's single-device ``em_step``
  (tests/test_parallel.py:17-57, :220): loglik rtol 1e-5; Model-1's log_t
  rtol / atol 1e-4; the HMM's log_emit / log_jump rtol / atol 1e-3 (the
  reference's bounds); the Gaussian HMM's parameters rtol / atol 1e-4;
  segmental k-means' centroids atol 1e-4.  Against the port's own
  single-process step: rtol 1e-5 (only the addition order differs);
- outputs on every rank: equal bit for bit (one all_reduce gives every rank
  the same sums; the M-step is deterministic);
- a gradient step of W ranks on B/W rows each against one process on the B
  rows: parameters and Adam moments rtol 1e-5, atol 1e-6 (a weight whose
  gradient is rounding noise: within its steps of the learning rate, see
  ``torch_parallel_workers.close_weights``); statistics rtol 1e-5, atol 1e-6
  (the CRF's nll per frame is a sum of O(1) terms that cancels to 4e-3);
- the same W-rank step against the JAX package's single-device ``em_step``
  on the same B rows (attention and grounding start from the JAX package's
  initial flax trees, the CRF's port parameters cross over through
  tests/crf_reference.py): the model's weights by the same rule, the
  rounding-noise weights read from the JAX step's second moments; the
  CRF's transitions and the statistics rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as w
from crf_reference import to_jax as crf_to_jax
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.corpus import Corpus as JCorpus
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import attention as jatt
from multimodalworddiscovery_tpu.models import grounding as jgr
from multimodalworddiscovery_tpu.models import hmm as jhmm
from multimodalworddiscovery_tpu.models import hmm_crf as jcrf
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models import model1 as jm1
from multimodalworddiscovery_tpu.models import segmental_kmeans as jskm
from multimodalworddiscovery_tpu_torch.core import collectives
from multimodalworddiscovery_tpu_torch.core.mesh import check_mesh, make_mesh, pad_to_multiple
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.models import (
    attention,
    flax_params,
    grounding,
    hmm,
    hmm_gaussian,
    model1,
    segmental_kmeans,
)
from multimodalworddiscovery_tpu_torch.models import minibatch as mb
from multimodalworddiscovery_tpu_torch.parallel import dryrun
from multimodalworddiscovery_tpu_torch.parallel.multihost import spawn

G_FIELDS = ("means", "log_vars", "log_mix", "log_jump", "log_p0")
EM = ("model1", "hmm", "hmm_gaussian", "segmental_kmeans")


@pytest.fixture(scope="module")
def jax_frames_corpus():
    jc, jgold, _ = jax_make(**w.FRAMES_CORPUS)
    return jax_frames(jc, jgold, **w.FRAMES)[0]


@pytest.fixture(scope="module")
def gauss_np(jax_frames_corpus):
    """The Gaussian scenario's initial parameters: the JAX package's init."""
    jp = jg.init(jax_frames_corpus, key=jax.random.PRNGKey(0))
    return {f: np.asarray(getattr(jp, f)) for f in G_FIELDS} | {"max_jump": jp.max_jump}


@pytest.fixture(scope="module")
def mb_jax():
    """The JAX package's initial attention and grounding states on the
    minibatch corpus, and their flax trees as numpy arrays for the ranks."""
    jc, _, _ = jax_make(**w.MB_CORPUS)
    states = {"attention": jatt.init(jc, dim=16, key=jax.random.PRNGKey(0)),
              "grounding": jgr.init(jc, dim=16, key=jax.random.PRNGKey(0))}
    return states, {k: jax.tree.map(np.asarray, v.params) for k, v in states.items()}


@pytest.fixture(scope="module", params=[2, 4], ids=["W2", "W4"])
def world(request, tmp_path_factory, gauss_np, mb_jax):
    return spawn(w.parallel_world, request.param, (gauss_np, mb_jax[1]), device="cpu",
                 timeout=300,
                 store_dir=tmp_path_factory.mktemp(f"store{request.param}"))


def _jax_em(name, gauss_np, jax_frames_corpus):
    """The JAX package's single-device em_step on the scenario's corpus ->
    (parameters by field, loglik)."""
    if name in ("model1", "hmm"):
        jmod = {"model1": jm1, "hmm": jhmm}[name]
        jc, _, _ = jax_make(**w.DP_CORPORA[name])
        jp, st = jax.jit(jmod.em_step)(jmod.init(jc), jc)
    elif name == "hmm_gaussian":
        jp0 = jg.GaussianHMMParams(**{f: jnp.asarray(gauss_np[f]) for f in G_FIELDS},
                                   max_jump=gauss_np["max_jump"])
        jp, st = jax.jit(jg.em_step)(jp0, jax_frames_corpus)
    else:
        p0 = segmental_kmeans.init(w.frames_corpus(), n_clusters=8, generator=w.gen(0))
        jp, st = jax.jit(jskm.em_step)(jskm.SegKMeansParams(
            centroids=jnp.asarray(p0.centroids.numpy())), jax_frames_corpus)
    fields = {"model1": ("log_t",), "hmm": ("log_emit", "log_jump"), "hmm_gaussian": G_FIELDS,
              "segmental_kmeans": ("centroids",)}[name]
    return {f: np.asarray(getattr(jp, f)) for f in fields}, float(st["loglik"])


@pytest.mark.parametrize("name", EM)
def test_data_parallel_em_matches_jax(world, name, gauss_np, jax_frames_corpus):
    got = world[0]["em"][name]
    n = (w.FRAMES_CORPUS if name in ("hmm_gaussian", "segmental_kmeans")
         else w.DP_CORPORA[name])["n_utterances"]
    assert got["n_local"] * len(world) == pad_to_multiple(n, len(world))
    want, ll = _jax_em(name, gauss_np, jax_frames_corpus)
    np.testing.assert_allclose(float(got["loglik"]), ll, rtol=1e-5)
    tol = {"model1": dict(rtol=1e-4, atol=1e-4), "hmm": dict(rtol=1e-3, atol=1e-3),
           "hmm_gaussian": dict(rtol=1e-4, atol=1e-4),
           "segmental_kmeans": dict(rtol=0, atol=1e-4)}[name]
    for f, v in want.items():
        np.testing.assert_allclose(got["params"][f], v, err_msg=f, **tol)


def _port_single(name, gauss_np):
    """The port's single-process em_step on the scenario's corpus."""
    if name == "hmm_gaussian":
        fc = w.frames_corpus()
        return hmm_gaussian.em_step(hmm_gaussian.params_from_numpy(**gauss_np, device="cpu"), fc)
    if name == "segmental_kmeans":
        fc = w.frames_corpus()
        return segmental_kmeans.em_step(
            segmental_kmeans.init(fc, n_clusters=8, generator=w.gen(0)), fc)
    corpus, _, _ = torch_make(**w.DP_CORPORA["hmm" if name.startswith("hmm") else name],
                              device="cpu")
    if name == "model1":
        return model1.em_step(model1.init(corpus), corpus)
    kw = {"hmm": {}, "hmm_shard_map_kernels": {"use_kernels": True},
          "hmm_partial": {"smoothing": 1e-6, "use_kernels": True}}[name]
    return hmm.em_step(hmm.init(corpus), corpus, **kw)


@pytest.mark.parametrize("name", EM + ("hmm_shard_map_kernels", "hmm_partial"))
def test_data_parallel_em_matches_one_process(world, name, gauss_np):
    """The explicit per-shard step (through the kernels' plain versions
    where asked) and a partial of em_step equal the port's single-process
    step up to addition order."""
    got = world[0]["em"][name]
    p, st = _port_single(name, gauss_np)
    np.testing.assert_allclose(float(got["loglik"]), float(st["loglik"]), rtol=1e-5)
    for f, v in w.fields_np(p).items():
        np.testing.assert_allclose(got["params"][f], v, rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("kind", ["em", "steps"])
def test_outputs_identical_on_every_rank(world, kind):
    for name, r0 in world[0][kind].items():
        if "disagree" in r0:
            assert r0["disagree"] == 0.0, name
        for other in world[1:]:
            got = other[kind][name]["params"]
            pairs = (zip(r0["params"].values(), got.values()) if isinstance(got, dict)
                     else zip(r0["params"], got))
            assert all(np.array_equal(a, b) for a, b in pairs), name


def _mb_inputs(name, trees):
    """(fresh initial state, corpus) of a minibatch scenario."""
    corpus, _, _ = torch_make(**w.MB_CORPUS, device="cpu")
    fc = w.mb_frames(corpus)
    return w.mb_states(fc, trees)[name], fc if name == "crf" else corpus


def _one_process_step(name, trees, batch_rows=None, sample=None):
    """The step on the B rows in one process (a fresh state each call) ->
    ((state, stats), the batch it took)."""
    state, c = _mb_inputs(name, trees)
    if sample is None:
        batch = mb.gather_batch(c, torch.tensor(batch_rows))
        return w.MB_STEPS[name](state, batch), batch
    taken = []

    def recorded(state, batch):
        taken.append(batch)
        return w.MB_STEPS[name](state, batch)

    out = mb.make_minibatch_step(recorded, c, len(w.MB_ROWS), sample=sample)(state, w.gen(5))
    return out, taken[0]


def _close_step(name, got, want):
    """Parameters, Adam moments and statistics of the W-rank step against
    the one-process step (``torch_parallel_workers.close_state``)."""
    new, stats = want
    model = new.mlp if name == "crf" else new.model
    adam = new.opt_state["mlp"] if name == "crf" else new.opt_state
    assert len(list(model.parameters())) == len(adam.nu)
    w.close_state(got["params"], new, adam, getattr(new, "n_sgd", 1))
    for k, v in stats.items():
        np.testing.assert_allclose(got["stats"][k], v.detach().numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def jax_corpus(c) -> JCorpus:
    """A port corpus (on the CPU) as the JAX package's."""
    return JCorpus(src=jnp.asarray(c.src.numpy()), src_len=jnp.asarray(c.src_len.numpy()),
                   trg=jnp.asarray(c.trg.numpy()), trg_len=jnp.asarray(c.trg_len.numpy()),
                   src_vocab=c.src_vocab, trg_vocab=c.trg_vocab)


def _close_to_jax(name, got, batch, mb_jax):
    """The W-rank step against the JAX package's single-device em_step on
    the same rows: the model's weights by ``close_weights`` (the second
    moments from the JAX step), the CRF's transitions and the statistics
    rtol 1e-5, atol 1e-6."""
    state, _ = _mb_inputs(name, mb_jax[1])
    jb = jax_corpus(batch)
    if name == "crf":
        js, jstats = jcrf.em_step(crf_to_jax(state, e2e=True), jb, learn_transitions=True)
        layers = js.mlp["params"]
        nus = js.opt_state.inner_states["mlp"].inner_state[0].nu[0]["params"]  # (mlp, -, -)

        def torch_order(tree):
            return [a for i in range(len(tree))
                    for a in (np.asarray(tree[f"Dense_{i}"]["kernel"]).T,
                              np.asarray(tree[f"Dense_{i}"]["bias"]))]

        want, nu, steps = torch_order(layers), torch_order(nus), state.n_sgd
        for f in ("log_jump", "log_p0", "log_prior"):
            np.testing.assert_allclose(got["fields"][f], np.asarray(getattr(js, f)), rtol=1e-5,
                                       atol=1e-6, err_msg=f)
    else:
        jmod = {"attention": jatt, "grounding": jgr}[name]
        js, jstats = jax.jit(jmod.em_step)(mb_jax[0][name], jb)
        names = (attention._FLAX_NAMES if name == "attention"
                 else grounding._flax_names(state.model))

        def load(tree):
            return flax_params.load_flax_tree(state.model, jax.tree.map(np.asarray, tree),
                                              names, "cpu")

        want, nu, steps = load(js.params), load(js.opt_state[0].nu), 1
    w.close_weights(got["params"][:len(want)], want, nu, steps, state.learning_rate)
    assert set(got["stats"]) == set(jstats)
    for k, v in jstats.items():
        np.testing.assert_allclose(got["stats"][k], np.asarray(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["attention", "grounding", "crf"])
def test_gradient_step_equals_one_process(world, name, mb_jax):
    """W ranks with B/W rows each take the step one process takes on the B
    rows: the normalisers are global, grounding's impostors are the whole
    batch, the CRF's transitions learn from the global gradient."""
    _close_step(name, world[0]["steps"][name], _one_process_step(name, mb_jax[1], w.MB_ROWS)[0])


@pytest.mark.parametrize("name", ["attention", "grounding", "crf"])
def test_gradient_step_matches_jax(world, name, mb_jax):
    """The W-rank step is the JAX package's single-device step on the B rows."""
    _, batch = _one_process_step(name, mb_jax[1], w.MB_ROWS)
    _close_to_jax(name, world[0]["steps"][name], batch, mb_jax)


SAMPLED = [("attention", "global"), ("attention", "valid"), ("grounding", "global"),
           ("crf", "global")]


@pytest.mark.parametrize("name,sample", SAMPLED)
def test_sampled_step_equals_one_process(world, name, sample, mb_jax):
    """make_minibatch_step under the mesh draws the single-process batch
    (one generator seed on every rank; each rank takes the rows it holds)."""
    _close_step(name, world[0]["steps"][f"{name}_{sample}"],
                _one_process_step(name, mb_jax[1], sample=sample)[0])


@pytest.mark.parametrize("name,sample", SAMPLED)
def test_sampled_step_matches_jax(world, name, sample, mb_jax):
    """The sampled W-rank step is the JAX package's single-device step on
    the rows the single-process sampler draws."""
    _, batch = _one_process_step(name, mb_jax[1], sample=sample)
    _close_to_jax(name, world[0]["steps"][f"{name}_{sample}"], batch, mb_jax)


def test_sample_local_batch(world):
    """Each rank draws its share of its own rows, never a padding row while
    it holds enough real ones, and the reference's errors stand."""
    for r in world:
        loc = r["local"]
        for share, d in loc["draws"].items():
            assert d["n"] == share
            assert d["padding"] == max(0, share - loc["real"])
        assert loc["draws"][loc["n_local"]]["n"] == loc["n_local"]
    assert not np.array_equal(world[0]["local"]["draws"][3]["rows"],
                              world[1]["local"]["draws"][3]["rows"])
    errs = world[0]["local"]["errors"]
    assert errs["indivisible"].startswith("ValueError") and "not divisible" in errs["indivisible"]
    assert errs["too_big"].startswith("ValueError") and "exceeds" in errs["too_big"]
    assert errs["batch_indivisible"].startswith("ValueError")


def test_mesh_errors(world):
    errs = world[0]["local"]["errors"]
    assert errs["step_without_mesh_param"].startswith("TypeError")
    assert errs["closed_form_only"].startswith("TypeError")
    assert errs["too_many_devices"].startswith("ValueError")
    if len(world) == 4:  # the mesh over ranks 0 and 1 sums over them only
        assert [int(r["sub_mesh_sum"]) for r in world[:2]] == [3, 3]
    assert all("sub_mesh_sum" not in r for r in world[2:])


def test_mesh_needs_a_process_group():
    """No process group: make_mesh raises; a non-mesh is a TypeError; the
    collectives are the identity without a group."""
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    with pytest.raises(TypeError, match="DeviceMesh"):
        check_mesh(object())
    x = {"a": torch.ones(2), "b": (torch.zeros(()),)}
    assert collectives.all_sum(x, None) is x
    assert collectives.gather(torch.ones(3), None).shape == (1, 3)
    assert collectives.max_disagreement(x, None) == 0.0


def test_dryrun_two_ranks(tmp_path):
    """parallel/dryrun.py at n=2 on gloo: every composition reports ok."""
    lines = dryrun.run(2, device="cpu", store_dir=tmp_path)
    assert lines[0] == "dryrun_multichip(2): 2 ranks on cpu over gloo"
    for what in ("dp EM ok", "dp minibatch attention ok", "shard_map fused-kernel EM ok",
                 "bucketed EM over mesh ok", "chunked E-step per shard ok",
                 "dp minibatch CRF (e2e) ok", "seq-parallel FULL E-step ok",
                 "streamed EM over mesh ok", "multihost bucketed EM ok",
                 "streamed x distributed minibatch ok",
                 "streamed annealed Gaussian EM over mesh ok", "model1 shard_map EM ok",
                 "segmental-kmeans shard_map EM ok", "pod-scale vq_teacher recipe",
                 "dp minibatch grounding ok"):
        assert any(line.startswith(f"dryrun_multichip(2): {what}") for line in lines), what
