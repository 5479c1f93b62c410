"""The port's fixed-order count reductions against the JAX package, on the CPU.

On a CUDA tensor a float ``index_add_`` / ``scatter_add_`` adds with
atomics whose order, and so whose sums' last bits, change from run to run.
The port's EM statistics therefore sum by ``core.counts.segment_sum`` and
``pool_columns`` (one-hot products a chunk at a time), and
``select_columns`` pools its gradient back the same way.  Each replaced
site takes the same numpy-seeded inputs as its JAX function; both sides sum
the same float32 terms in another order, so they agree within rtol 1e-6,
atol 1e-6 x the largest value.  The scatter each site replaced, run here on
the CPU, is a second oracle at the same tolerance.  A source scan keeps
float scatter-adds out of the EM glue, except at the sites that add only 0s
and 1s (exact integer sums in any order).
"""

import ast
import contextlib
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from crf_reference import corpora, port_init, to_jax
from multimodalworddiscovery_tpu.core import counts as jcounts
from multimodalworddiscovery_tpu.data import make_flickr8k_mini as jax_make
from multimodalworddiscovery_tpu.data.synthetic import phones_to_frames as jax_frames
from multimodalworddiscovery_tpu.models import hmm_core as jcore
from multimodalworddiscovery_tpu.models import hmm_crf as jcrf
from multimodalworddiscovery_tpu.models import hmm_dnn as jd
from multimodalworddiscovery_tpu.models import hmm_gaussian as jg
from multimodalworddiscovery_tpu.models import segmental_kmeans as jskm
from multimodalworddiscovery_tpu_torch.core import counts as tcounts
from multimodalworddiscovery_tpu_torch.data import make_flickr8k_mini as torch_make
from multimodalworddiscovery_tpu_torch.data import phones_to_frames as torch_frames
from multimodalworddiscovery_tpu_torch.models import hmm_core as tcore
from multimodalworddiscovery_tpu_torch.models import hmm_crf as tcrf
from multimodalworddiscovery_tpu_torch.models import hmm_dnn as td
from multimodalworddiscovery_tpu_torch.models import hmm_gaussian as tg
from multimodalworddiscovery_tpu_torch.models import segmental_kmeans as tskm

GEN = dict(n_utterances=24, seed=7)
FRAMES = dict(feat_dim=8, seed=7)
PKG = pathlib.Path(__file__).resolve().parents[1] / "multimodalworddiscovery_tpu_torch"


def _close(got, want, what=""):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale, err_msg=what)


@pytest.fixture(scope="module")
def frames():
    """(JAX frame corpus, port frame corpus, gold alignment), from one seed."""
    pc_j, pg_j, _ = jax_make(**GEN)
    pc_t, pg_t, _ = torch_make(**GEN, device="cpu")
    jc, jgold, _ = jax_frames(pc_j, pg_j, **FRAMES)
    tc, _, _ = torch_frames(pc_t, pg_t, **FRAMES, device="cpu")
    return jc, tc, np.asarray(jgold.alignment)


def _gamma(corpus, seed):
    """Posterior-like [N, Ts, S] weights, 0 on padding, for ``corpus``."""
    s = tcore.state_concepts(corpus).shape[1]
    rng = np.random.default_rng(seed)
    g = rng.random((corpus.n, corpus.max_src_len, s)).astype(np.float32)
    g *= corpus.src_mask().numpy()[:, :, None]
    return g / np.maximum(g.sum(axis=2, keepdims=True), 1e-30)


@pytest.mark.parametrize("tt_max,max_jump", [(7, 3), (13, 1), (64, 64)])
def test_project_widths_matches_jax(tt_max, max_jump):
    s = 2 * tt_max
    xi = np.random.default_rng(tt_max).random((s, s)).astype(np.float32)
    want = np.asarray(jcore.project_widths(jnp.asarray(xi), tt_max, max_jump))
    got = tcore.project_widths(torch.as_tensor(xi), tt_max, max_jump)
    _close(got, want, "project_widths vs JAX")
    ids = tcore.jump_width_ids(tt_max, max_jump).reshape(-1)
    old = torch.zeros(2 * max_jump + 3).index_add_(0, ids, torch.as_tensor(xi).reshape(-1))
    _close(got, old.numpy(), "project_widths vs the scatter it replaced")


def test_teacher_responsibilities_matches_jax(frames):
    jc, tc, _ = frames
    g = _gamma(tc, 1)
    want = np.asarray(jg.teacher_responsibilities(jnp.asarray(g), jc))
    got = tg.teacher_responsibilities(torch.as_tensor(g), tc)
    _close(got, want, "teacher_responsibilities vs JAX")
    n, ts, s = g.shape
    conc = tcore.state_concepts(tc).long()[:, None, :].expand(n, ts, s)
    old = torch.zeros((n, ts, tc.trg_vocab)).scatter_add_(2, conc, torch.as_tensor(g))
    _close(got, old.numpy(), "teacher_responsibilities vs the scatter it replaced")


def test_frame_posteriors_pooling_matches_jax():
    """The DNN-HMM's E-step core from the same parameters: the pooled r
    against JAX's one-hot einsum of the port's own gamma (the E-steps of the
    two packages differ by their own float32 order, which
    ``test_torch_hmm_dnn`` bounds), and against the scatter it replaced."""
    _, _, tfc = corpora(dict(n_utterances=12, seed=31), dict(feat_dim=8, noise=0.1, seed=31))
    tp = port_init(tfc, False, dict(max_jump=3, hidden=32, learning_rate=1e-3, n_sgd=3))
    r, _, _ = td.frame_posteriors(tp, tfc)
    concepts = tcore.state_concepts(tfc)
    log_emit = tcounts.select_columns(td._concept_loglik(tp, tfc), concepts)
    gamma = tcore.estep(tp.log_jump, tp.log_p0, tp.max_jump, log_emit, tfc)[0]
    onehot = jax.nn.one_hot(jnp.asarray(concepts.numpy()), tfc.trg_vocab, dtype=jnp.float32)
    want = np.asarray(jnp.einsum("nts,nsc->ntc", jnp.asarray(gamma.numpy()), onehot,
                                 precision=jax.lax.Precision.HIGHEST))
    _close(r, want, "frame_posteriors' r vs JAX's pooling")
    n, ts, s = gamma.shape
    old = torch.zeros_like(r).scatter_add_(2, concepts.long()[:, None, :].expand(n, ts, s), gamma)
    _close(r, old.numpy(), "frame_posteriors' r vs the scatter it replaced")


def test_frame_posteriors_matches_jax_end_to_end():
    """The whole function in both packages from one parameter set, at the
    DNN-HMM tests' bound (the E-steps sum in their own orders)."""
    fc, _, tfc = corpora(dict(n_utterances=12, seed=31), dict(feat_dim=8, noise=0.1, seed=31))
    tp = port_init(tfc, False, dict(max_jump=3, hidden=32, learning_rate=1e-3, n_sgd=3))
    r_j, _, _ = jd.frame_posteriors(to_jax(tp), fc)
    r, _, _ = td.frame_posteriors(tp, tfc)
    want = np.asarray(r_j)
    np.testing.assert_allclose(r.numpy(), want, rtol=1e-4, atol=1e-5 * float(want.max()))


def test_transition_moments_matches_jax(frames):
    jc, tc, _ = frames
    max_jump = 3
    rng = np.random.default_rng(2)
    g = _gamma(tc, 2)
    wc = rng.random(2 * max_jump + 3).astype(np.float32) * 50
    lj = np.log(rng.random(2 * max_jump + 1) + 0.1).astype(np.float32)
    lp0 = np.float32(-1.3)
    # the reference computes them in logmarginal_e2e's backward, with ct = 1
    res = (jnp.asarray(g), jnp.asarray(wc), jnp.asarray(lj), jnp.asarray(lp0), jc)
    want = jcrf._e2e_bwd(max_jump, False, "float32", res, jnp.float32(1.0))
    got = tcrf._transition_moments(torch.as_tensor(g), torch.as_tensor(wc), torch.as_tensor(lj),
                                   torch.tensor(lp0), tc, max_jump)
    _close(got[0], want[0], "d log_jump vs JAX")
    _close(got[1], want[1], "d log_p0 vs JAX")


def _gauss_params(jc):
    jp = jg.init(jc, n_components=2, key=jax.random.PRNGKey(0), max_jump=3)
    fields = ("means", "log_vars", "log_mix", "log_jump", "log_p0")
    tp = tg.params_from_numpy(*(np.asarray(getattr(jp, f)) for f in fields), jp.max_jump,
                              device="cpu")
    return jp, tp


def test_supervised_counts_matches_jax(frames):
    jc, tc, gold = frames
    jp, tp = _gauss_params(jc)
    want = jg.supervised_counts(jp, jc, jnp.asarray(gold))
    got = tg.supervised_counts(tp, tc, torch.as_tensor(gold))
    assert set(got) == set(want)
    for k in want:
        _close(got[k], want[k], f"supervised_counts[{k!r}] vs JAX")


@pytest.mark.parametrize("with_diagonal", [True, False])
def test_init_moments_matches_jax(frames, with_diagonal):
    jc, tc, _ = frames
    want = jg.init_moments(jc, shift=0.5, with_diagonal=with_diagonal)
    got = tg.init_moments(tc, shift=0.5, with_diagonal=with_diagonal)
    for k in want:
        _close(got[k], want[k], f"init_moments[{k!r}] vs JAX")


def test_kmeans_fit_matches_jax(frames):
    """Two Lloyd sweeps from one initial codebook, against JAX's one-hot
    sweeps and against the scatter-add sweeps the port ran before."""
    _, tc, _ = frames
    flat = tc.src.reshape(-1, tc.src.shape[-1])
    wflat = tc.src_mask().reshape(-1).float()
    cb0 = flat[torch.nonzero(wflat)[::7, 0][:16]].clone()
    want = jg._kmeans_fit(jnp.asarray(cb0.numpy()), jnp.asarray(flat.numpy()),
                          jnp.asarray(wflat.numpy()), n_codes=16, num_iterations=2)
    got = tg._kmeans_fit(cb0, flat, wflat, 2)
    _close(got, want, "_kmeans_fit vs JAX")
    cb = cb0
    for _ in range(2):
        a = tg._kmeans_assign(cb, flat)
        sums = torch.zeros_like(cb).index_add_(0, a, flat * wflat[:, None])
        cnt = torch.zeros(16).index_add_(0, a, wflat)
        cb = torch.where(cnt[:, None] > 0, sums / torch.clamp(cnt, min=1.0)[:, None], cb)
    _close(got, cb.numpy(), "_kmeans_fit vs the scatter sweeps it replaced")


def test_segmental_kmeans_update_matches_jax(frames):
    """One ES-KMeans E-step from the JAX init's centroids: the per-cluster
    sums and counts against JAX and against the scatters they replaced."""
    jc, tc, _ = frames
    jp = jskm.init(jc, n_clusters=16, min_seg_len=1, key=jax.random.PRNGKey(0))
    tp = tskm.params_from_numpy(np.asarray(jp.centroids), n_samples=jp.n_samples,
                                max_seg_len=jp.max_seg_len, min_seg_len=jp.min_seg_len,
                                device="cpu")
    (j_sums, j_counts, j_n), _ = jskm.expected_counts(jp, jc)
    (sums, counts, n_seg), _ = tskm.expected_counts(tp, tc)
    assert int(n_seg) == int(j_n)
    _close(sums, j_sums, "segment sums vs JAX")
    _close(counts, j_counts, "segment counts vs JAX")
    assert torch.equal(counts, counts.round())


def test_select_columns_gradient_pools_back():
    """select_columns' gradient (pool_columns) against JAX's VJP of its
    select_columns and against torch.gather's own scatter backward."""
    rng = np.random.default_rng(4)
    values = rng.normal(size=(5, 9, 11)).astype(np.float32)
    ids = rng.integers(0, 11, (5, 6)).astype(np.int32)
    ids[:, :3] = 0  # null states share concept 0
    ct = rng.normal(size=(5, 9, 6)).astype(np.float32)
    _, vjp = jax.vjp(lambda v: jcounts.select_columns(v, jnp.asarray(ids)), jnp.asarray(values))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    v = torch.as_tensor(values).requires_grad_()
    out = tcounts.select_columns(v, torch.as_tensor(ids))
    _close(out, np.take_along_axis(values, ids[:, None, :].repeat(9, 1).astype(np.int64), 2))
    (got,) = torch.autograd.grad(out, v, torch.as_tensor(ct))
    _close(got, want, "select_columns' gradient vs JAX")
    v2 = torch.as_tensor(values).requires_grad_()
    idx = torch.as_tensor(ids).long()[:, None, :].expand(5, 9, 6)
    (old,) = torch.autograd.grad(torch.gather(v2, 2, idx), v2, torch.as_tensor(ct))
    _close(got, old.numpy(), "select_columns' gradient vs torch.gather's scatter")


def test_chunked_forms_match_one_chunk(monkeypatch):
    """segment_sum and pool_columns over many chunks (ONEHOT_ELEMENTS cut
    to a few rows) against one chunk, with and without a gradient."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.normal(size=(301, 4)).astype(np.float32))
    ids = torch.as_tensor(rng.integers(0, 7, 301))
    g = torch.as_tensor(rng.random((10, 5, 6)).astype(np.float32))
    cols = torch.as_tensor(rng.integers(0, 8, (10, 6)))
    one = tcounts.segment_sum(x, ids, 7), tcounts.pool_columns(g, cols, 8)
    monkeypatch.setattr(tcounts, "ONEHOT_ELEMENTS", 100)
    _close(tcounts.segment_sum(x, ids, 7), one[0].numpy(), "segment_sum in chunks")
    _close(tcounts.segment_sum(x[:, 0], ids, 7), one[0][:, 0].numpy(), "1-D segment_sum")
    assert torch.equal(tcounts.pool_columns(g, cols, 8), one[1])
    assert torch.equal(tcounts.pool_columns(g.requires_grad_(), cols, 8), one[1])
    assert tcounts.pool_columns(g[:0], cols[:0], 8).shape == (0, 5, 8)


# Float scatter-adds that may stay: they add only 0s and 1s, so their
# sums are exact integers in any order of the card's atomics.
ZERO_ONE_SITES = {
    ("models/model1.py", "_count_stats"): 2,
    ("eval/metrics.py", "purity_counts"): 1,
}
SCANNED = ("models", "eval", "frontend", "parallel")


def _scatter_adds(tree):
    """(enclosing function, line) of each float-accumulating scatter call."""
    found = []

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            name = fn
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if isinstance(child, ast.Call) and isinstance(child.func, ast.Attribute):
                attr = child.func.attr
                kw = {k.arg: k.value for k in child.keywords}
                consts = [a.value for a in child.args if isinstance(a, ast.Constant)]
                reduce = kw.get("reduce")
                if (attr in ("index_add_", "index_add", "scatter_add_", "scatter_add")
                        or (attr in ("scatter_reduce", "scatter_reduce_")
                            and ("sum" in consts or "mean" in consts
                                 or (isinstance(reduce, ast.Constant)
                                     and reduce.value in ("sum", "mean"))))
                        or (attr == "bincount" and "weights" in kw)
                        or (attr in ("index_put_", "index_put", "put_")
                            and isinstance(kw.get("accumulate"), ast.Constant)
                            and kw["accumulate"].value is True)):
                    found.append((name, child.lineno))
            visit(child, name)

    visit(tree, None)
    return found


def test_no_float_scatter_adds_in_the_em_glue():
    seen = {}
    bad = []
    for sub in SCANNED:
        for path in sorted((PKG / sub).rglob("*.py")):
            rel = path.relative_to(PKG).as_posix()
            for fn, line in _scatter_adds(ast.parse(path.read_text())):
                if (rel, fn) in ZERO_ONE_SITES:
                    seen[(rel, fn)] = seen.get((rel, fn), 0) + 1
                else:
                    bad.append(f"{rel}:{line} in {fn}")
    assert not bad, f"float scatter-adds outside the 0/1 sites: {bad}"
    assert seen == ZERO_ONE_SITES


def test_scan_finds_each_form():
    """The scan's own check: each accumulating form is found, a max
    reduction and a plain gather are not."""
    src = """
def f(x, i, v, w):
    x.index_add_(0, i, v)
    x.scatter_add_(1, i, v)
    x.scatter_reduce(1, i, v, "sum")
    x.scatter_reduce(1, i, v, reduce="mean")
    torch.bincount(i, weights=w)
    x.index_put_((i,), v, accumulate=True)
    x.scatter_reduce(1, i, v, "amax")
    torch.bincount(i)
    x.gather(1, i)
"""
    assert [line for _, line in _scatter_adds(ast.parse(src))] == [3, 4, 5, 6, 7, 8]


# ---------------------------------------------------------------------------
# the gradient steps: the embeddings' fixed-order backward and the scoped
# deterministic convolutions
# ---------------------------------------------------------------------------


def _embed_case(seed, v=11, d=6, shape=(4, 9)):
    """(weight [v, d], ids of ``shape`` with repeats, that never use the
    last two rows, output gradient)."""
    rng = np.random.default_rng(seed)
    weight = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v - 2, shape).astype(np.int32)
    ids.flat[:3] = 0  # a row repeated within and across utterances
    ct = rng.normal(size=shape + (d,)).astype(np.float32)
    return weight, ids, ct


def _autograd_embedding(weight, ids):
    return torch.nn.functional.embedding(ids, weight)


def _embed_grad(fn, weight, ids, ct):
    w = torch.as_tensor(weight).requires_grad_()
    out = fn(w, torch.as_tensor(ids))
    (grad,) = torch.autograd.grad(out, w, torch.as_tensor(ct))
    return out, grad


@pytest.mark.parametrize("shape", [(4, 9), (37,), (3, 5, 7), (0, 9)])
def test_embed_rows_gradient_matches_jax_and_autograd(shape):
    """embed_rows: the forward equal to the index gather, the weight's
    gradient against jax.grad of jnp.take and against F.embedding's
    autograd (repeated ids, rows no id uses: exactly 0; an empty batch, a
    data-parallel rank's share of a small batch: all 0)."""
    weight, ids, ct = _embed_case(len(shape), shape=shape)
    out, got = _embed_grad(tcounts.embed_rows, weight, ids, ct)
    assert torch.equal(out, torch.as_tensor(weight)[torch.as_tensor(ids).long()])
    _, vjp = jax.vjp(lambda w: jnp.take(w, jnp.asarray(ids), axis=0), jnp.asarray(weight))
    _close(got, vjp(jnp.asarray(ct))[0], "embed_rows' gradient vs JAX")
    _, old = _embed_grad(_autograd_embedding, weight, ids, ct)
    _close(got, old.numpy(), "embed_rows' gradient vs F.embedding's autograd")
    assert not got[-2:].any()


def test_embed_rows_chunked_gives_one_chunks_bits(monkeypatch):
    """Many chunks (ONEHOT_ELEMENTS cut to a few rows) against one chunk and
    against autograd's scatter, on gradients in multiples of 1/8, whose
    sums are exact in float32 in any order: equal bits."""
    weight, ids, ct = _embed_case(9, shape=(6, 23))
    ct = np.round(ct * 8) / 8
    _, one = _embed_grad(tcounts.embed_rows, weight, ids, ct)
    monkeypatch.setattr(tcounts, "ONEHOT_ELEMENTS", 40)
    _, chunked = _embed_grad(tcounts.embed_rows, weight, ids, ct)
    _, old = _embed_grad(_autograd_embedding, weight, ids, ct)
    assert torch.equal(chunked, one)
    assert torch.equal(chunked, old)


def test_fixed_order_embedding_is_an_embedding():
    """FixedOrderEmbedding keeps nn.Embedding's parameter and state dict
    (so flax trees and checkpoints map onto it) and looks up by
    embed_rows."""
    from multimodalworddiscovery_tpu_torch.core.determinism import FixedOrderEmbedding

    emb = FixedOrderEmbedding(7, 3)
    assert isinstance(emb, torch.nn.Embedding) and list(emb.state_dict()) == ["weight"]
    ids = torch.tensor([[1, 1, 6], [0, 2, 1]])
    assert torch.equal(emb(ids), torch.nn.functional.embedding(ids, emb.weight))


CUDNN_FLAGS = ("enabled", "benchmark", "deterministic", "allow_tf32")


@pytest.mark.parametrize("raises", [False, True])
@pytest.mark.parametrize("before", [(True, True, False, False), (True, False, True, True),
                                    (False, True, False, True), (True, False, False, False)])
def test_deterministic_convolutions_restores_the_flags(before, raises):
    """Inside: benchmark off, deterministic on, enabled and allow_tf32 as
    the caller set them; after the block (or an exception in it) every flag
    as it was."""
    from multimodalworddiscovery_tpu_torch.core.determinism import deterministic_convolutions

    cudnn = torch.backends.cudnn
    saved = tuple(getattr(cudnn, f) for f in CUDNN_FLAGS)
    try:
        for f, v in zip(CUDNN_FLAGS, before):
            setattr(cudnn, f, v)
        with pytest.raises(ValueError) if raises else contextlib.nullcontext():
            with deterministic_convolutions():
                inside = tuple(getattr(cudnn, f) for f in CUDNN_FLAGS)
                if raises:
                    raise ValueError("in the step")
        assert inside == (before[0], False, True, before[3])
        assert tuple(getattr(cudnn, f) for f in CUDNN_FLAGS) == before
    finally:
        for f, v in zip(CUDNN_FLAGS, saved):
            setattr(cudnn, f, v)


def _determinism_breaches(tree, embeddings: bool):
    """Lines of bare embedding lookups (``embeddings``) and of process-wide
    determinism switches."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            f = node.func
            name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
            if name == "use_deterministic_algorithms" or (
                    embeddings and name in ("Embedding", "embedding")):
                found.append(node.lineno)
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                   else [])
        for t in targets:
            for x in (t.elts if isinstance(t, ast.Tuple) else [t]):
                if isinstance(x, ast.Attribute) and x.attr in ("deterministic", "benchmark"):
                    found.append(node.lineno)
    return sorted(set(found))


def test_gradient_steps_have_no_atomic_embedding_or_global_switch():
    """No bare nn.Embedding / F.embedding lookup under models/ and
    frontend/ (FixedOrderEmbedding in their place), and no process-wide
    use_deterministic_algorithms or cudnn.deterministic / benchmark
    assignment anywhere in the package (deterministic_convolutions scopes
    its flags to the step)."""
    bad = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG).as_posix()
        embeddings = rel.split("/")[0] in ("models", "frontend")
        bad += [f"{rel}:{line}" for line in
                _determinism_breaches(ast.parse(path.read_text()), embeddings)]
    assert not bad, f"atomic embedding lookups or process-wide determinism switches: {bad}"


def test_determinism_scan_finds_each_form():
    """The scan's own check: each form is found, the scoped context and
    FixedOrderEmbedding are not."""
    src = """
def f(x, w):
    nn.Embedding(7, 3)
    torch.nn.functional.embedding(x, w)
    F.embedding(x, w)
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    cudnn.benchmark, cudnn.deterministic = False, True
    with deterministic_convolutions():
        FixedOrderEmbedding(7, 3)(x)
"""
    assert _determinism_breaches(ast.parse(src), True) == [3, 4, 5, 6, 7, 8]
    assert _determinism_breaches(ast.parse(src), False) == [6, 7, 8]
