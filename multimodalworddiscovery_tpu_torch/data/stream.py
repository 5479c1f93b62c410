"""Out-of-core streaming EM: sharded on-disk corpora and prefetched copies.

Counterpart of ``multimodalworddiscovery_tpu/data/stream.py``.  The corpus
lives on disk as fixed-shape shards and every EM iteration streams them
through the device.  This is exact EM, not SGD: expected counts are
additive over utterances, so per iteration

    counts = sum_k expected_counts(params, shard_k);  m_step once

equals the full-batch E-step up to float addition order.

- Every shard has the same padded shape ([shard_size, Ts] / [shard_size,
  Tt]; the last shard is padded with zero-length utterances, which the
  E-steps give logZ = 0 and zero counts), so a kernel sees one launch shape
  for every shard and every iteration.
- Shards are plain ``.npy`` files; loading one reads only its bytes (one
  ``readinto`` a field, straight into the host buffer), so host residency
  is O(shard).
- Prefetch: a reader thread reads shard k+1 into pinned host memory and
  copies it to the card on the reader's own CUDA stream while the card
  computes shard k.  The consumer's stream waits on the copy's event (no
  host sync), and each tensor is marked used on the consumer's stream so
  the caching allocator does not hand its block out early.
- The per-iteration counts are added into one running total on the device;
  the loglik is read once an iteration, never per shard.
- Over a mesh of ranks (``train_streaming(mesh=)``) every rank reads only
  its rows of each shard and one all_reduce an iteration pools the counts;
  ``parallel/multihost.py`` streams whole shards per rank instead.

The on-disk layout is shared with the JAX package (each reads the other's
directories):

    manifest.json   {"name", "num_shards", "shard_size", "n", "max_src_len",
                     "max_trg_len", "src_vocab", "trg_vocab",
                     "shuffle_seed", "storage_dtype"}
    src_<k>.npy  src_len_<k>.npy  trg_<k>.npy  trg_len_<k>.npy
    gold.json       (optional, data/io.save_alignment_json's format)
"""

from __future__ import annotations

import dataclasses
import inspect
import io
import json
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from multimodalworddiscovery_tpu_torch.core.collectives import all_sum, group_of
from multimodalworddiscovery_tpu_torch.core.mesh import check_mesh, shard_rows
from multimodalworddiscovery_tpu_torch.data.corpus import Corpus

# the per-shard array files: <field>_<k>.npy
FIELDS = ("src", "src_len", "trg", "trg_len")

# valid storage dtypes of the float fields.  float16 and not bfloat16: the
# stored values are upcast to float32 on the device before any compute, so
# only mantissa bits per byte matter (10 for float16, 7 for bfloat16), and
# float16 round-trips through np.save / np.load.
STORAGE_DTYPES = ("float32", "float16")

def _check_storage_dtype(storage_dtype: str | None) -> None:
    if storage_dtype is not None and storage_dtype not in STORAGE_DTYPES:
        raise ValueError(f"storage_dtype {storage_dtype!r} not in {STORAGE_DTYPES}")


def _storage_cast(arr: np.ndarray, storage_dtype: str | None) -> np.ndarray:
    """Float fields -> the storage dtype; int fields pass through."""
    _check_storage_dtype(storage_dtype)
    if storage_dtype in (None, "float32") or not np.issubdtype(arr.dtype, np.floating):
        return arr
    return arr.astype(storage_dtype)


def _host_fields(corpus: Corpus) -> dict[str, np.ndarray]:
    """The corpus's four fields as host arrays."""
    return {f: getattr(corpus, f).detach().cpu().numpy() for f in FIELDS}


def read_npy_into(path: Path, alloc: Callable[[tuple, np.dtype], np.ndarray],
                  headers: dict | None = None, rows: tuple[int, int] | None = None) -> np.ndarray:
    """Read a ``.npy`` file straight into ``alloc(shape, dtype)`` (a host
    buffer, pinned for the card) with ``readinto``: no mmap page faults, no
    intermediate copy, the interpreter lock released while it reads.
    ``headers`` caches parsed headers by their bytes: the shards of one
    directory share their shapes, so a reader thread parses each field's
    header once and holds the lock (which the consuming thread needs for
    every launch) as little as it can.  ``rows=(lo, hi)`` reads only those
    rows of the leading axis."""
    with open(path, "rb", buffering=0) as f:
        head = f.read(10)
        if head[:6] != b"\x93NUMPY":
            raise ValueError(f"{path} is not a .npy file")
        if head[6] == 1:
            header = head + f.read(int.from_bytes(head[8:10], "little"))
        else:  # versions 2 and 3: a 4-byte header length
            head += f.read(2)
            header = head + f.read(int.from_bytes(head[8:12], "little"))
        meta = None if headers is None else headers.get(header)
        if meta is None:
            bio = io.BytesIO(header)
            version = np.lib.format.read_magic(bio)
            read_header = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                           else np.lib.format.read_array_header_2_0)
            shape, fortran_order, dtype = read_header(bio)
            if fortran_order:
                raise ValueError(f"{path}: Fortran-ordered arrays are not shard files")
            meta = (shape, dtype)
            if headers is not None:
                headers[header] = meta
        shape, dtype = meta
        if rows is not None:
            lo, hi = rows
            if not 0 <= lo <= hi <= shape[0]:
                raise ValueError(f"{path}: rows {rows} of {shape[0]}")
            f.seek(lo * int(np.prod(shape[1:], dtype=np.int64)) * dtype.itemsize, io.SEEK_CUR)
            shape = (hi - lo, *shape[1:])
        out = alloc(shape, dtype)
        view, done = memoryview(out.reshape(-1).view(np.uint8)), 0
        while done < out.nbytes:
            got = f.readinto(view[done:])
            if not got:
                raise ValueError(f"{path}: truncated after {done} of {out.nbytes} bytes")
            done += got
    return out


def _pad_rows(arr: np.ndarray, n: int) -> np.ndarray:
    """Zero rows appended up to ``n`` (zero-length utterances)."""
    if arr.shape[0] == n:
        return arr
    out = np.zeros((n, *arr.shape[1:]), arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def _manifest(name, num_shards, shard_size, n, meta, shuffle_seed, storage_dtype) -> str:
    ms, mt, sv, tv = meta
    return json.dumps({
        "name": name, "num_shards": num_shards, "shard_size": shard_size, "n": n,
        "max_src_len": ms, "max_trg_len": mt, "src_vocab": sv, "trg_vocab": tv,
        "shuffle_seed": shuffle_seed, "storage_dtype": storage_dtype,
    })


def write_shards(
    corpus: Corpus, directory: str | Path, shard_size: int, name: str = "corpus",
    gold=None, shuffle: int | None = None, storage_dtype: str | None = None,
) -> int:
    """Split a corpus (on any device) into fixed-shape shards; returns the
    number of shards.

    ``shuffle`` (an int seed) applies one global utterance permutation,
    ``np.random.default_rng(shuffle).permutation(n)`` as in the JAX
    package, recorded in the manifest as ``shuffle_seed``, so each shard is
    a uniform random subset: streamed minibatch SGD samples within the
    resident shard, and an ordered corpus would bias it.  ``gold`` is
    permuted the same way and saved beside the shards.  Streamed EM is
    order-invariant.

    ``storage_dtype="float16"`` stores the float fields (frames, region
    embeddings) at half the bytes; the reader upcasts them to float32 on
    the device.  Lossy: values round to float16 once, at write time.
    """
    _check_storage_dtype(storage_dtype)
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    n = corpus.n
    arrays = _host_fields(corpus)
    perm = None
    if shuffle is not None:
        perm = np.random.default_rng(shuffle).permutation(n)
        arrays = {f: a[perm] for f, a in arrays.items()}
    num_shards = max(1, -(-n // shard_size))
    arrays = {f: _pad_rows(a, num_shards * shard_size) for f, a in arrays.items()}
    for k in range(num_shards):
        lo, hi = k * shard_size, (k + 1) * shard_size
        for field, arr in arrays.items():
            np.save(d / f"{field}_{k}.npy", _storage_cast(arr[lo:hi], storage_dtype))
    meta = (corpus.max_src_len, corpus.max_trg_len, corpus.src_vocab, corpus.trg_vocab)
    (d / "manifest.json").write_text(
        _manifest(name, num_shards, shard_size, n, meta, shuffle, storage_dtype))
    if gold is not None:
        from multimodalworddiscovery_tpu_torch.data.io import save_alignment_json

        ga = np.asarray(gold.alignment)
        segs = gold.segments
        if perm is not None:
            ga = ga[perm]
            if segs is not None:
                segs = [segs[i] for i in perm]
        save_alignment_json(ga, arrays["src_len"][:n], d / "gold.json", segments=segs)
    return num_shards


class ShardWriter:
    """Incremental ``write_shards`` for corpora too large to materialize:
    each appended batch becomes one shard, and ``close()`` writes the
    manifest and the gold alignments appended.  Host residency is one batch
    (plus the gold alignments).

    Every batch shares max_src_len / max_trg_len / the vocabularies; the
    last may be shorter and is padded with zero-length utterances.  Shuffle
    upstream (the generation order) and pass ``shuffle_seed`` to record it.
    """

    def __init__(self, directory: str | Path, shard_size: int, name: str = "corpus",
                 shuffle_seed: int | None = None, storage_dtype: str | None = None):
        _check_storage_dtype(storage_dtype)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.shard_size = int(shard_size)
        self.name = name
        self.shuffle_seed = shuffle_seed
        self.storage_dtype = storage_dtype
        self._k = 0
        self._n = 0
        self._meta = None  # (max_src_len, max_trg_len, src_vocab, trg_vocab)
        self._gold_align: list[np.ndarray] = []
        self._gold_lens: list[np.ndarray] = []
        self._closed = False

    def append(self, corpus: Corpus, gold_alignment=None) -> int:
        """Write one batch as shard ``k``; returns k.  ``gold_alignment``:
        optional [B, max_src_len] int array (0 = NULL)."""
        if self._closed:
            raise ValueError("ShardWriter is closed")
        b = int(corpus.n)
        if b > self.shard_size:
            raise ValueError(f"batch of {b} > shard_size {self.shard_size}")
        meta = (corpus.max_src_len, corpus.max_trg_len, corpus.src_vocab, corpus.trg_vocab)
        if self._meta is None:
            self._meta = meta
        elif meta != self._meta:
            raise ValueError(f"batch shape/vocab drift: {meta} vs first batch {self._meta}")
        arrays = _host_fields(corpus)
        for field in FIELDS:
            np.save(self.directory / f"{field}_{self._k}.npy",
                    _storage_cast(_pad_rows(arrays[field], self.shard_size),
                                  self.storage_dtype))
        if gold_alignment is not None:
            ga = np.asarray(gold_alignment)
            if ga.shape != (b, corpus.max_src_len):
                raise ValueError(
                    f"gold_alignment shape {ga.shape} != {(b, corpus.max_src_len)}")
            self._gold_align.append(ga.astype(np.int32))
            self._gold_lens.append(arrays["src_len"])
        elif self._gold_align:
            raise ValueError("gold_alignment given for some batches only")
        self._n += b
        self._k += 1
        return self._k - 1

    def close(self) -> int:
        """Write the manifest (and gold.json if gold was appended); returns
        the number of shards."""
        if self._closed:
            return self._k
        if self._meta is None:
            raise ValueError("no batches appended")
        (self.directory / "manifest.json").write_text(_manifest(
            self.name, self._k, self.shard_size, self._n, self._meta, self.shuffle_seed,
            self.storage_dtype))
        if self._gold_align:
            from multimodalworddiscovery_tpu_torch.data.io import save_alignment_json

            save_alignment_json(np.concatenate(self._gold_align),
                                np.concatenate(self._gold_lens), self.directory / "gold.json")
        self._closed = True
        return self._k

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()


@dataclasses.dataclass
class _Staged:
    """A shard whose copy to the card was enqueued on the reader's stream:
    ``event`` marks its end; ``pinned`` are the host buffers it reads."""

    corpus: Corpus
    event: Any = None
    pinned: tuple = ()


class ShardedCorpusReader:
    """Reader of a shard directory, loading onto ``device``
    ("cuda" unless the caller names another)."""

    def __init__(self, directory: str | Path, device="cuda"):
        self.directory = Path(directory)
        m = json.loads((self.directory / "manifest.json").read_text())
        self.num_shards: int = m["num_shards"]
        self.shard_size: int = m["shard_size"]
        self.n: int = m["n"]
        self.max_src_len: int = m["max_src_len"]
        self.max_trg_len: int = m["max_trg_len"]
        self.src_vocab: int = m["src_vocab"]
        self.trg_vocab: int = m["trg_vocab"]
        # seed of the write-time permutation (None: corpus order; manifests
        # older than the shuffle option lack the key)
        self.shuffle_seed = m.get("shuffle_seed")
        # on-disk dtype of the float fields (None / float32: as computed)
        self.storage_dtype = m.get("storage_dtype")
        self.device = torch.device(device)
        self._stream = None
        self._headers: dict = {}  # parsed .npy headers, by their bytes
        self._inflight: list[_Staged] = []
        self._lock = threading.Lock()
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)

    def _path(self, field: str, k: int) -> Path:
        return self.directory / f"{field}_{k}.npy"

    def read_host(self, k: int, field: str) -> np.ndarray:
        """Shard ``k``'s ``field`` as stored, in host memory."""
        return read_npy_into(self._path(field, k), np.empty, self._headers)

    def _stage(self, k: int, rows: tuple[int, int] | None = None) -> _Staged:
        """Read shard ``k`` (its ``rows`` only, if given) and enqueue its
        copy to the device.  Safe on the reader thread: on CUDA the files
        are read into pinned buffers and copied on the reader's own
        stream."""
        if not 0 <= k < self.num_shards:
            raise IndexError(f"shard {k} of {self.num_shards}")
        if self._stream is None:
            fields = [torch.from_numpy(read_npy_into(self._path(f, k), np.empty, self._headers,
                                                     rows))
                      for f in FIELDS]
            fields = [t.float() if t.dtype == torch.float16 else t for t in fields]
            return _Staged(Corpus(*fields, src_vocab=self.src_vocab,
                                  trg_vocab=self.trg_vocab).to(self.device))
        with torch.cuda.device(self.device):
            with self._lock:  # drop the host buffers whose copies have ended
                self._inflight = [s for s in self._inflight if not s.event.query()]
            pinned = []

            def alloc(shape, dtype):
                host = torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                                   pin_memory=True)
                pinned.append(host)
                return host.numpy()

            for f in FIELDS:
                read_npy_into(self._path(f, k), alloc, self._headers, rows)
            event = torch.cuda.Event()
            with torch.cuda.stream(self._stream):
                fields = [h.to(self.device, non_blocking=True) for h in pinned]
                # the compact float16 bytes cross PCIe; upcast on the device
                fields = [t.float() if t.dtype == torch.float16 else t for t in fields]
                event.record(self._stream)
            staged = _Staged(Corpus(*fields, src_vocab=self.src_vocab,
                                    trg_vocab=self.trg_vocab), event, tuple(pinned))
            with self._lock:
                self._inflight.append(staged)
            return staged

    def _ready(self, staged: _Staged) -> Corpus:
        """On the consuming thread: its current stream waits for the copy
        (no host sync), and every tensor is marked used on that stream."""
        if staged.event is None:
            return staged.corpus
        consumer = torch.cuda.current_stream(self.device)
        consumer.wait_event(staged.event)
        for f in FIELDS:
            getattr(staged.corpus, f).record_stream(consumer)
        return staged.corpus

    def load_shard(self, k: int, rows: tuple[int, int] | None = None) -> Corpus:
        """Shard ``k`` (its ``rows`` [lo, hi) only, if given) on the device,
        ready on the caller's current stream."""
        return self._ready(self._stage(k, rows))

    def shards(self, prefetch: int = 1, ids=None, rows: tuple[int, int] | None = None):
        """Yield the shards ``ids`` (default: all, in order), ``prefetch``
        of them read and copied ahead on a reader thread; with ``rows``
        only those rows of each (a rank's share of every shard)."""
        ids = list(range(self.num_shards)) if ids is None else list(ids)
        for staged in prefetched(lambda j: self._stage(ids[j], rows), len(ids), prefetch):
            yield self._ready(staged)

    def materialize(self) -> tuple[Corpus, Any]:
        """The whole corpus on the device (the last shard's padding trimmed
        back to the true N) and its gold annotations (or None): a decode-
        and evaluation-time convenience when the corpus fits."""
        fields = []
        for field in FIELDS:
            a = np.concatenate([np.load(self._path(field, k))
                                for k in range(self.num_shards)])[: self.n]
            fields.append(a.astype(np.float32) if a.dtype == np.float16 else a)
        corpus = Corpus.from_numpy(*fields, src_vocab=self.src_vocab,
                                   trg_vocab=self.trg_vocab, device=self.device)
        gold = None
        if (self.directory / "gold.json").exists():
            from multimodalworddiscovery_tpu_torch.data.io import load_alignment_json

            gold = load_alignment_json(self.directory / "gold.json", self.n, self.max_src_len)
        return corpus, gold


def prefetched(load, total: int, prefetch: int = 1):
    """Yield ``load(0) .. load(total-1)`` with ``prefetch`` calls running
    ahead on one reader thread: the I/O overlap of every streaming path."""
    if prefetch < 1:
        raise ValueError(f"prefetch must be >= 1, got {prefetch}")
    with ThreadPoolExecutor(max_workers=1) as ex:
        pending = [ex.submit(load, k) for k in range(min(prefetch, total))]
        for k in range(total):
            item = pending.pop(0).result()
            if k + prefetch < total:
                pending.append(ex.submit(load, k + prefetch))
            yield item


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of identically structured trees of dicts,
    tuples and lists (leaves: tensors or numbers)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def tree_sum_bounded(items) -> Any:
    """Sum an iterator of identically structured trees into one running
    total, so device residency stays one result plus the total whatever the
    number of items (the shard count, in the streaming paths)."""
    total = None
    for r in items:
        total = r if total is None else tree_map(torch.add, total, r)
    return total


def stream_expected_counts(
    count_fn: Callable[[Any, Corpus], tuple[Any, torch.Tensor]],
    params: Any,
    reader: ShardedCorpusReader,
    prefetch: int = 1,
) -> tuple[Any, torch.Tensor]:
    """Sum ``count_fn(params, shard)`` over all shards, ``prefetch`` shards
    loaded ahead -> (counts, loglik) of the whole corpus, on the device."""
    return tree_sum_bounded(count_fn(params, shard) for shard in reader.shards(prefetch))


def takes(fn: Callable, name: str) -> bool:
    """Whether ``fn`` has a parameter ``name``."""
    return name in inspect.signature(fn).parameters


def stream_em(
    mod: Any,
    params: Any,
    corpora: Callable[[], Any],
    num_iterations: int,
    count_kwargs: dict | None = None,
    m_step_kwargs: dict | None = None,
    group=None,
    on_iteration: Callable[[int, Any, float], None] | None = None,
    scale_schedule=None,
    use_kernels: bool | None = None,
):
    """EM whose E-step sums ``mod.expected_counts`` over the corpora that
    ``corpora()`` yields afresh each iteration, on the device, then over the
    ranks of ``group`` (one all_reduce of the counts and the loglik; none
    without a group), and whose M-step runs once: the loop of every
    streaming trainer.  Returns (params, [loglik per iteration])."""
    ckw = dict(count_kwargs or {})
    mkw = dict(m_step_kwargs or {})
    if use_kernels is not None and takes(mod.expected_counts, "use_kernels"):
        ckw.setdefault("use_kernels", use_kernels)
    lls = []
    for it in range(num_iterations):
        kw = ckw if scale_schedule is None else {**ckw,
                                                 "emit_scale": float(scale_schedule[it])}
        counts, ll = all_sum(tree_sum_bounded(mod.expected_counts(params, c, **kw)
                                              for c in corpora()), group)
        params = mod.m_step(params, counts, **mkw)
        lls.append(float(ll))
        if on_iteration is not None:
            on_iteration(it, params, lls[-1])
    return params, lls


def train_streaming(
    mod: Any,
    params: Any,
    reader: ShardedCorpusReader,
    num_iterations: int,
    count_kwargs: dict | None = None,
    m_step_kwargs: dict | None = None,
    mesh=None,
    prefetch: int = 1,
    on_iteration: Callable[[int, Any, float], None] | None = None,
    scale_schedule=None,
    use_kernels: bool | None = None,
):
    """Exact out-of-core EM for the closed-form aligners (model1, hmm,
    hmm_gaussian, segmental_kmeans): every iteration streams the shards
    through ``mod.expected_counts(params, shard, **count_kwargs)``, sums
    the counts on the device and runs one ``mod.m_step``.

    With ``mesh`` each shard splits over the ranks (shard_size a multiple
    of the mesh size): every rank reads only its rows of each shard, and
    one all_reduce an iteration pools the ranks' counts; the parameters
    must be identical on every rank.
    ``use_kernels`` goes to modules whose ``expected_counts`` takes it (not
    Model-1's); None leaves their default (the kernels on a CUDA shard).
    ``scale_schedule`` (one float per iteration) runs deterministic
    annealing: iteration i's E-step gets ``emit_scale=scale_schedule[i]``
    (hmm_gaussian).  ``on_iteration(it, params, loglik)`` runs after each
    M-step.  Returns (params, [loglik per iteration]).
    """
    rows = None
    if mesh is not None:
        w = check_mesh(mesh).size()
        if reader.shard_size % w:
            raise ValueError(f"shard_size {reader.shard_size} must divide by the mesh's "
                             f"{w} ranks")
        rows = shard_rows(reader.shard_size, mesh)
    return stream_em(mod, params, lambda: reader.shards(prefetch, rows=rows), num_iterations,
                     count_kwargs, m_step_kwargs, group_of(mesh), on_iteration, scale_schedule,
                     use_kernels)
