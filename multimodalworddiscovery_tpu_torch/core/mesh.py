"""The device mesh of the parallel layer.

Counterpart of ``multimodalworddiscovery_tpu/core/mesh.py``.  JAX has two
meshes: the D devices of one process, and every device of several processes
(``jax.distributed``).  PyTorch runs one process per device, so both become
the W ranks of a ``torch.distributed`` process group
(``parallel.multihost.initialize``), and a mesh is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over them with a named axis:
``"data"`` for data parallelism, ``"seq"`` for the time-sharded E-step
(``parallel/sequence.py``).  ``mesh.size()``, ``mesh.get_group()`` and
``mesh.get_local_rank()`` take the place of ``mesh.shape[axis]`` and
``axis_index``.

The reference's ``corpus_sharding`` and ``replicated`` have no torch
meaning and are left out: a rank holds only its own rows, as an ordinary
``Corpus`` on its own device (``shard_rows`` says which), and replicated
parameters are identical tensors on every rank.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

DATA_AXIS = "data"


def make_mesh(n_devices: int | None = None, axis_name: str = DATA_AXIS) -> DeviceMesh:
    """1-D mesh over the first ``n_devices`` ranks (default: all of them)
    of the initialized process group.

    The mesh's device type follows the group's backend: "cuda" for NCCL,
    "cpu" for gloo (whose collectives take the ranks' CUDA tensors all the
    same).  With ``n_devices`` below the world size every rank must call
    this, and the ranks outside the mesh take no part in its
    collectives."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.multihost.initialize)")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if not 1 <= n_devices <= world:
        raise ValueError(f"requested {n_devices} devices, have {world} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_devices == world:
        return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))
    return DeviceMesh(device_type, list(range(n_devices)), mesh_dim_names=(axis_name,))


def check_mesh(mesh) -> DeviceMesh:
    """``mesh`` if it is a 1-D ``DeviceMesh``, else a TypeError."""
    if not isinstance(mesh, DeviceMesh) or mesh.ndim != 1:
        raise TypeError(f"expected a 1-D torch.distributed DeviceMesh (core.mesh.make_mesh), "
                        f"got {type(mesh).__name__}")
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of m that is >= n (corpus padding for even shards)."""
    return ((n + m - 1) // m) * m


def shard_rows(n: int, mesh: DeviceMesh) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous rows of an axis of ``n`` rows,
    ``n`` a multiple of the mesh size."""
    w = check_mesh(mesh).size()
    if n % w:
        raise ValueError(f"{n} rows do not split over {w} ranks")
    r = mesh.get_local_rank()
    return r * (n // w), (r + 1) * (n // w)
