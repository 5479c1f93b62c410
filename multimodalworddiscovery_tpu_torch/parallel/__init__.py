"""Parallelism on torch.distributed: data-parallel EM and gradient steps
over a mesh of ranks (data_parallel.py), the multi-process trainers and the
local-world launcher (multihost.py), the time-sharded E-step (sequence.py)
and the multi-rank dry run (dryrun.py)."""

from multimodalworddiscovery_tpu_torch.parallel.data_parallel import (
    make_data_parallel_step,
    make_shard_map_em_step,
    shard_corpus,
)

__all__ = ["make_data_parallel_step", "make_shard_map_em_step", "shard_corpus"]
