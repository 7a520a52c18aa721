"""Data parallelism (counterpart of fastdet/parallel/): meshes, process
groups, input shards and the collectives of a data-parallel job.  Tensor
parallelism (fastdet/parallel/tp.py, the 2-D (data, model) mesh) is not
ported: ROADMAP A20."""

from __future__ import annotations

from fastdet_torch.parallel.mesh import (DATA_AXIS, Mesh, batch_slices,
                                         initialize_distributed, make_mesh,
                                         replicate, shard_batch,
                                         shard_chained_batch)
from fastdet_torch.parallel.multihost import (gather_eval_stats,
                                              process_shard)


def sync_batchnorm(model, group):
    """Give every `BatchNorm` of `model` the process group `group` (None
    undoes it): in training mode they then take the global batch's
    statistics.  The counterpart of `nn.SyncBatchNorm
    .convert_sync_batchnorm`, without replacing the modules.  → model."""
    from fastdet_torch.models.layers import BatchNorm
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group
    return model


__all__ = ["DATA_AXIS", "Mesh", "batch_slices", "gather_eval_stats",
           "initialize_distributed", "make_mesh", "process_shard",
           "replicate", "shard_batch", "shard_chained_batch",
           "sync_batchnorm"]
