"""Data and tensor parallelism (counterpart of fastdet/parallel/):
meshes, process groups, input shards and the collectives of a job.  The
1-D data mesh is `make_mesh` (mesh.py); the 2-D (data, model) mesh of
tensor parallel, its sharding rules and its collectives are `tp.py`
(`make_mesh_2d`, `state_shardings`, `shard_state`, `gather_state`,
`tensor_parallel`)."""

from __future__ import annotations

from fastdet_torch.parallel.mesh import (DATA_AXIS, Mesh, batch_slices,
                                         initialize_distributed, make_mesh,
                                         replicate, shard_batch,
                                         shard_chained_batch)
from fastdet_torch.parallel.multihost import (gather_eval_stats,
                                              process_shard)
from fastdet_torch.parallel.tp import (MODEL_AXIS, Mesh2D, gather_state,
                                       make_mesh_2d, shard_state,
                                       state_shardings, tensor_parallel)


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


__all__ = ["DATA_AXIS", "MODEL_AXIS", "Mesh", "Mesh2D", "batch_slices",
           "gather_eval_stats", "gather_state", "initialize_distributed",
           "make_mesh", "make_mesh_2d", "process_shard", "replicate",
           "shard_batch", "shard_chained_batch", "shard_state",
           "state_shardings", "sync_batchnorm", "tensor_parallel"]
