"""Multi-rank execution over torch.distributed (port of
holoscene_tpu/parallel): the (data, model) grid of ranks and the Stage-1
sharding policy (mesh), the data-parallel Stage-4 step (stage4_dp)."""

from holoscene_tpu_torch.parallel.mesh import (
    batch_sharding,
    make_mesh,
    param_sharding,
    shard_params,
)

__all__ = ["make_mesh", "batch_sharding", "param_sharding", "shard_params"]
