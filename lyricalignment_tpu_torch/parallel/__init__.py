"""Scale-out on ``torch.distributed``: the ("data", "model") mesh, the
sharding rules and the collectives the JAX package leaves to GSPMD."""

from lyricalignment_tpu_torch.parallel.mesh import (
    align_param_specs,
    batch_sharding,
    make_mesh,
    shard_align_params,
)

__all__ = ["make_mesh", "batch_sharding", "shard_align_params", "align_param_specs"]
