"""Multi-rank GAD training on torch.distributed (port of gags_tpu.parallel):
camera data parallelism (sharding.py), Gaussian-sharded strip rendering
and training (gshard.py), their collectives (collectives.py) and the
process launcher (launch.py)."""

from gags_torch.parallel.sharding import make_mesh, make_mesh2d, make_dp_render, make_dp_train_step
from gags_torch.parallel.gshard import (
    GShardState,
    gshard_state,
    make_dp_gshard_train_step,
    make_gshard_render,
    make_gshard_train_step,
    pad_seg_map,
    shard_gaussians,
)

__all__ = [
    "make_mesh",
    "make_mesh2d",
    "make_dp_gshard_train_step",
    "make_dp_render",
    "make_dp_train_step",
    "GShardState",
    "gshard_state",
    "make_gshard_render",
    "make_gshard_train_step",
    "pad_seg_map",
    "shard_gaussians",
]
