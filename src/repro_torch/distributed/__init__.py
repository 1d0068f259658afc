"""Distribution (twin of ``repro.distributed``): logical-axis sharding rules,
shard contexts, the explicit collectives, the mesh-aware conversion plan,
the serving placement and the context-parallel decode attention."""
from .sharding import (NULL_CTX, STATS, PartitionSpec, ShardCtx, all_gather,
                       all_reduce, default_rules, local_shard, mesh_axis_size,
                       tree_param_specs, zero1_specs)
from . import serving_sharding
