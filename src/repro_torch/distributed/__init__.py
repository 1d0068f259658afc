"""Distribution (twin of ``repro.distributed``): logical-axis sharding rules,
shard contexts, the explicit collectives, the mesh-aware conversion plan,
the serving placement and the context-parallel decode attention."""
from .sharding import (NULL_CTX, STATS, PartitionSpec, ShardCtx, all_gather,
                       all_reduce, copy_to, default_rules, gather_dim,
                       gather_tree, local_shard, mesh_axis_size, place,
                       reduce_from, reduce_scatter, tree_param_specs,
                       zero1_specs)
from . import serving_sharding
