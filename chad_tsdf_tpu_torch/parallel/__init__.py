from .sharded import (adaptive_bounds, create_sharded_state,  # noqa: F401
                      default_halo_capacity, gather_states, key_bounds,
                      make_mesh, make_sharded_insert, morton_split,
                      owner_split, point_block_keys, rebalance_chunks,
                      scratch_config, ShardMesh)
from .sharded_map import ShardedTSDFMap  # noqa: F401
