from .mesh import (  # noqa: F401
    HybridGroups, all_gather_cat, all_reduce_sum, barrier, gather_results,
    init_from_env, is_main_process, make_group, make_group_for_batch,
    make_hybrid_groups, rank, shard_batch, shard_range, world_size)
from .query_parallel import (  # noqa: F401
    QUERY_AXIS, QueryShard, constrain_preds)
