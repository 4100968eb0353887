from .mesh import (DataMesh, all_mean, broadcast_from_first, data_parallel_group, dividing_group, replicate,
                   shard_batch)

__all__ = ["DataMesh", "all_mean", "broadcast_from_first", "data_parallel_group", "dividing_group",
           "replicate", "shard_batch"]
