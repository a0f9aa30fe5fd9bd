"""GroupSharded (ZeRO stages 1-3) under fleet.meta_parallel: a re-export
of `paddle_tpu_torch.parallel.zero` (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/sharding.py), which holds the
one implementation."""
from ....parallel.zero import (GroupShardedOptimizerStage2,
                               GroupShardedStage2, GroupShardedStage3,
                               group_sharded_parallel)

__all__ = ["GroupShardedStage2", "GroupShardedStage3",
           "GroupShardedOptimizerStage2", "group_sharded_parallel"]
