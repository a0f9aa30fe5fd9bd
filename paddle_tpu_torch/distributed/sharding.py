"""paddle.distributed.sharding: `group_sharded_parallel` and
`save_group_sharded_model` (counterpart of
paddle_tpu/distributed/sharding.py), re-exported from
`paddle_tpu_torch.parallel.zero`, which holds the one implementation."""
from ..parallel.zero import (GroupShardedOptimizerStage2, GroupShardedStage2,
                             GroupShardedStage3, group_sharded_parallel,
                             save_group_sharded_model)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
