"""Device ordering, fixed-shard-order reductions and the ZeRO trainer of
the port (counterpart of paddle_tpu/parallel; `zero` resolves lazily)."""
from .mesh import (carve_submeshes, chunk_bounds, collected_shard_sum,
                   device_order, fixed_order_sum, ordered_allreduce,
                   ordered_psum, ordered_psum_scatter, ring_collect,
                   ring_ordered_psum, ring_ordered_psum_scatter,
                   ring_pipeline)

_ZERO_EXPORTS = ("ZeroTrainStep", "zero_train_step", "model_loss",
                 "build_bucket_layout", "save_optimizer_state",
                 "load_optimizer_state", "GroupShardedStage2",
                 "GroupShardedStage3", "GroupShardedOptimizerStage2",
                 "group_sharded_parallel", "save_group_sharded_model")

__all__ = ["carve_submeshes", "chunk_bounds", "collected_shard_sum",
           "device_order", "fixed_order_sum", "ordered_allreduce",
           "ordered_psum", "ordered_psum_scatter", "ring_collect",
           "ring_ordered_psum", "ring_ordered_psum_scatter",
           "ring_pipeline", *_ZERO_EXPORTS]


def __getattr__(name):
    if name in _ZERO_EXPORTS:
        from . import zero

        return getattr(zero, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
