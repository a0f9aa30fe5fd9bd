"""fleet.meta_parallel for the port (counterpart of
paddle_tpu/distributed/fleet/meta_parallel/__init__.py:1-30): the mp
layers (`parallel_layers`), the pipeline engine (`pipeline_parallel`), the
hybrid optimizer wrapper, the GroupSharded facade (`sharding`), sequence
parallelism, the SPMD collective pipeline (`spmd_pipeline`) and ring /
Ulysses attention (`ring_attention`)."""
from .hybrid_parallel_optimizer import (HybridParallelClipGrad,
                                        HybridParallelOptimizer)
from .parallel_layers import (ColumnParallelLinear, ParallelCrossEntropy,
                              RNGStatesTracker, RowParallelLinear,
                              VocabParallelEmbedding, get_rng_state_tracker,
                              model_parallel_random_seed,
                              mp_full_parameters, mp_shardings)
from .pipeline_parallel import (LayerDesc, PipelineLayer, PipelineParallel,
                                SharedLayerDesc)
from .ring_attention import (RingFlashAttention, ring_flash_attention,
                             ulysses_attention)
from .sequence_parallel import (AllGatherOp, ColumnSequenceParallelLinear,
                                GatherOp, ReduceScatterOp,
                                RowSequenceParallelLinear, ScatterOp,
                                mark_as_sequence_parallel_parameter,
                                register_sequence_parallel_allreduce_hooks)
from .sharding import (GroupShardedOptimizerStage2, GroupShardedStage2,
                       GroupShardedStage3, group_sharded_parallel)

__all__ = ["HybridParallelClipGrad", "HybridParallelOptimizer",
           "ColumnParallelLinear", "ParallelCrossEntropy",
           "RNGStatesTracker", "RowParallelLinear", "VocabParallelEmbedding",
           "get_rng_state_tracker", "model_parallel_random_seed",
           "mp_full_parameters", "mp_shardings", "LayerDesc", "PipelineLayer", "PipelineParallel",
           "SharedLayerDesc", "RingFlashAttention", "ring_flash_attention",
           "ulysses_attention", "AllGatherOp", "ColumnSequenceParallelLinear",
           "GatherOp", "ReduceScatterOp", "RowSequenceParallelLinear",
           "ScatterOp", "mark_as_sequence_parallel_parameter",
           "register_sequence_parallel_allreduce_hooks",
           "GroupShardedOptimizerStage2", "GroupShardedStage2",
           "GroupShardedStage3", "group_sharded_parallel"]
