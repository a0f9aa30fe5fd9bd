"""paddle.distributed for the port, over `torch.distributed`: what the
multi-rank slices use (ring and Ulysses attention, the MoE layer's expert
parallelism, the ZeRO trainer's data-parallel reductions). `group` joins
the world and picks the backend (NCCL when every rank has a card, else
gloo), `communication` holds the collectives,
`spawn` starts a world of processes, `fleet.meta_parallel.ring_attention`
the sequence-parallel attention and `fleet.recompute` activation
recompute."""
from .communication import (P2POp, Pending, ReduceOp, all_gather,
                            all_reduce, all_to_all, alltoall_single, barrier,
                            batch_isend_irecv, pmean, recv, replicated,
                            ring_shift, send)
from .group import (Group, destroy_process_group, get_group, get_rank,
                    get_world_size, init_parallel_env, is_initialized,
                    new_group)
from .spawn import spawn

__all__ = ["P2POp", "Pending", "ReduceOp", "all_gather", "all_reduce",
           "all_to_all", "alltoall_single", "barrier", "batch_isend_irecv",
           "pmean", "recv", "replicated", "ring_shift", "send",
           "Group", "destroy_process_group", "get_group", "get_rank",
           "get_world_size", "init_parallel_env", "is_initialized",
           "new_group", "spawn"]
