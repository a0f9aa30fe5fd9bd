"""Device ordering and fixed-shard-order reductions of the port
(counterpart of the part of paddle_tpu/parallel that tensor-parallel
serving uses; the ZeRO trainer, parallel/zero.py, is not ported yet)."""
from .mesh import (carve_submeshes, chunk_bounds, device_order,
                   fixed_order_sum, ordered_allreduce)

__all__ = ["carve_submeshes", "chunk_bounds", "device_order",
           "fixed_order_sum", "ordered_allreduce"]
