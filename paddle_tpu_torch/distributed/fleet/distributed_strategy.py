"""DistributedStrategy, the typed strategy of fleet (a copy of
paddle_tpu/distributed/fleet/distributed_strategy.py:26-82, host-only).
Paddle backs it with protobuf; a plain attribute bag keeps its field
names."""
from __future__ import annotations

import copy

__all__ = ["DistributedStrategy"]

_DEFAULT_HYBRID = {
    "dp_degree": 1,
    "mp_degree": 1,
    "pp_degree": 1,
    "sharding_degree": 1,
    "sep_degree": 1,
    "order": ["pp", "dp", "sharding", "sep", "mp"],
    "mp_configs": {},
    "pp_configs": {},
}


class DistributedStrategy:
    def __init__(self):
        # hybrid parallel
        self.hybrid_configs = copy.deepcopy(_DEFAULT_HYBRID)
        # amp
        self.amp = False
        self.amp_configs = {
            "init_loss_scaling": 32768.0,
            "custom_white_list": [],
            "custom_black_list": [],
            "use_pure_fp16": False,
            "use_pure_bf16": False,
        }
        # recompute
        self.recompute = False
        self.recompute_configs = {"checkpoints": []}
        # sharding (static meta-optimizer knobs kept for parity)
        self.sharding = False
        self.sharding_configs = {
            "stage": 1,
            "degree": 1,
            "offload": False,
        }
        # gradient merge / accumulation
        self.gradient_merge = False
        self.gradient_merge_configs = {"k_steps": 1, "avg": True}
        # misc parity fields
        self.pipeline = False
        self.pipeline_configs = {"accumulate_steps": 1,
                                 "micro_batch_size": 1,
                                 "schedule_mode": "1F1B"}
        self.tensor_parallel = False
        self.tensor_parallel_configs = {"tensor_parallel_degree": 1}
        self.lamb = False
        self.dgc = False
        self.localsgd = False
        self.find_unused_parameters = False
        self.fuse_all_reduce_ops = True
        self.fuse_grad_size_in_MB = 32
        self.nccl_comm_num = 1

    def _set_hybrid(self, **kwargs):
        self.hybrid_configs.update(kwargs)

    def __setattr__(self, name, value):
        if name == "hybrid_configs" and isinstance(value, dict) and \
                "hybrid_configs" in self.__dict__:
            self.__dict__["hybrid_configs"].update(value)
            return
        object.__setattr__(self, name, value)

    def __repr__(self):
        h = self.hybrid_configs
        return (f"DistributedStrategy(dp={h['dp_degree']}, mp={h['mp_degree']},"
                f" pp={h['pp_degree']}, sharding={h['sharding_degree']},"
                f" sep={h['sep_degree']})")
