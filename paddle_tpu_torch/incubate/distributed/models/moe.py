"""Mixture of experts with GShard / Switch / Naive gates (counterpart of
paddle_tpu/incubate/distributed/models/moe.py:33-206), its routing
operation for operation, its experts fed and read through the row gather
K9 (`ops.moe_dispatch.gather_rows`).

`MoELayer(d_model, experts, gate)` takes the gate as a config dict
(`{"type": "gshard" | "switch" | "naive", "top_k": k}`) or a gate module,
and the experts as a list of modules (build them from the port's
`nn.Linear`, so that `amp.auto_cast` O1 casts their products to bf16).
Parameter names are the reference's: `gate.gate_weight` ([d_model, E],
not a Linear, so `weights.load_reference_state` carries it untransposed)
and `experts.<e>.<...>`. The layer takes `device` (the card by default,
which raises without one) and `seed`: the gate (Xavier-uniform) and every
expert Linear (Xavier-normal weight, zero bias, the reference's Linear
init) are drawn from a seeded generator on that device.

`_routed_forward` is the reference's gather branch, the one it takes on a
TPU: K9 on the card, its plain version on the CPU. (The reference's one-hot
einsum branch computes the same function; the tests hold this one against
both.) The routing is fp32 whatever the amp state, as the reference's raw
`@` inside `apply_callable` is: the gate product is a plain `@`, not the
amp-casting `nn.torch_functional.matmul`.

`expert_parallel_forward(x, group)` is the reference's expert parallelism
(:208-287) over the ranks of a `distributed.Group`: each rank routes its
share of the tokens, an all-to-all sends every expert's queue to the rank
that owns the expert, each rank runs its E / W experts, and a second
all-to-all brings the outputs back for the combine.
"""
from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ....device import resolve_device
from ....distributed.communication import (_resolve, all_to_all, pmean,
                                           replicated)
from ....distributed.group import Group
from ....ops.moe_dispatch import gather_rows, moe_dispatch_indices

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate", "BaseGate"]


class BaseGate(nn.Module):
    def __init__(self, d_model: int, num_experts: int, device=None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.gate_weight = nn.Parameter(torch.empty(
            d_model, num_experts, device=resolve_device(device)))
        self.reset_parameters()      # MoELayer redraws it from its seed

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """Xavier-uniform: U(-a, a) with a = sqrt(6 / (d_model + E))."""
        limit = math.sqrt(6.0 / (self.d_model + self.num_experts))
        self.gate_weight.uniform_(-limit, limit, generator=generator)


class NaiveGate(BaseGate):
    """top-k gate, no capacity (the layer's default factor 2.0 applies)."""

    def __init__(self, d_model, num_expert=1, world_size=1, topk=2,
                 device=None):
        super().__init__(d_model, num_expert * world_size, device)
        self.topk = topk


class SwitchGate(BaseGate):
    """top-1 gate (Switch Transformer) with capacity and the aux loss."""

    def __init__(self, d_model, num_expert=1, world_size=1, topk=1,
                 switch_eps=0.1, capacity=(1.2, 2.4), device=None):
        super().__init__(d_model, num_expert * world_size, device)
        self.topk = 1
        self.capacity_factor = capacity[0]


class GShardGate(BaseGate):
    """top-2 gate with capacity and the aux loss (GShard)."""

    def __init__(self, d_model, num_expert=1, world_size=1, topk=2,
                 capacity=(1.2, 2.4), random_routing=True, device=None):
        super().__init__(d_model, num_expert * world_size, device)
        self.topk = 2
        self.capacity_factor = capacity[0]


_GATES = {"gshard": GShardGate, "switch": SwitchGate, "naive": NaiveGate}


class Routing(NamedTuple):
    """The routing of T tokens over E experts, k choices each."""
    capacity: int
    topi: torch.Tensor        # [T, k] expert ids
    onehot: torch.Tensor      # [T, k, E]
    pos: torch.Tensor         # [T, k, E] position in each expert's queue
    keep: torch.Tensor        # [T, k, E] capacity mask times onehot
    gates: torch.Tensor       # [T, k, E] renormalized gate values
    aux: torch.Tensor         # the load-balancing loss, a scalar


class MoELayer(nn.Module):
    """Mixture of experts over `experts` with `gate`; `aux_loss` holds the
    load-balancing loss of the last forward."""

    def __init__(self, d_model: int, experts: Optional[List[nn.Module]] = None,
                 gate=None, moe_group=None, mp_group=None,
                 recompute_interval: int = 0, *, device=None, seed: int = 0,
                 **kwargs):
        super().__init__()
        dev = resolve_device(device)
        self.d_model = d_model
        experts = list(experts or [])
        if isinstance(gate, dict):          # paddle's config-dict form
            cls = _GATES[gate.get("type", "gshard")]
            gate = cls(d_model, num_expert=len(experts),
                       topk=gate.get("top_k", 2), device=dev)
        if gate is None:
            raise ValueError("MoELayer needs a gate: a config dict such as "
                             "{'type': 'gshard', 'top_k': 2}, or a gate")
        self.gate = gate
        self.experts = nn.ModuleList(experts)
        self.num_experts = len(self.experts)
        self.moe_group = moe_group
        self.capacity_factor = getattr(gate, "capacity_factor", 2.0)
        self.aux_loss: Optional[torch.Tensor] = None
        self.to(dev)
        self.init_weights(seed)

    @torch.no_grad()
    def init_weights(self, seed: int) -> None:
        """Redraw the gate and every expert Linear from `seed` on the
        layer's device."""
        gen = torch.Generator(device=self.gate.gate_weight.device)
        gen.manual_seed(int(seed))
        self.gate.reset_parameters(gen)
        for mod in self.experts.modules():
            if isinstance(mod, nn.Linear):              # Xavier-normal
                out_f, in_f = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (in_f + out_f)),
                                   generator=gen)
                if mod.bias is not None:
                    mod.bias.zero_()

    def _route(self, flat: torch.Tensor, gate_w: torch.Tensor) -> Routing:
        """The reference's routing (:108-128), operation for operation: a
        different capacity drop would follow from any other order."""
        tokens = flat.shape[0]
        E = self.num_experts
        k = getattr(self.gate, "topk", 2)
        capacity = max(int(math.ceil(self.capacity_factor * tokens * k / E)),
                       k)
        dt = torch.promote_types(flat.dtype, gate_w.dtype)
        logits = flat.to(dt) @ gate_w.to(dt)               # fp32 under O1
        probs = torch.softmax(logits, dim=-1)               # [T, E]
        # jax.lax.top_k puts the lower index first on a tie and torch.topk
        # does not promise that on CUDA; ties of float probabilities are
        # improbable, and a test that met one would show a mismatch
        topv, topi = torch.topk(probs, k, dim=-1)           # [T, k]
        onehot = (topi[..., None] == torch.arange(E, device=flat.device)
                  ).to(probs.dtype)                         # [T, k, E]
        # token-major: token t's second choice queues before token t+1's
        # first. The scan runs along the contiguous axis of the transpose
        # (one along the outer axis of the (T*k, E) one-hot takes a thread
        # per expert); 0/1 counts are exact in fp32, so the bits are the same
        flat_oh = onehot.reshape(tokens * k, E).t().contiguous()
        pos = (torch.cumsum(flat_oh, dim=1) - 1.0).t().reshape(tokens, k, E)
        keep = (pos < capacity).to(probs.dtype) * onehot
        gates = topv[..., None] * keep
        denom = gates.sum(dim=(1, 2), keepdim=True).clamp_min(1e-9)
        gates = gates / denom * topv.sum(-1)[:, None, None]
        # GShard's load-balancing loss: E * sum(mean probs * first-choice
        # fraction)
        me = probs.mean(dim=0)
        ce = onehot[:, 0].mean(dim=0)
        aux = E * torch.sum(me * ce)
        return Routing(capacity, topi, onehot, pos, keep, gates, aux)

    def _indices(self, r: Routing) -> Tuple[torch.Tensor, torch.Tensor]:
        pos_tk = (r.pos * r.onehot).sum(-1)                 # [T, k]
        keep_tk = r.keep.sum(-1)                            # [T, k] 0 / 1
        return moe_dispatch_indices(r.topi, pos_tk.to(torch.int32), keep_tk,
                                    self.num_experts, r.capacity)

    @torch.no_grad()
    def dispatch_indices(self, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(slot_token [E*C], tok_slot [T, k], capacity): the gather
        indices of the dispatch and the combine that `forward(x)` uses."""
        r = self._route(x.reshape(-1, x.shape[-1]), self.gate.gate_weight)
        return (*self._indices(r), r.capacity)

    def _routed_forward(self, flat: torch.Tensor, gate_w: torch.Tensor,
                        expert_run: Callable[[torch.Tensor], torch.Tensor]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(y [T, d'], aux) for flat tokens [T, d]; `expert_run` maps the
        expert queues [E, C, d] to [E, C, d']."""
        r = self._route(flat, gate_w)
        tokens, d = flat.shape
        E, C = self.num_experts, r.capacity
        slot_token, tok_slot = self._indices(r)
        expert_in = gather_rows(flat, slot_token).reshape(E, C, d)
        expert_out = expert_run(expert_in)                  # [E, C, d']
        d_out = expert_out.shape[-1]
        per_k = gather_rows(expert_out.reshape(E * C, d_out),
                            tok_slot.reshape(-1)).reshape(tokens, -1, d_out)
        gate_tk = r.gates.sum(-1)                           # [T, k]
        # fp32 gates times the experts' (bf16 under O1) rows: fp32
        y = (gate_tk[..., None] * per_k).sum(1)
        return y, r.aux

    def _run_experts(self, expert_in: torch.Tensor) -> torch.Tensor:
        return torch.stack([expert(expert_in[e])
                            for e, expert in enumerate(self.experts)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [batch, seq, d_model] or [tokens, d_model]; sets aux_loss."""
        squeeze = x.dim() == 2
        if squeeze:
            x = x.unsqueeze(0)
        b, s, d = x.shape
        y, aux = self._routed_forward(x.reshape(b * s, d),
                                      self.gate.gate_weight,
                                      self._run_experts)
        self.aux_loss = aux
        out = y.reshape(b, s, -1)
        return out.squeeze(0) if squeeze else out

    def expert_parallel_forward(self, x: torch.Tensor,
                                group: Optional[Group] = None
                                ) -> torch.Tensor:
        """The expert-parallel forward over the ranks of `group` (the
        default group when None), W of them, as the reference's over a mesh
        axis. `x` is the whole batch, [batch, seq, d_model] or [tokens,
        d_model], the same on every rank; its T tokens split over the ranks
        in order, T / W each. Rank r routes its share (the capacity follows
        from T / W, as in the reference's shard), sends expert e's queue to
        rank e // (E / W) (an all-to-all, [E, C, d] -> [E / W, W * C, d]),
        runs its own E / W experts, `experts[r * E / W:(r + 1) * E / W]`,
        and takes their outputs back by the inverse all-to-all for the
        combine. Returns this rank's output rows, [T / W, d'], those of
        tokens r * T / W onward; `aux_loss` is the mean of the ranks' (the
        reference's `pmean`). The gate weight is replicated, so its gradient
        is summed over the ranks; an expert's gradient arises only on the
        rank that owns it. Raises when E or T do not divide over the
        ranks. With enough capacity (nothing dropped) the rows equal the
        single-rank forward's, up to the order of sums."""
        g = _resolve(group)
        W, E = g.nranks, self.num_experts
        if E % W:
            raise ValueError(f"num_experts {E} not divisible by the ep size "
                             f"{W}")
        flat = x.reshape(-1, x.shape[-1])
        tokens = flat.shape[0]
        if tokens % W:
            raise ValueError(f"{tokens} tokens not divisible by the ep size "
                             f"{W}")
        per, local = tokens // W, E // W
        mine = flat[g.rank * per:(g.rank + 1) * per]
        own = self.experts[g.rank * local:(g.rank + 1) * local]

        def expert_run(expert_in):                  # [E, C, d] queues
            ein = all_to_all(expert_in, 0, 1, g)    # [E/W, W*C, d]
            out = torch.stack([expert(ein[e]) for e, expert in
                               enumerate(own)])
            return all_to_all(out, 1, 0, g)         # [E, C, d']

        y, aux = self._routed_forward(
            mine, replicated(self.gate.gate_weight, g), expert_run)
        self.aux_loss = pmean(aux, g)
        return y
