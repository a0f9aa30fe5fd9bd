"""Pipeline parallelism: `PipelineLayer` and the `PipelineParallel` engine
(counterpart of paddle_tpu/distributed/fleet/meta_parallel/
pipeline_parallel.py:39-566).

The model is a list of layer descriptions cut into S x V chunks (S
stages, V virtual stages: the interleaved layout when V > 1), chunk c on
stage c % S. Each stage is a process (its rank on the topology's pp axis);
a process builds only its own chunks' layers. Without a joined world the
one process builds and runs every stage, as the reference's single
controller does.

`PipelineParallel.train_batch` walks the reference's schedule (:396-466):
S - 1 warm-up forward chains, then one forward and one backward chain a
step, then the cool-down backward chains. A forward chain carries micro-
batch m through every chunk; a backward chain carries its gradient back
from the loss. Each rank runs the chunks it holds and meets its neighbour
stage where the chain crosses between ranks: the activation forward and
its gradient backward go by `distributed.send` / `recv` over the pp group
(a small header first: dtype and shape). Every rank walks the same
sequence of chains, so every send meets its recv in order.

The last chunk runs its forward and the loss in the backward chain, as the
reference's does. Other chunks keep their autograd graph from the forward
to the backward (the 1F1B footprint: at most S chains in flight). Each
(chunk, micro-batch) draws its dropout from one `torch.Generator` seeded
from (the tracker's global seed, step, chunk, micro-batch), so a forward
and its backward agree and a rerun gives the same masks. The parameter
gradients sum over micro-batches in order; at the flush they are summed
over the data-parallel ranks (dp, then sharding; rank order), multiplied
by 1 / (M x data ranks) once, a shared layer's gradient is summed over the
stages that hold it, and the optimizer steps (`HybridParallelOptimizer`
applies the hybrid clip). The loss returned on every rank is the mean of the
micro-batch losses over the data ranks. Each data-parallel rank takes its
1 / (dp x sharding) of the global batch's rows, then splits it into M
micro-batches.

The reference places ZeRO-1 moments over a sharding axis under the
pipeline; here the pipeline reduces gradients over sharding like dp and
keeps the optimizer state whole.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Optional, Sequence

import torch
from torch import nn

from ... import communication as C
from ...group import is_initialized, new_group
from ....parallel.mesh import ordered_psum

__all__ = ["LayerDesc", "SharedLayerDesc", "PipelineLayer",
           "PipelineParallel"]

_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int64, torch.int32, torch.bool]
_MAX_DIMS = 6


class LayerDesc:
    def __init__(self, layer_cls, *args, **kwargs):
        self.layer_cls = layer_cls
        self.args = args
        self.kwargs = kwargs

    def build(self) -> nn.Module:
        if isinstance(self.layer_cls, nn.Module):
            return self.layer_cls
        return self.layer_cls(*self.args, **self.kwargs)

    def type_name(self) -> str:
        cls = self.layer_cls
        return (type(cls).__name__ if isinstance(cls, nn.Module)
                else cls.__name__)


class SharedLayerDesc(LayerDesc):
    """A layer whose parameters several positions share (tied embeddings):
    built once a process; across stages its gradient is summed over the
    holders. `forward_func(layer, x)`, when given, runs the position."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *args, **kwargs):
        super().__init__(layer_cls, *args, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


def _desc(d):
    return d if isinstance(d, LayerDesc) else LayerDesc(d)


def _default_stage(num_stages: int, topology) -> Optional[int]:
    """The stage this process runs: its pp coordinate in a joined world of
    `num_stages` > 1 stages, else None (every stage here)."""
    if num_stages <= 1 or not is_initialized():
        return None
    from ...group import get_rank

    if topology is None:
        from .. import get_hybrid_communicate_group

        hcg = get_hybrid_communicate_group()
        if hcg is None:
            raise RuntimeError("a PipelineLayer over ranks needs fleet.init "
                               "(or topology=)")
        topology = hcg.topology()
    if topology.get_dim("pp") != num_stages:
        raise ValueError(f"num_stages={num_stages} but the topology's pp "
                         f"degree is {topology.get_dim('pp')}")
    coord = topology.get_coord(get_rank())
    return coord[topology.get_hybrid_group_names().index("pp")]


class PipelineLayer(nn.Module):
    """The layer list and its cut into chunks. Layer i is registered under
    the name `str(i)` wherever it is built, so a stage's `state_dict` keys
    are the whole model's."""

    def __init__(self, layers: Sequence, num_stages: Optional[int] = None,
                 topology=None, loss_fn=None, seg_method: str = "uniform",
                 recompute_interval: int = 0,
                 num_virtual_pipeline_stages=None, **kwargs):
        super().__init__()
        if num_stages is None:
            if topology is None:
                from .. import get_hybrid_communicate_group

                hcg = get_hybrid_communicate_group()
                topology = hcg.topology() if hcg is not None else None
            num_stages = topology.get_dim("pp") if topology else 1
        self.num_stages = int(num_stages)
        self._loss_fn = loss_fn
        self.seg_method = seg_method
        self.recompute_interval = recompute_interval
        self.num_virtual_stages = int(num_virtual_pipeline_stages or 1)
        if self.num_virtual_stages < 1:
            raise ValueError("num_virtual_pipeline_stages must be >= 1")
        self._descs = [_desc(d) for d in layers]
        self.num_chunks = self.num_stages * self.num_virtual_stages
        if len(self._descs) < self.num_chunks:
            raise ValueError(
                f"{len(self._descs)} layers cannot be split into "
                f"{self.num_stages} stages x {self.num_virtual_stages} "
                "virtual stages")
        self._segments = self._segment(len(self._descs), self.num_chunks,
                                       seg_method)
        self._stage_id = _default_stage(self.num_stages, topology)
        self._shared: Dict[str, nn.Module] = {}
        self._all_layers: List[Optional[nn.Module]] = [None] * len(
            self._descs)
        for c in self.local_chunks():
            for i in range(self._segments[c], self._segments[c + 1]):
                d = self._descs[i]
                if isinstance(d, SharedLayerDesc):
                    if d.layer_name not in self._shared:
                        self._shared[d.layer_name] = d.build()
                    layer = self._shared[d.layer_name]
                else:
                    layer = d.build()
                self._all_layers[i] = layer
                self.add_module(str(i), layer)
        self.chunk_layers: List[Optional[List[nn.Module]]] = [
            self._all_layers[self._segments[c]:self._segments[c + 1]]
            if self.is_local(c) else None for c in range(self.num_chunks)]
        self.stage_layers: List[Optional[List[nn.Module]]] = [
            [layer for c in range(s, self.num_chunks, self.num_stages)
             for layer in self.chunk_layers[c]]
            if self._stage_id in (None, s) else None
            for s in range(self.num_stages)]
        self._takes_gen = {}

    def chunk_to_stage(self, c: int) -> int:
        return c % self.num_stages

    def is_local(self, c: int) -> bool:
        return self._stage_id is None or self.chunk_to_stage(c) == \
            self._stage_id

    def local_chunks(self) -> List[int]:
        return [c for c in range(self.num_chunks) if self.is_local(c)]

    def _segment(self, n_layers: int, n_chunks: int, method: str):
        if method.startswith("layer:"):
            name = method.split(":", 1)[1]
            marks = [i for i, d in enumerate(self._descs)
                     if d.type_name() == name]
            if len(marks) >= n_chunks:
                per = len(marks) // n_chunks
                return ([0] + [marks[per * s] for s in range(1, n_chunks)]
                        + [n_layers])
        base, extra = divmod(n_layers, n_chunks)
        cuts = [0]
        for s in range(n_chunks):
            cuts.append(cuts[-1] + base + (1 if s < extra else 0))
        return cuts

    def get_stage_from_index(self, idx: int) -> int:
        for c in range(self.num_chunks):
            if self._segments[c] <= idx < self._segments[c + 1]:
                return self.chunk_to_stage(c)
        raise IndexError(idx)

    def _run(self, i: int, x, generator):
        layer, d = self._all_layers[i], self._descs[i]
        if isinstance(d, SharedLayerDesc) and d.forward_func is not None:
            return d.forward_func(layer, x)
        takes = self._takes_gen.get(i)
        if takes is None:
            takes = "generator" in inspect.signature(
                layer.forward).parameters
            self._takes_gen[i] = takes
        return layer(x, generator=generator) if takes else layer(x)

    def run_chunk(self, c: int, x, generator=None):
        """Chunk c's layers on `x` (this process must hold it)."""
        for i in range(self._segments[c], self._segments[c + 1]):
            x = self._run(i, x, generator)
        return x

    def forward(self, x, generator=None):
        """The whole model (every stage built in this process)."""
        if self._stage_id is not None:
            raise RuntimeError("this process holds only stage "
                               f"{self._stage_id}: run the whole model "
                               "through PipelineParallel")
        for c in range(self.num_chunks):
            x = self.run_chunk(c, x, generator)
        return x


def _header(t: torch.Tensor) -> torch.Tensor:
    """dtype and shape of `t` as a small int64 tensor on its device (NCCL
    carries only device tensors)."""
    h = [_DTYPES.index(t.dtype), t.dim(), *t.shape]
    h += [0] * (2 + _MAX_DIMS - len(h))
    return torch.tensor(h, dtype=torch.int64, device=t.device)


class PipelineParallel:
    """The pipeline engine over the pp ranks of a topology (see the module
    docstring). `accumulate_steps` (M) comes from
    `strategy.pipeline_configs`; the dropout streams are seeded from the
    seed of the RNG tracker's "global_seed" stream (0 without one)."""

    def __init__(self, layers: PipelineLayer, hcg, strategy=None):
        self._layers = layers
        self._hcg = hcg
        cfg = (strategy.pipeline_configs if strategy is not None
               else {"accumulate_steps": 1})
        self.accumulate_steps = int(cfg.get("accumulate_steps", 1))
        self.num_stages = layers.num_stages
        self.num_chunks = layers.num_chunks
        self.total_loss = None
        self._step = 0
        pp = hcg.get_pipe_parallel_group() if hcg is not None else None
        self._distributed = (pp is not None and pp.nranks > 1
                             and is_initialized())
        self._pp = pp if self._distributed else None
        if self._distributed:
            if pp.nranks != self.num_stages:
                raise ValueError(f"{self.num_stages} stages over a pp group "
                                 f"of {pp.nranks} ranks")
            if layers._stage_id != hcg.get_stage_id():
                raise ValueError(f"the PipelineLayer holds stage "
                                 f"{layers._stage_id}, this rank is stage "
                                 f"{hcg.get_stage_id()}")
        self._data_groups = []
        if hcg is not None and is_initialized():
            self._data_groups = [g for g in (
                hcg.get_data_parallel_group(),
                hcg.get_sharding_parallel_group()) if g.nranks > 1]
        self._shared_groups = self._build_shared_groups()

    # ------------------------------------------------------------ placement
    @property
    def _stage(self) -> Optional[int]:
        return self._layers._stage_id

    def _owner(self, c: int) -> int:
        return c % self.num_stages

    def _build_shared_groups(self):
        """For each shared layer held on several stages: its parameters
        and the group of this rank's holders (every rank makes every
        group, in the same order), weights aligned to the first holder."""
        out = []
        if not self._distributed:
            return out
        layers = self._layers
        keys = {}
        for i, d in enumerate(layers._descs):
            if isinstance(d, SharedLayerDesc):
                stage = layers.get_stage_from_index(i)
                keys.setdefault(d.layer_name, [])
                if stage not in keys[d.layer_name]:
                    keys[d.layer_name].append(stage)
        me = self._hcg.get_global_rank()
        for key, stages in keys.items():
            if len(stages) < 2:
                continue
            for lst in self._hcg.topology().get_comm_list("pp"):
                ranks = [lst[s] for s in sorted(stages)]
                g = new_group(ranks)
                if me in ranks:
                    params = list(layers._shared[key].parameters())
                    with torch.no_grad():
                        for p in params:
                            p.copy_(C.all_gather(None, p.detach(), g)[0])
                    out.append((params, g))
        return out

    # ------------------------------------------------------------ transport
    def _send(self, t: torch.Tensor, stage: int) -> None:
        C.send(_header(t), stage, self._pp)
        C.send(t.detach(), stage, self._pp)

    def _recv(self, stage: int, device) -> torch.Tensor:
        h = C.recv(torch.zeros(2 + _MAX_DIMS, dtype=torch.int64,
                               device=device), stage, self._pp).tolist()
        shape = tuple(h[2:2 + h[1]])
        buf = torch.empty(shape, dtype=_DTYPES[h[0]], device=device)
        return C.recv(buf, stage, self._pp)

    def _hand_over(self, t, c_from: int, c_to: int, device):
        """The tensor leaving chunk `c_from` for `c_to` (an activation, or
        a gradient going back): sent or received when their stages are
        different ranks, passed on when one process holds both."""
        src, dst = self._owner(c_from), self._owner(c_to)
        if not self._distributed or src == dst:
            return t
        if self._stage == src:
            self._send(t, dst)
            return None
        if self._stage == dst:
            return self._recv(src, device)
        return None

    def _generator(self, c: int, m: int, device):
        from .parallel_layers import get_rng_state_tracker

        streams = get_rng_state_tracker().get_states_tracker()
        seed = (streams["global_seed"].initial_seed()
                if "global_seed" in streams else 0)
        gen = torch.Generator(device=device)
        gen.manual_seed((((seed * 1000003 + self._step) * 7919 + c)
                         * 104729 + m) % (2 ** 63))
        return gen

    # -------------------------------------------------------------- schedule
    def forward_backward_pipeline(self, micro_inputs, micro_labels):
        """The chains of the module docstring. Returns the micro-batch
        losses this rank computed (the last stage's), in order."""
        C_, M = self.num_chunks, len(micro_inputs)
        layers = self._layers
        dev = micro_inputs[0].device
        acts = {}
        losses = []

        def fwd_chain(m):
            x = micro_inputs[m]
            for c in range(C_):
                if c:
                    x = self._hand_over(x, c - 1, c, dev)
                if not layers.is_local(c):
                    continue
                if x.is_floating_point():
                    x = x.detach().requires_grad_(True)
                if c == C_ - 1:
                    acts[(c, m)] = (x, None)
                    break
                y = layers.run_chunk(c, x, self._generator(c, m, dev))
                acts[(c, m)] = (x, y)
                x = y.detach()

        def bwd_chain(m):
            gx = None
            for c in range(C_ - 1, -1, -1):
                if c < C_ - 1:
                    gx = self._hand_over(gx, c + 1, c, dev)
                if not layers.is_local(c):
                    continue
                x, y = acts.pop((c, m))
                if c == C_ - 1:
                    y = layers.run_chunk(c, x, self._generator(c, m, dev))
                    loss = layers._loss_fn(y, micro_labels[m])
                    losses.append(loss.detach())
                    loss.backward()
                else:
                    torch.autograd.backward(y, gx)
                gx = x.grad if x.requires_grad else None

        warmup = min(self.num_stages - 1, M)
        for m in range(warmup):
            fwd_chain(m)
        for m in range(warmup, M):
            fwd_chain(m)
            bwd_chain(m - warmup)
        for m in range(max(0, M - warmup), M):
            bwd_chain(m)
        return losses

    def _local_rows(self, t: torch.Tensor) -> torch.Tensor:
        """This data-parallel rank's rows of a global batch leaf."""
        n, i = 1, 0
        for g in self._data_groups:
            i = i * g.nranks + g.rank
            n *= g.nranks
        if t.shape[0] % n:
            raise ValueError(f"a batch of {t.shape[0]} rows does not split "
                             f"over {n} data-parallel ranks")
        per = t.shape[0] // n
        return t[i * per:(i + 1) * per]

    def _split(self, t: torch.Tensor) -> List[torch.Tensor]:
        M = self.accumulate_steps
        if t.shape[0] % M:
            raise ValueError(f"batch {t.shape[0]} not divisible by "
                             f"accumulate_steps {M}")
        return list(torch.split(t, t.shape[0] // M))

    def _broadcast_loss(self, losses, device) -> torch.Tensor:
        """The mean micro-batch loss, averaged over the data ranks, on
        every stage (the last stage's value; the others add zeros)."""
        loss = torch.zeros((), dtype=torch.float32, device=device)
        if losses:
            loss = sum(l.float() for l in losses) / len(losses)
        n = 1
        for g in self._data_groups:
            loss = ordered_psum(loss.reshape(1), g)[0]
            n *= g.nranks
        if n > 1:
            loss = loss * (1.0 / n)
        if self._distributed:
            loss = ordered_psum(loss.reshape(1), self._pp)[0]
        return loss

    def _reduce_grads(self) -> None:
        params = [p for p in self._layers.parameters()
                  if p.grad is not None]
        n = 1
        for g in self._data_groups:
            n *= g.nranks
        with torch.no_grad():
            for p in params:
                grad = p.grad
                for g in self._data_groups:
                    grad = ordered_psum(grad, g)
                p.grad = grad * (1.0 / (self.accumulate_steps * n))
            for shared, g in self._shared_groups:
                for p in shared:
                    if p.grad is not None:
                        p.grad = ordered_psum(p.grad, g)

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """A global batch `(inputs, labels)` in, the mean loss out; the
        optimizer steps at the flush."""
        if self._layers._loss_fn is None:
            raise ValueError(
                "PipelineParallel.train_batch needs the PipelineLayer to be "
                "built with loss_fn=...")
        if scaler is not None:
            raise NotImplementedError(
                "PipelineParallel.train_batch with a GradScaler: the "
                "pipeline runs fp32 or bf16 O1 steps without loss scaling")
        inputs, labels = data
        self._layers.train()
        x = self._split(self._local_rows(torch.as_tensor(inputs)))
        y = self._split(self._local_rows(torch.as_tensor(labels)))
        losses = self.forward_backward_pipeline(x, y)
        self._reduce_grads()
        optimizer.step()
        optimizer.clear_grad()
        if lr_scheduler is not None:
            lr_scheduler.step()
        self._step += 1
        self.total_loss = self._broadcast_loss(losses, x[0].device)
        return self.total_loss

    @torch.no_grad()
    def eval_batch(self, data, compute_loss: bool = True):
        """The whole local batch through every chunk in eval mode: the loss
        on every stage, or (compute_loss=False) the last chunk's output on
        the last stage (None elsewhere)."""
        inputs, labels = data
        self._layers.eval()
        x = self._local_rows(torch.as_tensor(inputs))
        dev = x.device
        for c in range(self.num_chunks):
            if c:
                x = self._hand_over(x, c - 1, c, dev)
            if self._layers.is_local(c):
                x = self._layers.run_chunk(c, x)
        last = self._layers.is_local(self.num_chunks - 1)
        if not compute_loss:
            return x if last else None
        losses = []
        if last:
            y = self._local_rows(torch.as_tensor(labels))
            losses.append(self._layers._loss_fn(x, y))
        return self._broadcast_loss(losses, dev)

    def parameters(self):
        return self._layers.parameters()

    def named_parameters(self, *a, **k):
        return self._layers.named_parameters(*a, **k)

    def state_dict(self, *a, **k):
        return self._layers.state_dict(*a, **k)

    def set_state_dict(self, sd, *a, **k):
        return self._layers.load_state_dict(sd, *a, **k)
