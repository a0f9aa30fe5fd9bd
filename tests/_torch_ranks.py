"""Rank bodies of the port's multi-rank tests, run by
`paddle_tpu_torch.distributed.spawn` in fresh processes over gloo on the
CPU. This module imports neither JAX nor paddle_tpu, so no rank loads
them; the tests compute the JAX references in their own process and get
numpy arrays back from here. Every function runs on every rank of a world
that `spawn` has already joined."""
import time

import numpy as np
import torch

from paddle_tpu_torch import distributed as ptd


def _np(t):
    return t.detach().float().numpy()


def sequence_parallel(cases):
    """Ring or Ulysses attention on this rank's shard of each case's
    global (b, h, s, d) float32 arrays: `cases` maps a name to (mode,
    causal, dtype name, q, k, v, w). Forward, then the gradient of
    sum(out * w). Returns {name: (out, dq, dk, dv)} of this rank's shard,
    in float32."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ring_attention as ra)

    g = ptd.get_group()
    out = {}
    for name, (mode, causal, dname, q, k, v, w) in cases.items():
        dtype = getattr(torch, dname)
        sl = q.shape[2] // g.nranks
        mine = slice(g.rank * sl, (g.rank + 1) * sl)
        qs, ks, vs = (torch.from_numpy(np.ascontiguousarray(x[:, :, mine]))
                      .to(dtype).requires_grad_() for x in (q, k, v))
        fn = (ra.ring_flash_attention if mode == "ring"
              else ra.ulysses_attention)
        o = fn(qs, ks, vs, causal=causal)
        assert o.dtype == dtype and o.shape == qs.shape
        (o.float() * torch.from_numpy(w[:, :, mine])).sum().backward()
        out[name] = tuple(_np(t) for t in (o, qs.grad, ks.grad, vs.grad))
    return out


def collectives():
    """Each collective of the helper on rank-dependent values; returns
    what this rank saw (numpy) for the test to check."""
    g = ptd.get_group()
    n, me = g.nranks, g.rank
    res = {"rank": me, "world": ptd.get_world_size(), "backend": g.backend}
    x = torch.arange(6, dtype=torch.float32) + 10 * me
    res["all_reduce"] = ptd.all_reduce(x.clone(), group=g).numpy()
    res["all_reduce_max"] = ptd.all_reduce(
        x.clone(), op=ptd.ReduceOp.MAX).numpy()
    res["all_gather"] = [t.numpy() for t in ptd.all_gather(None, x)]
    a, b = ptd.ring_shift((x, x.reshape(2, 3) * 2), g)
    res["ring_shift"] = (a.numpy(), b.numpy())
    # rank me sends its j-th block (4 rows) to rank j
    blocks = torch.arange(n * 4, dtype=torch.float32) + 100 * me
    res["alltoall_single"] = ptd.alltoall_single(None, blocks).numpy()
    # the tiled all-to-all and its gradient (the inverse all-to-all)
    t = (torch.arange(2 * n * 3 * 5, dtype=torch.float64).reshape(2, n * 3,
                                                                 5)
         + 1000 * me).requires_grad_()
    y = ptd.all_to_all(t, 1, 2, g)               # [2, 3, n * 5]
    res["all_to_all"] = y.detach().numpy()
    wgt = torch.arange(y.numel(), dtype=torch.float64).reshape(y.shape)
    (y * (wgt + me)).sum().backward()
    res["all_to_all_grad"] = t.grad.numpy()
    # p2p: rank 0 sends to the last rank, batch_isend_irecv shifts by one
    if me == 0:
        ptd.send(x * 3, dst=n - 1)
    if me == n - 1:
        res["recv"] = ptd.recv(torch.empty(6), src=0).numpy()
    buf = torch.empty(6)
    ptd.batch_isend_irecv([ptd.P2POp(ptd.send, x + 0.5, (me + 1) % n),
                           ptd.P2POp(ptd.recv, buf, (me - 1) % n)])
    res["batch_isend_irecv"] = buf.numpy()
    # pmean's gradient reaches each rank divided by n; replicated's is
    # summed over the ranks
    p = torch.tensor([2.0 + me], requires_grad=True)
    m = ptd.pmean(p * p, g)
    m.backward()
    res["pmean"] = (float(m), float(p.grad))
    r = torch.tensor([1.5], requires_grad=True)
    (ptd.replicated(r, g) * (me + 1)).sum().backward()
    res["replicated_grad"] = float(r.grad)
    sub = ptd.new_group([0, n - 1])
    res["new_group"] = (sub.rank, sub.nranks)
    if sub.is_member():
        res["sub_all_reduce"] = float(ptd.all_reduce(
            torch.tensor([1.0 + me]), group=sub))
    ptd.barrier()
    return res


def fail_on(bad_rank):
    """Rank `bad_rank` raises; the others wait in a collective for it."""
    if ptd.get_rank() == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    ptd.all_reduce(torch.ones(1))
    return ptd.get_rank()


def sleep_on(slow_rank, seconds):
    """Rank `slow_rank` sleeps `seconds`; the others return at once."""
    if ptd.get_rank() == slow_rank:
        time.sleep(seconds)
    return ptd.get_rank()


def _ep_layer(state, num_experts, d_model, d_ff, gate, capacity_factor):
    from paddle_tpu_torch.incubate.distributed.models import moe
    from paddle_tpu_torch.nn import Linear
    from paddle_tpu_torch.weights import load_reference_state

    experts = [torch.nn.Sequential(Linear(d_model, d_ff), torch.nn.GELU(),
                                   Linear(d_ff, d_model))
               for _ in range(num_experts)]
    layer = moe.MoELayer(d_model, experts, gate=dict(gate), device="cpu")
    load_reference_state(layer, state)
    layer.capacity_factor = capacity_factor
    return layer


def expert_parallel(state, x, ct, num_experts, d_model, d_ff, gate,
                    capacity_factor):
    """`MoELayer.expert_parallel_forward` of the layer with the reference
    weights `state` on the whole batch x (numpy, the same on every rank),
    then the gradient of sum(y * ct[rows]) + aux_loss. Returns this rank's
    rows, the aux loss, x's gradient, every parameter gradient that arose
    (float32 numpy, the port's layout) and the dropped share."""
    g = ptd.get_group()
    layer = _ep_layer(state, num_experts, d_model, d_ff, gate,
                      capacity_factor)
    xt = torch.from_numpy(x).requires_grad_()
    y = layer.expert_parallel_forward(xt, g)
    per = x.reshape(-1, d_model).shape[0] // g.nranks
    rows = slice(g.rank * per, (g.rank + 1) * per)
    ((y * torch.from_numpy(ct.reshape(-1, d_model)[rows])).sum()
     + layer.aux_loss).backward()
    _, tok_slot, _ = layer.dispatch_indices(
        xt.detach().reshape(-1, d_model)[rows])
    grads = {n: _np(p.grad) for n, p in layer.named_parameters()
             if p.grad is not None}
    return dict(y=_np(y), aux=float(layer.aux_loss), dx=_np(xt.grad),
                grads=grads, dropped=float((tok_slot < 0).float().mean()))
