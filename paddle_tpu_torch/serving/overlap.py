"""Collective / compute overlap in the tensor-parallel step: the chunked
all-reduce pipeline (port of paddle_tpu/serving/overlap.py).

`ServingEngine(tp_size>1, tp_overlap=True, tp_overlap_chunks=K)` swaps the
serial reduction step of the TP runners (serving/tp.py, `SerialReduce`)
for `OverlapPlan.add_norm`: the rows of each reduction are cut into K
chunks (`parallel.mesh.chunk_bounds`), and chunk j+1's transport is issued
before chunk j is reduced and consumed, so that on a group of several
cards the copy between cards runs under the consumer's work.

- **Transport**: each shard's rows of the chunk copied to every device of
  the group; between cards the copy goes on a side CUDA stream of each
  card, ordered by events, so neither card's main stream waits for it.
  With the quantized all-reduce each shard first quantizes its rows
  (`quant.block_quantize`) and the int8 blocks and scales move.
- **Arithmetic**: each chunk is the serial reduction over its rows: the
  shard-order sum, or `quant.block_dequant_sum`, both elementwise, then
  `resid + (reduced + bias)` and the next norm, which is row by row. The
  chunks' outputs are concatenated, so every value is bit for bit the
  serial engine's, in fp32 and bf16 alike, and the streams are the serial
  engine's.
- **The two seams**: the attention half's reduction is pipelined with the
  residual add and the post-attention norm ahead of the MLP's column
  matmuls; layer i's final (down / ffn_out) reduction is carried into
  layer i+1 and pipelined with its residual add and input norm ahead of
  the QKV matmuls; the last layer's is pipelined with the final norm.

The consumer that a chunk runs is the residual add and the norm, not the
column matmuls as in the reference (which slices the matmuls by rows too).
A matrix product over a slice of the rows need not give the rows of the
whole product bit for bit: the row count picks the BLAS kernel and its
summation order. chip_smoke's `row_chunk_products` reads this for a
LLaMA-7B shard's products on the card (PERF.md: cut into 2 or 4 row
chunks, 9 of 64 bf16 and 33 of 64 fp32 products moved by a
rounding), and PyTorch's CPU products do the same; a run would then part
from the serial engine's streams. So the matmuls run once over all the
rows, as in the serial engine.

`measure_overlap_fraction` times, once at construction, the reduction
alone, the serial reduction followed by its consumer (a norm and an
(h, h) product) and the pipelined form of the same work, and reports the
hidden share of the reduction's wall: clip((serial - pipelined) /
reduction, 0, 1). On one card nothing moves between devices, so it reads
near 0 there, as the reference's does on a CPU mesh.

This module is imported only by an engine whose overlap is effectively on
(tp_size > 1, tp_overlap=True, tp_overlap_chunks > 1).
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import torch

from ..nn.layers import RMSNorm
from ..parallel.mesh import chunk_bounds, distinct, fixed_order_sum
from .tp import SerialReduce, _on, _resident, synchronize

__all__ = ["OverlapPlan", "pipeline_chunks", "measure_overlap_fraction"]


def pipeline_chunks(items: Sequence, transport, reduce, consume) -> None:
    """The double-buffered schedule: transport item 0; then for each item
    issue the NEXT item's transport before reducing and consuming this
    one. `transport(item)` returns an in-flight handle, `reduce(handle)`
    the reduced value, `consume(idx, reduced)` runs in item order."""
    if not items:
        return
    moved = transport(items[0])
    for idx in range(len(items)):
        nxt = transport(items[idx + 1]) if idx + 1 < len(items) else None
        consume(idx, reduce(moved))
        moved = nxt


class OverlapPlan(SerialReduce):
    """The chunked reduction step of an overlapped TP engine: the group's
    devices, the chunk count K and whether the payload moves quantized.
    `allreduce` stays the serial one (the collective probe times it)."""

    def __init__(self, shard_devices: Sequence[torch.device], chunks: int,
                 quantized: bool, lead: Optional[torch.device] = None):
        super().__init__(shard_devices, quantized, lead)
        self.tp_size = len(self.shard_devices)
        self.chunks = int(chunks)
        if self.tp_size < 2:
            raise ValueError(f"overlap needs tp_size >= 2, got "
                             f"{self.tp_size} (tp_size=1 has no collective "
                             "to hide)")
        if self.chunks < 2:
            raise ValueError(f"overlap needs chunks >= 2, got {chunks} "
                             "(chunks=1 IS the serial engine)")
        # one side stream a card, for the copies between cards
        self._side: Dict[torch.device, torch.cuda.Stream] = {}
        if self.quantized:
            from .quant import block_dequant_sum, block_quantize

            self._quantize, self._dequant_sum = (block_quantize,
                                                 block_dequant_sum)

    # -------------------------------------------------------- transport
    def _stream(self, dev: torch.device):
        s = self._side.get(dev)
        if s is None:
            s = self._side[dev] = torch.cuda.Stream(dev)
        return s

    def _move(self, t: torch.Tensor, dev: torch.device):
        """`t` on `dev`, and the event a consumer on `dev` waits on (None:
        nothing moved). A copy between cards runs on both cards' side
        streams, after `t` is produced on its own card's stream."""
        src = t.device
        if src == dev:
            return t, None
        if src.type != "cuda":
            return t.to(dev), None
        side_src, side_dst = self._stream(src), self._stream(dev)
        side_src.wait_stream(torch.cuda.current_stream(src))
        with torch.cuda.stream(side_src), torch.cuda.stream(side_dst):
            out = t.to(dev, non_blocking=True)
        t.record_stream(side_src)
        out.record_stream(torch.cuda.current_stream(dev))
        done = torch.cuda.Event()
        done.record(side_dst)
        return out, done

    def _transport(self, parts2d, targets, bound):
        """Issue chunk `bound`'s moves to every target: device -> (moved
        payload, events to wait on)."""
        lo, hi = bound
        if self.quantized:
            payload = [self._quantize(p[lo:hi]) for p in parts2d]
        else:
            payload = [(p[lo:hi],) for p in parts2d]
        moved = {}
        for dev in targets:
            got, events = [], []
            for pieces in payload:
                row = []
                for t in pieces:
                    out, ev = self._move(t, dev)
                    row.append(out)
                    if ev is not None:
                        events.append(ev)
                got.append(row)
            moved[dev] = (got, events)
        return moved

    def _reduce(self, moved, h: int, dtype):
        out = {}
        for dev, (got, events) in moved.items():
            for ev in events:
                torch.cuda.current_stream(dev).wait_event(ev)
            if self.quantized:
                out[dev] = self._dequant_sum([g[0] for g in got],
                                             [g[1] for g in got], h, dtype)
            else:
                out[dev] = fixed_order_sum([g[0] for g in got])
        return out

    # ------------------------------------------------------ the pipeline
    def add_norm(self, partials, bias, resid, norms):
        """`SerialReduce.add_norm`, pipelined over row chunks with the
        same arithmetic."""
        shape = partials[0].shape
        h, dtype = shape[-1], partials[0].dtype
        parts2d = [p.reshape(-1, h) for p in partials]
        bounds = chunk_bounds(self.chunks, parts2d[0].shape[0])
        targets = list(norms)
        res2d = {dev: _resident(resid, dev).reshape(-1, h)
                 for dev in targets}
        xs: Dict[torch.device, List] = {dev: [] for dev in targets}
        ns: Dict[torch.device, List] = {dev: [] for dev in targets}

        def consume(idx, red):
            lo, hi = bounds[idx]
            for dev, norm in norms.items():
                y = red[dev] if bias is None else red[dev] + bias[dev]
                xc = res2d[dev][lo:hi] + y
                xs[dev].append(xc)
                with self._on(dev):
                    ns[dev].append(norm(xc))

        pipeline_chunks(bounds,
                      lambda b: self._transport(parts2d, targets, b),
                      lambda m: self._reduce(m, h, dtype), consume)
        return ({dev: torch.cat(v).reshape(shape) for dev, v in xs.items()},
                {dev: torch.cat(v).reshape(shape) for dev, v in ns.items()})


# ------------------------------------------------------------------ probes
def measure_overlap_fraction(devices: Sequence[torch.device], hidden: int,
                             chunks: int, quantized: bool,
                             dtype: torch.dtype = torch.float32,
                             rows: int = 8, best_of: int = 3) -> float:
    """Time (a) the reduction alone, (b) the serial reduction, residual
    add and norm followed by an (h, h) product on the group's first
    device, (c) the pipelined form of (b), each warmed twice and best of
    `best_of`, and return the hidden share of the reduction's wall:
    clip((b - c) / a, 0, 1)."""
    devices = tuple(devices)
    serial = SerialReduce(devices, quantized)
    plan = OverlapPlan(devices, chunks, quantized)
    lead = devices[0]
    h = int(hidden)
    parts = [torch.full((1, rows, h), 0.5, dtype=dtype, device=dev)
             for dev in devices]
    resid = {dev: torch.ones((1, rows, h), dtype=dtype, device=dev)
             for dev in distinct(devices)}
    norms = {lead: RMSNorm(h, device=lead, dtype=dtype)}
    w = (torch.arange(h * h, device=lead, dtype=torch.float32) % 13.0
         ).reshape(h, h).mul_(0.01).to(dtype)

    def reduce_only():
        serial.allreduce(parts, [lead])

    def step(reduce):
        def run():
            _, normed = reduce.add_norm(parts, None, resid, norms)
            with _on(lead):
                normed[lead] @ w
        return run

    def timed(fn) -> float:
        best: Optional[float] = None
        for i in range(2 + max(int(best_of), 1)):
            t0 = time.perf_counter()
            fn()
            synchronize(devices)
            dt = time.perf_counter() - t0
            if i >= 2:
                best = dt if best is None else min(best, dt)
        return float(best)

    t_coll = timed(reduce_only)
    t_serial = timed(step(serial))
    t_overlap = timed(step(plan))
    if t_coll <= 0.0:
        return 0.0
    return float(max(0.0, min(1.0, (t_serial - t_overlap) / t_coll)))
