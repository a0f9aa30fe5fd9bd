"""Distributed checkpoint: `save_state_dict` / `load_state_dict` with
resharding, and the asynchronous save (counterpart of
paddle_tpu/distributed/checkpoint.py:1-243).

The on-disk layout is the reference's, so a checkpoint crosses packages:
each rank writes `shard_{rank}.pkl` (a pickle of numpy payloads keyed
`"{name}@{index}"`, scalars keyed by name) and `meta_rank{rank}.json`, and
the coordinator merges the ranks' records into `metadata.json`: each
tensor's global shape, dtype and shard index ranges ([start, stop) a
dimension) and the files that hold them.

A tensor's shard comes from its placement: a `shard_tensor` result (its
`process_mesh` / `placements` / `global_shape`), or a split parameter of
fleet's mp layers (`is_distributed`, `split_axis`, `mp_rank`, `mp_size`:
pass `model.state_dict(keep_vars=True)` so the tensors carry them; GPT's
fused QKV, split by head, also `interleave_heads`: its rank's q, k and v
rows are three blocks of the whole tensor in the dense layout, so that
checkpoint too loads at any mp degree); any other tensor is whole. The
port's optimizers give a slot of its parameter's shape the parameter's
placement. A block that several ranks hold (a replicated tensor, a
data-parallel copy) is written once, by the lowest rank that holds it,
which one small object all-gather settles at each save; scalars are
written by rank 0. The ranks that hold one block must hold the same
values: each sends a digest of its blocks with their ranges, and the
save raises where two differ (a split tensor that lost its placement, as
`state_dict()` without `keep_vars` loses it, would otherwise be written
as rank 0's part alone). The merged metadata is the reference's,
deduplicated.

`load_state_dict` fills the target's tensors in place: it assembles each
global tensor from whatever shards the checkpoint has, then cuts this
rank's part for the target's current placement, so a checkpoint saved at
one degree loads at another. bfloat16 has no numpy dtype on every
machine: its bits are written as int16 under dtype "bfloat16" (the port
reads them back; the JAX package does not).

`async_save=True`: the device-to-host snapshot is taken before the call
returns (pinned copies, then a synchronize), so training may overwrite
the tensors at once; only the file writes run on a thread. The barrier
and the coordinator's merge run at the next save or at `wait_save()`, on
the caller's thread: no collective ever runs on the writer thread (two
threads on one gloo group would interleave).
"""
from __future__ import annotations

import json
import os
import pickle
import threading
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "wait_save"]

_META = "metadata.json"

# the async save in flight: [(writer thread, finalize)]
_PENDING: List = []


def wait_save() -> None:
    """Block until the async save in flight (if any) is durable: every
    rank's files written and the coordinator's metadata merged. Every rank
    calls it (the merge is fenced by barriers)."""
    while _PENDING:
        thread, finalize = _PENDING.pop()
        thread.join()
        finalize()


def _flatten(d, prefix="") -> Dict[str, Tuple[dict, str]]:
    """Dotted name -> (the dict holding the value, its key)."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = (d, k)
    return out


def _placement(t: torch.Tensor):
    """(global shape, blocks) of a tensor, from what it carries: each
    block ([start, stop) ranges of the global tensor, the local slices
    that hold it or None for the whole local tensor). No blocks: this
    rank holds none of it."""
    from .auto_parallel import block_ranges

    mesh = getattr(t, "process_mesh", None)
    if mesh is not None:
        if any(p.is_partial() for p in t.placements):
            raise ValueError("reshard a Partial tensor to Replicate before "
                             "saving it")
        gshape = tuple(t.global_shape)
        ranges = block_ranges(mesh, t.placements, gshape, _rank())
        return gshape, [] if ranges is None else [(ranges, None)]
    axis = getattr(t, "split_axis", None)
    if getattr(t, "is_distributed", False) is True and axis is not None:
        n, r, size = int(t.mp_size), int(t.mp_rank), t.shape[axis]
        gshape = list(t.shape)
        gshape[axis] *= n
        whole = [[0, d] for d in gshape]
        if getattr(t, "interleave_heads", None) is None:
            whole[axis] = [r * size, (r + 1) * size]
            return tuple(gshape), [(whole, None)]
        # GPT's fused QKV split by head: the local rows are (3, heads / n,
        # hd), its q, k and v rows three blocks of the whole (3, heads,
        # hd) rows, so the checkpoint holds the whole at any degree
        per, blocks = size // 3, []
        for j in range(3):
            ranges = [list(x) for x in whole]
            lo = j * per * n + r * per
            ranges[axis] = [lo, lo + per]
            local = [slice(None)] * t.dim()
            local[axis] = slice(j * per, (j + 1) * per)
            blocks.append((ranges, tuple(local)))
        return tuple(gshape), blocks
    return tuple(t.shape), [([[0, int(d)] for d in t.shape], None)]


def _group(process_group):
    from .group import _default

    return process_group if process_group is not None else _default()


def _rank() -> int:
    from .group import get_rank

    return get_rank()


def _np_dtype_name(t: torch.Tensor) -> str:
    return "bfloat16" if t.dtype == torch.bfloat16 else str(
        torch.empty(0, dtype=t.dtype).numpy().dtype)


def _host_snapshot(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Every tensor copied to host memory (pinned, one synchronize for
    the card's), as numpy (bfloat16 as its int16 bits)."""
    host = {}
    cuda = False
    for name, t in tensors.items():
        t = t.detach()
        if t.is_cuda:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            cuda = True
        else:
            buf = t.clone()
        host[name] = buf
    if cuda:
        torch.cuda.synchronize()
    return {name: (b.view(torch.int16) if b.dtype == torch.bfloat16
                   else b).numpy() for name, b in host.items()}


_DIGEST_WORDS = 1 << 24


def _digests(tensors) -> List[List[int]]:
    """A digest of each tensor's bytes, exact and independent of the
    order of summation: the sums of the 16-bit halves of its 32-bit words,
    plain and weighted by position (no sum overflows int64). Equal
    tensors give equal digests; one host read for them all."""
    out = []
    for t in tensors:
        b = t.detach().contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.nn.functional.pad(b, (0, 4 - b.numel() % 4))
        w = b.view(torch.int32)
        acc = torch.zeros(4, dtype=torch.int64, device=w.device)
        for i in range(0, w.numel(), _DIGEST_WORDS):
            c = w[i:i + _DIGEST_WORDS].to(torch.int64)
            pos = torch.arange(i, i + c.numel(), dtype=torch.int64,
                               device=c.device) % 65521 + 1
            lo, hi = c & 0xFFFF, (c >> 16) & 0xFFFF
            acc += torch.stack([lo.sum(), hi.sum(), (lo * pos).sum(),
                                (hi * pos).sum()])
        out.append(acc)
    if not out:
        return []
    return torch.stack([a.cpu() for a in out]).tolist()


def _index_key(name: str, ranges) -> str:
    return f"{name}@{tuple(slice(a, b, None) for a, b in ranges)}"


def save_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0,
                    async_save: bool = False) -> None:
    """Write this rank's shards and records under directory `path`, and
    (now, or with `async_save` at the next save / `wait_save()`) the
    merged metadata. Every rank of the group calls it."""
    from .communication import all_gather_object, barrier

    wait_save()
    os.makedirs(path, exist_ok=True)
    g = _group(process_group)
    pid, world = g.rank, g.nranks
    tensors, scalars, blocks = {}, {}, {}
    for name, (holder, key) in _flatten(state_dict).items():
        val = holder[key]
        if isinstance(val, torch.Tensor):
            gshape, held = _placement(val)
            if held:
                tensors[name] = (val, gshape, held)
                blocks[name] = json.dumps([ranges for ranges, _ in held])
        else:
            scalars[name] = val
    # the lowest rank holding a block writes it; the others hold the same
    names = sorted(blocks)
    digests = (_digests([tensors[n][0] for n in names]) if world > 1
               else [None] * len(names))
    marks = {n: (blocks[n], d) for n, d in zip(names, digests)}
    seen = all_gather_object([], marks, g) if world > 1 else [marks]
    # every rank reads every rank's marks, so all raise together
    mine = set()
    for name in sorted(set().union(*seen)):
        holders = {}
        for r in range(world):
            if name in seen[r]:
                b, digest = seen[r][name]
                holders.setdefault(b, []).append((r, digest))
        for b, held in holders.items():
            if len({str(d) for _, d in held}) > 1:
                raise ValueError(
                    f"save_state_dict: ranks {[r for r, _ in held]} hold "
                    f"block {b} of {name!r} with different values; give "
                    "a split tensor its placement (state_dict("
                    "keep_vars=True) keeps an mp layer's)")
            if held[0][0] == pid:
                mine.add(name)
    shard_file = f"shard_{pid}.pkl"
    meta = {"version": 1, "tensors": {}, "world": world}
    payload = _host_snapshot({n: tensors[n][0] for n in mine})
    keyed = {}
    for name in sorted(mine):
        val, gshape, held = tensors[name]
        shards = []
        for ranges, local in held:
            key = _index_key(name, ranges)
            keyed[key] = (payload[name] if local is None
                          else np.ascontiguousarray(payload[name][local]))
            shards.append({"key": key, "index": ranges})
        meta["tensors"][name] = {"shape": list(gshape),
                                 "dtype": _np_dtype_name(val),
                                 "shards": shards, "file": shard_file}
    if pid == 0:
        for name, val in scalars.items():
            keyed[name] = val
            meta["tensors"][name] = {"scalar": True, "file": shard_file}

    def write_local():
        with open(os.path.join(path, shard_file), "wb") as f:
            pickle.dump(keyed, f, protocol=4)
        rank_meta = os.path.join(path, f"meta_rank{pid}.json")
        with open(rank_meta + ".tmp", "w") as f:
            json.dump(meta, f)
        os.replace(rank_meta + ".tmp", rank_meta)   # never half-written

    def finalize():
        # every rank's files are fresh before the merge
        if world > 1:
            barrier(g)
        if pid == coordinator_rank:
            _merge(path, world)
        if world > 1:
            barrier(g)      # no rank returns before the metadata lands

    if async_save:
        t = threading.Thread(target=write_local, daemon=True,
                             name="ptt-async-checkpoint")
        t.start()
        _PENDING.append((t, finalize))
        return
    write_local()
    finalize()


def _merge(path: str, world: int) -> None:
    merged = {"version": 1, "tensors": {}, "world": world}
    for r in range(world):
        rmeta_path = os.path.join(path, f"meta_rank{r}.json")
        _wait_for_file(rmeta_path)
        with open(rmeta_path) as f:
            rmeta = json.load(f)
        for name, info in rmeta["tensors"].items():
            have = merged["tensors"].get(name)
            if have is None:
                merged["tensors"][name] = info
            elif not info.get("scalar"):
                seen = {json.dumps(s["index"]) for s in have["shards"]}
                have.setdefault("files", [have["file"]])
                for s in info["shards"]:
                    if json.dumps(s["index"]) not in seen:
                        have["shards"].append(s)
                if info["file"] not in have["files"]:
                    have["files"].append(info["file"])
    meta_path = os.path.join(path, _META)
    with open(meta_path + ".tmp", "w") as f:
        json.dump(merged, f)
    os.replace(meta_path + ".tmp", meta_path)


def _wait_for_file(p: str, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while not os.path.exists(p):
        if time.monotonic() > deadline:
            raise TimeoutError(f"coordinator timed out waiting for {p}; did "
                               "a rank die before writing its checkpoint "
                               "metadata?")
        time.sleep(0.05)


def _global(info, payload) -> np.ndarray:
    bf16 = info["dtype"] == "bfloat16"
    full = np.zeros(info["shape"], dtype=np.int16 if bf16
                    else np.dtype(info["dtype"]))
    for sh in info["shards"]:
        chunk = payload[sh["key"]]
        if sh["index"]:
            full[tuple(slice(a, b) for a, b in sh["index"])] = chunk
        else:
            full[...] = chunk
    return full


def load_state_dict(state_dict: Dict, path: str, process_group=None,
                    coordinator_rank: int = 0) -> Dict:
    """Fill `state_dict`'s tensors in place (scalars replaced) from the
    checkpoint at `path`, each cut to its current placement."""
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    # only the files the metadata names: a stale shard of an earlier,
    # larger world must not override fresh values
    live = set()
    for info in meta["tensors"].values():
        live.update(info.get("files", [info["file"]]))
    payload = {}
    for fname in sorted(live):
        with open(os.path.join(path, fname), "rb") as f:
            payload.update(pickle.load(f))
    for name, (holder, key) in _flatten(state_dict).items():
        info = meta["tensors"].get(name)
        if info is None:
            raise KeyError(f"checkpoint at {path} has no tensor {name!r}")
        if info.get("scalar"):
            holder[key] = payload[name]
            continue
        full = torch.from_numpy(_global(info, payload))
        if info["dtype"] == "bfloat16":
            full = full.view(torch.bfloat16)
        cur = holder[key]
        if not isinstance(cur, torch.Tensor):
            holder[key] = full
            continue
        gshape, held = _placement(cur)
        if list(gshape) != list(info["shape"]):
            raise ValueError(f"{name}: checkpoint shape {info['shape']} does "
                             f"not match the target's {list(gshape)}")
        with torch.no_grad():
            for ranges, local in held:
                part = full[tuple(slice(a, b) for a, b in ranges)]
                (cur if local is None else cur[local]).copy_(part)
    return state_dict
