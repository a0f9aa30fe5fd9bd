"""Carry weights from the JAX package into the port, by name.

`load_reference_state(model, params)` takes the dict that the reference's
`extract_state` (paddle_tpu/jit/functional.py:21) returns, keyed by
`named_parameters()` names, with values as numpy arrays (or anything
`np.asarray` takes), and copies it into the port's model in place.
Paddle's `Linear.weight` is (in, out) and PyTorch's is (out, in), so
Linear weights are transposed (fleet's column / row parallel layers',
sequence-parallel ones included); Embedding and norm weights cross as they are. A missing or extra
key, or a shape that does not match, raises.

`load_reference_layer(layer, state)` is the same for the Paddle dygraph
surface: it takes a JAX `Layer`'s `state_dict()` (or any mapping of its
names to arrays) into the port's `nn.Layer` of the same structure. The
layouts agree there (paddle's (in, out) Linear on both sides), so nothing
is transposed; every name and shape is checked.

A tensor-parallel model or a pipeline stage loads its shard of the full
parameters. Each of fleet's mp layers knows its mp rank: a
column-parallel weight (and bias) takes its rows of the port's (out, in)
layout, a row-parallel weight its columns, a vocab-parallel embedding its
rows, and GPT's fused QKV goes through `serving.tp.interleave_qkv` first,
so a rank's rows are its (3, heads / mp, hd) block. A `PipelineLayer`
holding one stage takes the entries of its own layers (named `i.` by
their index in the whole list, as the reference's) and leaves the others.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["load_reference_state", "load_reference_layer"]


@torch.no_grad()
def load_reference_state(model: nn.Module, params: Mapping[str, object]
                         ) -> None:
    from .distributed.fleet.meta_parallel.parallel_layers import (
        VocabParallelEmbedding, _MPLayer)
    from .serving.tp import interleave_qkv

    own = dict(model.named_parameters())
    missing = sorted(own.keys() - params.keys())
    extra = sorted(params.keys() - own.keys())
    if getattr(model, "_stage_id", None) is not None:
        extra = []      # the other stages' layers
    if missing or extra:
        raise KeyError(f"reference state does not match the model: missing "
                       f"{missing}, unexpected {extra}")
    owner = {}
    for mname, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            owner[f"{mname}.{pname}" if mname else pname] = (mod, pname)
    for name, p in own.items():
        mod, pname = owner[name]
        # via fp32: numpy has no bfloat16, and the copy casts to p's type
        arr = np.asarray(params[name], dtype=np.float32)
        if pname == "weight" and (isinstance(mod, nn.Linear) or (
                isinstance(mod, _MPLayer)
                and not isinstance(mod, VocabParallelEmbedding))):
            arr = arr.T
        full = torch.tensor(arr)
        if isinstance(mod, _MPLayer):
            heads = getattr(mod, "interleave_heads", None)
            if heads is not None:
                full = interleave_qkv(full, heads, mod.mp_size)
            full = mod.shard_of(pname, full)
        if tuple(full.shape) != tuple(p.shape):
            raise ValueError(f"{name}: reference shape {tuple(full.shape)} "
                             f"does not match the port's {tuple(p.shape)}")
        p.copy_(full)


def load_reference_layer(layer, state: Mapping[str, object]) -> None:
    """Copy a JAX Layer's state dict into the port's paddle `nn.Layer` of
    the same structure, name by name and in place; a missing or extra
    name, or another shape, raises."""
    own = layer.state_dict()
    missing = sorted(own.keys() - state.keys())
    extra = sorted(state.keys() - own.keys())
    if missing or extra:
        raise KeyError(f"reference state does not match the layer: missing "
                       f"{missing}, unexpected {extra}")
    arrays = {}
    for name, t in own.items():
        arr = np.asarray(state[name], dtype=np.float32) if np.asarray(
            state[name]).dtype.kind == "f" else np.asarray(state[name])
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{name}: reference shape {tuple(arr.shape)} "
                             f"does not match the port's {tuple(t.shape)}")
        arrays[name] = arr
    layer.set_state_dict(arrays)
