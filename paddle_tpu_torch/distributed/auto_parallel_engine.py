"""The auto-parallel `Engine`: prepare / fit / evaluate / predict over a
`ProcessMesh` (counterpart of
paddle_tpu/distributed/auto_parallel_engine.py:1-288).

Upstream's Engine lowers a model through three passes, completion,
partitioning and resharding. The reference keeps completion and hands the
rest to GSPMD. The port has no compiler to hand it to, so its partitioner
is its own, over the port's collectives:

- completion, `complete_param_shardings`: every parameter's spec from
  fleet's mp marks (`mp_shardings`, the port's (out, in) layout), "mp"
  kept only where the mesh has an mp dimension of more than one rank;
  the batch's dim 0 split over the mesh's data dimensions ("dp",
  "sharding");
- partitioning, at `prepare()`: the model's mp layers bound to the mesh's
  mp group (`bind_mp_group`: a model built before the mesh holds dense
  weights and is cut to this rank's slice, GPT's fused QKV through its
  interleaved layout), and the step a `parallel.zero.ZeroTrainStep` over
  the data group with the mp group as its tp group: each rank takes its
  rows of every global batch, the gradients are summed over the data
  ranks in rank order and scaled by 1 / data ranks, as `DataParallel`
  does, and the update is the optimizer's own elementwise rule;
- with a "sharding" dimension of more than one rank the optimizer state is
  sharded over the data ranks (ZeRO-1, `stage=1`; the reference's :151-182
  shards the moments of replicated parameters over `sharding` alone).

`fit` runs the step over the loader's global batches (every rank feeds
the same batches) and writes the updated parameters back into the model
when it ends; `evaluate` / `predict` run the bound model on whole batches
(every rank the same; the mp collectives need every rank of the mp group).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Engine", "complete_param_shardings"]

_DATA_AXES = ("dp", "sharding")


def _axes_of(mesh, names=None):
    return [n for n in mesh.dim_names
            if (names is None or n in names) and mesh.get_dim_size(n) > 1]


def complete_param_shardings(layer, mesh):
    """The completion pass: (each parameter's spec, the batch's spec, the
    replicated spec), each a tuple with one entry a dimension as the
    reference's PartitionSpec."""
    from .fleet.meta_parallel.parallel_layers import mp_shardings

    mp = "mp" in _axes_of(mesh)
    params = {name: tuple(a if a == "mp" and mp else None for a in spec)
              for name, spec in mp_shardings(layer).items()}
    data = tuple(_axes_of(mesh, _DATA_AXES))
    spec = (None,) if not data else (data[0],) if len(data) == 1 else (data,)
    return params, spec, ()


def _data_group(mesh, axes):
    """This rank's group over the mesh's data dims: the mesh's own group
    for one, a new group for two (every rank makes every one, in order),
    this rank alone for none."""
    from .group import Group, _default, get_rank, new_group

    if len(axes) == 1:
        return mesh.get_group(axes[0])
    me = get_rank()
    if not axes:
        world = _default()
        return Group(0, [me], 0, None, world.backend, world.device)
    arr = mesh.mesh
    data_dims = [mesh.dim_names.index(a) for a in axes]
    rest = [d for d in range(arr.ndim) if d not in data_dims]
    moved = np.transpose(arr, rest + data_dims).reshape(
        -1, int(np.prod([arr.shape[d] for d in data_dims])))
    mine = None
    for row in moved.tolist():
        g = new_group(row)
        if me in row:
            mine = g
    return mine


class Engine:
    """auto.Engine: `model` trained and run over `mesh` (else the mesh of
    `set_mesh`) with `loss(outputs, labels)`, `optimizer` (an elementwise
    rule of the port's `optimizer`) and `metrics`."""

    def __init__(self, model, loss=None, optimizer=None, metrics=None,
                 strategy=None, mesh=None):
        from .auto_parallel import get_mesh

        self._model = model
        self._loss = loss
        self._opt = optimizer
        self._metrics = ([] if metrics is None else list(metrics)
                         if isinstance(metrics, (list, tuple)) else [metrics])
        self._strategy = strategy
        self._mesh = mesh if mesh is not None else get_mesh()
        self._prepared = False
        self._step = None
        self._full: Optional[Dict[str, torch.Tensor]] = None
        self._params = None
        self._opt_state = None
        self.history: Dict[str, List[float]] = {"loss": []}

    # ------------------------------------------------------------- prepare
    @torch.no_grad()
    def prepare(self) -> None:
        """Completion and partitioning (see the module docstring)."""
        from ..parallel.mesh import gather_dim
        from ..parallel.zero import ZeroTrainStep
        from ..serving.tp import interleave_qkv
        from .fleet.meta_parallel.parallel_layers import (_MPLayer,
                                                          bind_mp_group)

        if self._prepared:
            return
        if self._mesh is None:
            raise ValueError("Engine needs a mesh (pass mesh= or set_mesh)")
        mesh, model = self._mesh, self._model
        self._param_sh, self._data_sh, self._repl = complete_param_shardings(
            model, mesh)
        mp_group = mesh.get_group("mp") if "mp" in _axes_of(mesh) else None
        data_axes = _axes_of(mesh, _DATA_AXES)
        self._data_group = _data_group(mesh, data_axes)
        mp = mp_group.nranks if mp_group is not None else 1
        # the full logical parameters the step cuts its parts from: the
        # dense weights (QKV interleaved for this mp degree), or the parts
        # of a model already split over mp gathered back
        owner = {}
        for mname, mod in model.named_modules():
            for pname, p in mod.named_parameters(recurse=False):
                owner[f"{mname}.{pname}" if mname else pname] = (mod, p)
        full = {}
        for name, (mod, p) in owner.items():
            t = p.detach()
            if isinstance(mod, _MPLayer) and p.split_axis is not None \
                    and mp > 1:
                if mod.mp_size > 1:
                    t = gather_dim(t, p.split_axis, mod.group)
                elif getattr(mod, "interleave_heads", None) is not None:
                    t = interleave_qkv(t, mod.interleave_heads, mp)
            full[name] = t.clone()
        bind_mp_group(model, mp_group)
        self._full = full
        if self._opt is not None:
            specs = {n: s for n, s in self._param_sh.items() if "mp" in s}
            self._step = ZeroTrainStep(
                model, self._opt, self._loss_fn(),
                tp=mp, stage=1 if "sharding" in data_axes else 0,
                param_specs=specs, group=self._data_group,
                tp_group=mp_group)
        self._prepared = True

    def _loss_fn(self):
        from torch.func import functional_call

        model, loss = self._model, self._loss

        def loss_fn(params, x, y):
            return loss(functional_call(model, params, (x,)), y)

        return loss_fn

    def _ensure_state(self) -> None:
        """The step's parameters and optimizer state, made at the first
        fit (an evaluate / predict-only Engine never holds them)."""
        if self._params is None:
            self._params, self._opt_state = self._step.init_state(self._full)
            self._full = None

    # -------------------------------------------------------------- loops
    def _device(self) -> torch.device:
        return next(self._model.parameters()).device

    def _loader(self, data, batch_size, train=False):
        from ..io import DataLoader, Dataset

        if isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            # drop_last only where the step needs whole batches; evaluate
            # and predict cover the tail
            return DataLoader(data, batch_size=batch_size or 32,
                              drop_last=train, places=self._device())
        raise TypeError("Engine expects a Dataset or DataLoader")

    def fit(self, train_data, epochs: int = 1,
            batch_size: Optional[int] = None, verbose: int = 0,
            log_freq: int = 10):
        if self._opt is None or self._loss is None:
            raise ValueError("fit() needs both an optimizer and a loss")
        self.prepare()
        loader = self._loader(train_data, batch_size, train=True)
        self._ensure_state()
        self._model.train()
        try:
            for epoch in range(epochs):
                for batch in loader:
                    x, y = batch[0], batch[1]
                    self._opt._step_count += 1
                    loss, self._params, self._opt_state = self._step(
                        self._params, self._opt_state, (x, y),
                        self._opt.get_lr(), self._opt._step_count)
                    self.history["loss"].append(float(loss))
                if verbose:
                    print(f"[auto.Engine] epoch {epoch + 1}/{epochs} "
                          f"loss={self.history['loss'][-1]:.4f}")
        finally:
            # the model holds the step's parameters whatever happened
            with torch.no_grad():
                named = dict(self._model.named_parameters())
                for name, val in self._params.items():
                    named[name].copy_(val)
        return self.history

    def _run(self, batch_x):
        from ..parallel.mesh import tp_scope

        with tp_scope(self._mesh.get_group("mp")
                      if "mp" in self._mesh.dim_names else None):
            return self._model(batch_x)

    @torch.no_grad()
    def evaluate(self, eval_data, batch_size: Optional[int] = None,
                 verbose: int = 0):
        if self._loss is None:
            raise ValueError("evaluate() needs a loss")
        self.prepare()
        loader = self._loader(eval_data, batch_size)
        was = self._model.training
        self._model.eval()
        for m in self._metrics:
            m.reset()
        losses = []
        try:
            for batch in loader:
                x, y = batch[0], batch[1]
                out = self._run(x)
                losses.append(float(self._loss(out, y)))
                for m in self._metrics:
                    got = m.compute(out, y)
                    if isinstance(got, tuple):
                        m.update(*got)
                    else:
                        m.update(got)
        finally:
            self._model.train(was)
        result = {"loss": float(np.mean(losses))}
        for m in self._metrics:
            names, vals = m.name(), m.accumulate()
            if not isinstance(names, (list, tuple)):
                names, vals = [names], [vals]
            elif not isinstance(vals, (list, tuple)):
                vals = [vals]
            result.update(zip(names, vals))
        return result

    @torch.no_grad()
    def predict(self, test_data, batch_size: Optional[int] = None):
        self.prepare()
        loader = self._loader(test_data, batch_size)
        was = self._model.training
        self._model.eval()
        try:
            return [self._run(batch[0]).cpu().numpy() for batch in loader]
        finally:
            self._model.train(was)

    # ------------------------------------------------------ introspection
    def param_shardings(self) -> Dict[str, tuple]:
        self.prepare()
        return dict(self._param_sh)

    def optimizer_state_bytes(self) -> int:
        """Bytes of optimizer state this rank holds (0 before fit)."""
        from ..parallel.zero import ZeroTrainStep

        return (0 if self._opt_state is None
                else ZeroTrainStep.bytes_per_chip(self._opt_state))
