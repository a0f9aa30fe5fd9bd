"""paddle.Model for the port (counterpart of paddle_tpu/hapi/model.py):
`prepare`, `train_batch` / `eval_batch` / `predict_batch`, `fit` /
`evaluate` / `predict`, `save` / `load`, `parameters` and `summary`, over
a network in one process or data-parallel across ranks.

The reference builds one jitted program a step (forward, loss,
`jax.value_and_grad`, the optimizer's functional update). The port's
step is eager: the forward under the amp context (`amp_configs` "O1" /
"O2": `auto_cast` at that level, as the reference's `_amp_ctx`; no
`decorate`), the loss outside it, torch autograd, then the optimizer's
`step()` and `clear_grad()`. BatchNorm's running statistics update in
place during the forward. Metrics update on the host from the step's
outputs and labels.

Batches are Paddle Tensors, torch tensors or numpy arrays; they are put
on the network's device (its parameters').

Data parallelism. The reference runs one program whose batch XLA shards
over the dp axis (`_dp_shardings`, the pinned step shardings, the
multi-controller glue). Here every rank is a process that calls the same
Model methods on its own rows, as under Paddle's launcher:

- `Model(DataParallel(net))`, `Model(fleet.distributed_model(net))` at
  pure dp and `Model` over `group_sharded_parallel`'s wrapper (levels os,
  os_g, p_g_os) run the eager step on the rank's rows. DataParallel's
  reducer averages the gradients over its group; a GroupSharded network
  steps the wrapper's sharded optimizer (`sharded_optimizer`), whatever
  optimizer `prepare` was given, and that update reduces them.
- The losses returned are the global batch's: for equal shards the mean
  over the group of the ranks' losses (summed in rank order, so every
  rank reads the same bits), as the reference's replicated loss.
- Metrics update from the outputs and labels all-gathered in rank order,
  so every rank holds the global batch's metric state (the reference's
  `gather_for_metrics`); `predict_batch` / `predict` return the gathered
  outputs.
- Unequal local batch sizes raise ValueError on every rank (the
  reference's divisibility check).
- `fit` / `evaluate` / `predict` given a Dataset load it through a
  `DistributedBatchSampler` over the group with `batch_size` rows a rank,
  as Paddle's hapi does (the reference's `batch_size` is the global
  batch, sharded over the devices).
- `save` writes on the group's first rank only (stage 3: the gathered
  parameters), then every rank waits for it.
"""
from __future__ import annotations

import contextlib
import os
from typing import List

import numpy as np
import torch

from .. import amp as amp_mod
from ..core.tensor import Tensor
from ..framework.io import load as fw_load
from ..framework.io import save as fw_save
from ..io import DataLoader, Dataset
from ..metric import Metric
from .callbacks import config_callbacks

__all__ = ["Model"]


def _to_list(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _wrapped(network):
    """(the layer the network runs, the group its batch is split over, the
    sharded optimizer to step): the group and optimizer are None for a
    network in one process."""
    from ..distributed.parallel import DataParallel
    from ..parallel.zero import _ShardedBase

    if isinstance(network, DataParallel):
        group, opt = network.group, None
    elif isinstance(network, _ShardedBase):
        group, opt = network.group, network.sharded_optimizer
    else:
        return network, None, None
    if group.nranks == 1:
        group = None
    return network._layers, group, opt


class Model:
    """A network with fit / evaluate / predict (paddle.Model)."""

    def __init__(self, network, inputs=None, labels=None):
        self.network = network
        self._layer, self._group, self._sharded_opt = _wrapped(network)
        self._inputs = _to_list(inputs) or None
        self._labels = _to_list(labels) or None
        self._optimizer = None
        self._loss = None
        self._metrics: List[Metric] = []
        self._amp_level = None
        self._amp_custom = {}
        self.stop_training = False

    # ------------------------------------------------------------ prepare
    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_configs=None):
        self._optimizer = optimizer
        if loss is not None and not callable(loss):
            raise TypeError("loss must be callable or an nn.Layer")
        self._loss = loss
        self._metrics = _to_list(metrics)
        for m in self._metrics:
            if not isinstance(m, Metric):
                raise TypeError(f"metric {m!r} is not a paddle Metric")
        self._amp_level, self._amp_custom = None, {}
        if amp_configs is not None:
            if isinstance(amp_configs, str):
                self._amp_level = amp_configs
            else:
                self._amp_level = amp_configs.get("level", "O1")
                self._amp_custom = {k: v for k, v in amp_configs.items()
                                    if k != "level"}

    def _amp_ctx(self):
        if self._amp_level in ("O1", "O2"):
            return amp_mod.auto_cast(
                enable=True, level=self._amp_level,
                custom_white_list=self._amp_custom.get("custom_white_list"),
                custom_black_list=self._amp_custom.get("custom_black_list"),
                dtype=self._amp_custom.get("dtype", "bfloat16"))
        return contextlib.nullcontext()

    # ----------------------------------------------------------- batches
    def _device(self):
        for _, p in torch.nn.Module.named_parameters(self._layer):
            return p.device
        from ..device import resolve_device

        return resolve_device(None)

    def _tensors(self, xs):
        dev = self._device()
        out = []
        for x in _to_list(xs):
            if isinstance(x, Tensor):
                t = x._t
            elif isinstance(x, torch.Tensor):
                t = x
            else:
                t = torch.as_tensor(np.asarray(x))
            out.append(Tensor._wrap(t.to(dev, non_blocking=True)))
        return out

    def _split_batch(self, data):
        data = _to_list(data)
        if self._inputs is not None:
            n_in = len(self._inputs)
        elif self._labels is not None:
            n_in = len(data) - len(self._labels)
        elif self._loss is not None and len(data) > 1:
            n_in = len(data) - 1
        else:
            n_in = len(data)
        return data[:n_in], data[n_in:]

    def _forward(self, inputs):
        with self._amp_ctx():
            return _to_list(self.network(*inputs))

    def _losses(self, outs, labels):
        return _to_list(self._loss(*(outs + labels)))

    def _gathered(self, ts):
        """Each torch tensor's rows from every rank of the group, in rank
        order (floating ones in fp32); `ts` themselves in one process."""
        if self._group is None:
            return ts
        from ..distributed.communication import all_gather

        return [torch.cat(all_gather(None, t.float().contiguous() if
                                     t.is_floating_point() else
                                     t.contiguous(), self._group))
                for t in ts]

    def _check_batch(self, inputs):
        """ValueError on every rank unless the ranks' batches are equal."""
        if self._group is None or not inputs:
            return
        from ..distributed.communication import all_gather

        dev = self._device() if self._group.backend == "nccl" else "cpu"
        mine = torch.tensor([inputs[0]._t.shape[0]], device=dev)
        sizes = [int(t) for t in all_gather(None, mine, self._group)]
        if len(set(sizes)) > 1:
            raise ValueError(
                f"data-parallel local batch sizes differ across the ranks "
                f"{sizes}; use drop_last=True or a DistributedBatchSampler "
                "so every rank gets an equal shard")

    def _update_metrics(self, outs, labels):
        results = []
        if self._metrics:
            ts = self._gathered([t._t.detach() for t in outs + labels])
        for m in self._metrics:
            pre = m.compute(*ts)
            results.append(m.update(*_to_list(pre)))
        return results

    def _numpy(self, losses):
        """The losses as numpy arrays: across ranks the mean over the group
        of each rank's, summed in rank order."""
        ts = [l._t.detach().float() for l in losses]
        if self._group is not None and ts:
            from ..parallel.mesh import ordered_psum

            flat = ordered_psum(torch.cat([t.reshape(-1) for t in ts]),
                                self._group) * (1.0 / self._group.nranks)
            ts = [part.reshape(t.shape) for part, t in zip(
                flat.split([t.numel() for t in ts]), ts)]
        return [t.cpu().numpy() for t in ts]

    def train_batch(self, inputs, labels=None, update=True):
        """One step: forward, loss, backward, the optimizer's step. Returns
        the losses as numpy arrays (and the metrics' values)."""
        if self._optimizer is None or self._loss is None:
            raise RuntimeError("call prepare(optimizer, loss) before training")
        if not update:
            raise NotImplementedError(
                "gradient accumulation (update=False) is refused, as in the "
                "reference")
        self.network.train()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        self._check_batch(inputs)
        outs = self._forward(inputs)
        losses = self._losses(outs, labels)
        total = sum(l._t.float().sum() for l in losses)
        total.backward()
        opt = self._sharded_opt or self._optimizer
        opt.step()
        opt.clear_grad()
        metrics = self._update_metrics(outs, labels)
        loss_np = self._numpy(losses)
        return (loss_np, metrics) if metrics else loss_np

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        self._check_batch(inputs)
        with torch.no_grad():
            outs = self._forward(inputs)
            losses = self._losses(outs, labels) if (
                self._loss is not None and labels) else []
        metrics = self._update_metrics(outs, labels)
        loss_np = self._numpy(losses)
        return (loss_np, metrics) if metrics else loss_np

    def predict_batch(self, inputs):
        """The outputs as numpy arrays (across ranks: every rank's rows,
        in rank order)."""
        self.network.eval()
        inputs = self._tensors(inputs)
        self._check_batch(inputs)
        with torch.no_grad():
            outs = self._forward(inputs)
        outs = self._gathered([o._t for o in outs])
        return [o.float().cpu().numpy() if o.is_floating_point()
                else o.cpu().numpy() for o in outs]

    # ---------------------------------------------------------------- fit
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            if self._group is not None:     # `batch_size` rows a rank
                from ..io import DistributedBatchSampler

                sampler = DistributedBatchSampler(
                    data, batch_size, num_replicas=self._group.nranks,
                    rank=self._group.rank, shuffle=shuffle,
                    drop_last=drop_last)
                return DataLoader(data, places=self._device(),
                                  batch_sampler=sampler,
                                  num_workers=num_workers)
            return DataLoader(data, places=self._device(),
                              batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train `epochs` epochs (or `num_iters` steps), evaluating every
        `eval_freq` epochs. Across ranks a Dataset is read `batch_size`
        rows a rank (see the module docstring)."""
        assert train_data is not None, "train_data must be given"
        if accumulate_grad_batches != 1:
            raise NotImplementedError(
                "gradient accumulation is refused, as in the reference")
        train_loader = self._make_loader(train_data, batch_size, shuffle,
                                         num_workers, drop_last)
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        try:
            steps = len(train_loader)
        except TypeError:
            steps = None
        cbks = config_callbacks(
            callbacks, model=self, epochs=epochs, steps=steps,
            batch_size=batch_size, log_freq=log_freq, verbose=verbose,
            save_freq=save_freq, save_dir=save_dir,
            metrics=self._metrics_name())
        self.stop_training = False
        cbks.on_train_begin({})
        it, logs = 0, {}
        for epoch in range(epochs):
            sampler = getattr(train_loader, "batch_sampler", None)
            if hasattr(sampler, "set_epoch"):
                sampler.set_epoch(epoch)
            cbks.on_epoch_begin(epoch, {})
            for m in self._metrics:
                m.reset()
            logs = {}
            for step, data in enumerate(train_loader):
                cbks.on_train_batch_begin(step, {})
                inputs, labels = self._split_batch(data)
                result = self.train_batch(inputs, labels)
                logs = self._merge_logs(result)
                cbks.on_train_batch_end(step, logs)
                it += 1
                if num_iters is not None and it >= num_iters:
                    self.stop_training = True
                    break
            cbks.on_epoch_end(epoch, logs)
            if eval_loader is not None and (epoch + 1) % eval_freq == 0:
                self._run_eval(eval_loader, cbks)
            if self.stop_training:
                break
        cbks.on_train_end(logs)

    def _merge_logs(self, result):
        loss_np = result[0] if isinstance(result, tuple) else result
        logs = {"loss": [float(np.sum(l)) for l in loss_np]}
        for m in self._metrics:
            res = m.accumulate()
            names = m.name() if isinstance(m.name(), list) else [m.name()]
            vals = res if isinstance(res, list) else [res]
            logs.update(zip(names, vals))
        return logs

    def _run_eval(self, eval_loader, cbks):
        cbks.on_eval_begin({})
        for m in self._metrics:
            m.reset()
        logs = {}
        for step, data in enumerate(eval_loader):
            cbks.on_eval_batch_begin(step, {})
            inputs, labels = self._split_batch(data)
            logs = self._merge_logs(self.eval_batch(inputs, labels))
            cbks.on_eval_batch_end(step, logs)
        cbks.on_eval_end(logs)
        return logs

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None, num_iters=None):
        eval_loader = self._make_loader(eval_data, batch_size, False,
                                        num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose,
                                metrics=self._metrics_name())
        return self._run_eval(eval_loader, cbks)

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, verbose=1, callbacks=None):
        loader = self._make_loader(test_data, batch_size, False, num_workers)
        cbks = config_callbacks(callbacks, model=self, verbose=verbose)
        cbks.on_predict_begin({})
        outputs = []
        for step, data in enumerate(loader):
            cbks.on_predict_batch_begin(step, {})
            inputs, _ = self._split_batch(data)
            outputs.append(self.predict_batch(inputs))
            cbks.on_predict_batch_end(step, {})
        cbks.on_predict_end({})
        n_out = len(outputs[0]) if outputs else 0
        result = [[b[i] for b in outputs] for i in range(n_out)]
        if stack_outputs:
            result = [np.concatenate(r) for r in result]
        return result

    # -------------------------------------------------------- persistence
    def _slot_names(self):
        """{the optimizer's key of a parameter: its structured name in the
        network}: the saved optimizer state is keyed by the latter, so a
        fresh model of the same structure loads it."""
        return {self._optimizer._param_name(p._t): n
                for n, p in self._layer.named_parameters()}

    @staticmethod
    def _renamed(state, names):
        out = {}
        for key, val in state.items():
            pname, dot, slot = key.rpartition(".")
            out[names[pname] + dot + slot if pname in names else key] = val
        return out

    def save(self, path, training=True):
        """`path`.pdparams (the network's state dict) and, with
        `training`, `path`.pdopt (the optimizer's, keyed by the
        parameters' structured names). Across ranks the group's first rank
        writes them (a GroupSharded stage 3 network: its gathered
        parameters) and every rank waits."""
        full = getattr(self.network, "full_state_dict", None)
        state = full() if full is not None else self.network.state_dict()
        if self._group is None or self._group.rank == 0:
            fw_save(state, str(path) + ".pdparams")
            if training and self._optimizer is not None:
                fw_save(self._renamed(self._optimizer.state_dict(),
                                      self._slot_names()),
                        str(path) + ".pdopt")
        if self._group is not None:
            from ..distributed.communication import barrier

            barrier(self._group)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        dev = self._device()
        self.network.set_state_dict(fw_load(str(path) + ".pdparams",
                                            place=dev))
        opt_path = str(path) + ".pdopt"
        if (not reset_optimizer and self._optimizer is not None
                and os.path.exists(opt_path)):
            back = {n: k for k, n in self._slot_names().items()}
            self._optimizer.set_state_dict(self._renamed(
                fw_load(opt_path, place=dev), back))

    # ------------------------------------------------------------- extras
    def parameters(self, *args, **kwargs):
        return self._layer.parameters(*args, **kwargs)

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtypes=dtype)
