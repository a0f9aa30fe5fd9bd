"""paddle.Model for the port (counterpart of paddle_tpu/hapi/model.py):
`prepare`, `train_batch` / `eval_batch` / `predict_batch`, `fit` /
`evaluate` / `predict`, `save` / `load`, `parameters` and `summary`, in
one process.

The reference builds one jitted program a step (forward, loss,
`jax.value_and_grad`, the optimizer's functional update). The port's
step is eager: the forward under the amp context (`amp_configs` "O1" /
"O2": `auto_cast` at that level, as the reference's `_amp_ctx`; no
`decorate`), the loss outside it, torch autograd, then the optimizer's
`step()` and `clear_grad()`. BatchNorm's running statistics update in
place during the forward. Metrics update on the host from the step's
outputs and labels.

Batches are Paddle Tensors, torch tensors or numpy arrays; they are put
on the network's device (its parameters'). Multi-rank data parallelism
(the reference's `_dp_shardings`, `_sharding_trees`, `_globalize_*`) is
queue 1 item 6b2: a DataParallel network is refused.
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


class Model:
    """A network with fit / evaluate / predict (paddle.Model)."""

    def __init__(self, network, inputs=None, labels=None):
        if hasattr(network, "data_sharding") or type(
                network).__name__ == "DataParallel":
            raise NotImplementedError(
                "paddle.Model over a data-parallel network is ROADMAP queue "
                "1 item 6b2")
        self.network = network
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
        for p in self.network.parameters():
            return p._t.device
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

    def _update_metrics(self, outs, labels):
        results = []
        for m in self._metrics:
            pre = m.compute(*[t._t.detach() for t in outs + labels])
            results.append(m.update(*_to_list(pre)))
        return results

    @staticmethod
    def _numpy(losses):
        return [l._t.detach().float().cpu().numpy() for l in losses]

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
        outs = self._forward(inputs)
        losses = self._losses(outs, labels)
        total = sum(l._t.float().sum() for l in losses)
        total.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = self._update_metrics(outs, labels)
        loss_np = self._numpy(losses)
        return (loss_np, metrics) if metrics else loss_np

    def eval_batch(self, inputs, labels=None):
        self.network.eval()
        inputs, labels = self._tensors(inputs), self._tensors(labels)
        with torch.no_grad():
            outs = self._forward(inputs)
            losses = self._losses(outs, labels) if (
                self._loss is not None and labels) else []
        metrics = self._update_metrics(outs, labels)
        loss_np = self._numpy(losses)
        return (loss_np, metrics) if metrics else loss_np

    def predict_batch(self, inputs):
        self.network.eval()
        with torch.no_grad():
            outs = self._forward(self._tensors(inputs))
        return [o._t.float().cpu().numpy() if o._t.is_floating_point()
                else o._t.cpu().numpy() for o in outs]

    # ---------------------------------------------------------------- fit
    def _make_loader(self, data, batch_size, shuffle, num_workers,
                     drop_last=False):
        if data is None or isinstance(data, DataLoader):
            return data
        if isinstance(data, Dataset):
            return DataLoader(data, places=self._device(),
                              batch_size=batch_size, shuffle=shuffle,
                              num_workers=num_workers, drop_last=drop_last)
        return data  # any iterable of batches

    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1, verbose=2,
            drop_last=False, shuffle=True, num_workers=0, callbacks=None,
            accumulate_grad_batches=1, num_iters=None):
        """Train `epochs` epochs (or `num_iters` steps), evaluating every
        `eval_freq` epochs."""
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
                for n, p in self.network.named_parameters()}

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
        parameters' structured names)."""
        fw_save(self.network.state_dict(), str(path) + ".pdparams")
        if training and self._optimizer is not None:
            fw_save(self._renamed(self._optimizer.state_dict(),
                                  self._slot_names()),
                    str(path) + ".pdopt")

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
        return self.network.parameters(*args, **kwargs)

    def _metrics_name(self):
        names = ["loss"]
        for m in self._metrics:
            n = m.name()
            names.extend(n if isinstance(n, list) else [n])
        return names

    def summary(self, input_size=None, dtype=None):
        from .summary import summary

        return summary(self.network, input_size, dtypes=dtype)
