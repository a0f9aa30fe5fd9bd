"""hapi's callbacks for the port (counterpart of
paddle_tpu/hapi/callbacks.py): `Callback`, `CallbackList`,
`ProgBarLogger`, `ModelCheckpoint` (paddle.save files through
`Model.save`, or the port's distributed checkpoint with
`use_dist_checkpoint` / `async_save`), `EarlyStopping`, `LRScheduler`
(steps the optimizer's scheduler by step or epoch), `VisualDL` (the
scalars as JSON lines under `log_dir`) and `config_callbacks`. Host
code, as in the reference."""
from __future__ import annotations

import numbers
import os
import time

import numpy as np

__all__ = ["Callback", "CallbackList", "ProgBarLogger", "ModelCheckpoint",
           "EarlyStopping", "LRScheduler", "VisualDL", "config_callbacks"]


class CallbackList:
    def __init__(self, callbacks):
        self.callbacks = callbacks or []

    def append(self, cb):
        self.callbacks.append(cb)

    def __iter__(self):
        return iter(self.callbacks)

    def set_params(self, params):
        for cb in self.callbacks:
            cb.set_params(params)

    def set_model(self, model):
        for cb in self.callbacks:
            cb.set_model(model)

    def _call(self, name, *args):
        for cb in self.callbacks:
            fn = getattr(cb, name, None)
            if fn is not None:
                fn(*args)

    def __getattr__(self, name):
        if name.startswith("on_"):
            return lambda *args: self._call(name, *args)
        raise AttributeError(name)


class Callback:
    """The base class: paddle's hooks, each a no-op."""

    def __init__(self):
        self.model = None
        self.params = {}

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass

    def on_eval_begin(self, logs=None):
        pass

    def on_eval_end(self, logs=None):
        pass

    def on_predict_begin(self, logs=None):
        pass

    def on_predict_end(self, logs=None):
        pass

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_batch_begin(self, step, logs=None):
        pass

    def on_train_batch_end(self, step, logs=None):
        pass

    def on_eval_batch_begin(self, step, logs=None):
        pass

    def on_eval_batch_end(self, step, logs=None):
        pass

    def on_predict_batch_begin(self, step, logs=None):
        pass

    def on_predict_batch_end(self, step, logs=None):
        pass


def _fmt_logs(logs):
    parts = []
    for k, v in (logs or {}).items():
        if k in ("batch_size",):
            continue
        if isinstance(v, (list, tuple, np.ndarray)):
            v = ["%.4f" % float(x) for x in np.ravel(np.asarray(v))]
            parts.append(f"{k}: {v if len(v) > 1 else v[0]}")
        elif isinstance(v, numbers.Number):
            parts.append(f"{k}: {float(v):.4f}")
    return " - ".join(parts)


class ProgBarLogger(Callback):
    def __init__(self, log_freq=1, verbose=2):
        super().__init__()
        self.log_freq = log_freq
        self.verbose = verbose

    def on_train_begin(self, logs=None):
        self.epochs = self.params.get("epochs")
        self._t0 = time.time()

    def on_epoch_begin(self, epoch, logs=None):
        self.epoch = epoch
        self.steps = self.params.get("steps")
        self._epoch_t0 = time.time()
        if self.verbose and self.epochs:
            print(f"Epoch {epoch + 1}/{self.epochs}")

    def on_train_batch_end(self, step, logs=None):
        if self.verbose == 2 and (step + 1) % self.log_freq == 0:
            dt = time.time() - self._epoch_t0
            rate = (step + 1) / dt if dt > 0 else 0.0
            tail = f"step {step + 1}" + (f"/{self.steps}" if self.steps else "")
            print(f"  {tail} - {_fmt_logs(logs)} - {rate:.1f} step/s")

    def on_epoch_end(self, epoch, logs=None):
        if self.verbose:
            print(f"  epoch {epoch + 1} done - {_fmt_logs(logs)} "
                  f"({time.time() - self._epoch_t0:.1f}s)")

    def on_eval_begin(self, logs=None):
        self._eval_t0 = time.time()
        if self.verbose:
            n = (logs or {}).get("samples")
            print(f"Eval begin{f' ({n} samples)' if n else ''}...")

    def on_eval_end(self, logs=None):
        if self.verbose:
            print(f"Eval done - {_fmt_logs(logs)} "
                  f"({time.time() - self._eval_t0:.1f}s)")


class ModelCheckpoint(Callback):
    """Checkpoints every `save_freq` epochs and at the end: paddle.save
    files through Model.save, or with `use_dist_checkpoint` the network's
    state dict through the port's distributed checkpoint (a rank's shard
    files, resharded on load; a GroupSharded stage 3 network's parameters
    gathered whole first); `async_save` writes in the background after
    the host snapshot, joined at the next save or at the end."""

    def __init__(self, save_freq=1, save_dir=None,
                 use_dist_checkpoint=False, async_save=False):
        super().__init__()
        self.save_freq = save_freq
        self.save_dir = save_dir
        self.use_dist_checkpoint = use_dist_checkpoint or async_save
        self.async_save = async_save

    def _save(self, path, async_save=False):
        if not self.use_dist_checkpoint:
            self.model.save(path)
            return
        from ..distributed import checkpoint as dck

        net = self.model.network
        full = getattr(net, "full_state_dict", None)    # GroupSharded
        sd = full() if full is not None else net.state_dict()
        sd = {k: getattr(v, "_t", v) for k, v in sd.items()}
        dck.save_state_dict(sd, path, async_save=async_save)

    def on_epoch_end(self, epoch, logs=None):
        if self.save_dir and (epoch + 1) % self.save_freq == 0:
            path = os.path.join(self.save_dir, str(epoch), "model")
            self._save(path, async_save=self.async_save)

    def on_train_end(self, logs=None):
        if self.save_dir:
            self._save(os.path.join(self.save_dir, "final", "model"))
            if self.async_save:
                from ..distributed import checkpoint as dck

                dck.wait_save()


class EarlyStopping(Callback):
    def __init__(self, monitor="loss", mode="auto", patience=0, verbose=1,
                 min_delta=0, baseline=None, save_best_model=True):
        super().__init__()
        self.monitor = monitor
        self.patience = patience
        self.verbose = verbose
        self.min_delta = abs(min_delta)
        self.baseline = baseline
        self.save_best_model = save_best_model
        if mode == "max" or (mode == "auto" and "acc" in monitor):
            self.better = lambda cur, best: cur > best + self.min_delta
            self.best = -np.inf
        else:
            self.better = lambda cur, best: cur < best - self.min_delta
            self.best = np.inf
        self.wait = 0
        self.stopped_epoch = 0

    def on_train_begin(self, logs=None):
        self.wait = 0
        if self.baseline is not None:
            self.best = self.baseline

    def on_eval_end(self, logs=None):
        cur = (logs or {}).get(self.monitor)
        if cur is None:
            return
        if isinstance(cur, (list, tuple, np.ndarray)):
            cur = float(np.ravel(np.asarray(cur))[0])
        if self.better(cur, self.best):
            self.best = cur
            self.wait = 0
            if self.save_best_model and self.params.get("save_dir"):
                self.model.save(
                    os.path.join(self.params["save_dir"], "best_model"))
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.model.stop_training = True
                if self.verbose:
                    print(f"Early stopping (no {self.monitor} improvement "
                          f"for {self.patience} evals)")


class LRScheduler(Callback):
    """Steps the optimizer's LRScheduler (by epoch or by step)."""

    def __init__(self, by_step=True, by_epoch=False):
        super().__init__()
        if by_step and by_epoch:
            raise ValueError("by_step and by_epoch are mutually exclusive")
        self.by_step = by_step
        self.by_epoch = by_epoch

    def _sched(self):
        opt = getattr(self.model, "_optimizer", None)
        from ..optimizer.lr import LRScheduler as Sched

        if opt is not None and isinstance(opt._learning_rate, Sched):
            return opt._learning_rate
        return None

    def on_epoch_end(self, epoch, logs=None):
        if self.by_epoch:
            s = self._sched()
            if s:
                s.step()

    def on_train_batch_end(self, step, logs=None):
        if self.by_step:
            s = self._sched()
            if s:
                s.step()


class VisualDL(Callback):
    """Scalar logging: the scalars VisualDL would take, as JSON lines in
    `log_dir`/scalars.jsonl."""

    def __init__(self, log_dir):
        super().__init__()
        self.log_dir = log_dir
        self._f = None
        self._step = 0

    def _write(self, tag, logs):
        import json

        if self._f is None:
            os.makedirs(self.log_dir, exist_ok=True)
            self._f = open(os.path.join(self.log_dir, "scalars.jsonl"), "a")
        rec = {"tag": tag, "step": self._step}
        for k, v in (logs or {}).items():
            if isinstance(v, numbers.Number):
                rec[k] = float(v)
            elif isinstance(v, (list, tuple, np.ndarray)):
                arr = np.ravel(np.asarray(v))
                if arr.size:
                    rec[k] = float(arr[0])
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def on_train_batch_end(self, step, logs=None):
        self._step += 1
        self._write("train", logs)

    def on_eval_end(self, logs=None):
        self._write("eval", logs)

    def on_train_end(self, logs=None):
        if self._f:
            self._f.close()
            self._f = None


def config_callbacks(callbacks=None, model=None, batch_size=None, epochs=None,
                     steps=None, log_freq=2, verbose=2, save_freq=1,
                     save_dir=None, metrics=None, mode="train"):
    cbks = list(callbacks) if callbacks else []
    if not any(isinstance(c, ProgBarLogger) for c in cbks) and verbose:
        cbks = [ProgBarLogger(log_freq, verbose=verbose)] + cbks
    if not any(isinstance(c, LRScheduler) for c in cbks):
        cbks = cbks + [LRScheduler()]
    if save_dir and not any(isinstance(c, ModelCheckpoint) for c in cbks):
        cbks = cbks + [ModelCheckpoint(save_freq, save_dir)]
    cb_list = CallbackList(cbks)
    cb_list.set_model(model)
    cb_list.set_params({
        "batch_size": batch_size, "epochs": epochs, "steps": steps,
        "verbose": verbose, "metrics": metrics or [], "save_dir": save_dir,
    })
    return cb_list
