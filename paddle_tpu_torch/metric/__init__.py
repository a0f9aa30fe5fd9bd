"""paddle.metric for the port (counterpart of
paddle_tpu/metric/__init__.py:1-206): `Metric`, `Accuracy`, `Precision`,
`Recall`, `Auc` and the functional `accuracy`.

Metrics accumulate on the host in numpy, as in the reference: they sit
outside the step, so device math would only add transfers. Inputs are
torch tensors (any device) or anything `np.asarray` takes; `compute` and
`accuracy` return CPU torch tensors.
"""
from __future__ import annotations

import abc

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _to_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric(abc.ABC):
    """Base class: reset / update / accumulate / name, and the `compute`
    hook (the identity by default)."""

    @abc.abstractmethod
    def reset(self):
        raise NotImplementedError

    @abc.abstractmethod
    def update(self, *args):
        raise NotImplementedError

    @abc.abstractmethod
    def accumulate(self):
        raise NotImplementedError

    @abc.abstractmethod
    def name(self):
        raise NotImplementedError

    def compute(self, *args):
        return args


class Accuracy(Metric):
    """Top-k accuracy."""

    def __init__(self, topk=(1,), name="acc", *args, **kwargs):
        super().__init__()
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name
        self.reset()

    def compute(self, pred, label, *args):
        pred_np = _to_np(pred)
        label_np = _to_np(label)
        # top-maxk indices, descending
        idx = np.argsort(-pred_np, axis=-1)[..., : self.maxk]
        if label_np.ndim == pred_np.ndim:
            if label_np.shape[-1] == pred_np.shape[-1] > 1:  # one-hot
                label_np = np.argmax(label_np, axis=-1)
            else:  # class indices with a trailing 1
                label_np = label_np[..., 0]
        correct = idx == label_np[..., None]
        return torch.from_numpy(correct.astype(np.float32))

    def update(self, correct, *args):
        correct = _to_np(correct)
        num_samples = int(np.prod(correct.shape[:-1])) or 1
        accs = []
        for i, k in enumerate(self.topk):
            num_corrects = correct[..., :k].sum()
            accs.append(float(num_corrects) / num_samples)
            self.total[i] += float(num_corrects)
            self.count[i] += num_samples
        return accs[0] if len(accs) == 1 else accs

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)

    def accumulate(self):
        res = [t / c if c > 0 else 0.0 for t, c in zip(self.total,
                                                        self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        if len(self.topk) == 1:
            return [self._name]
        return [f"{self._name}_top{k}" for k in self.topk]


class Precision(Metric):
    """Binary precision tp / (tp + fp); predictions are probabilities of
    class 1."""

    def __init__(self, name="precision", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).reshape(-1)
        labels = _to_np(labels).reshape(-1)
        pred_pos = preds >= 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fp += int(np.sum(pred_pos & (labels != 1)))

    def reset(self):
        self.tp = 0
        self.fp = 0

    def accumulate(self):
        denom = self.tp + self.fp
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall tp / (tp + fn)."""

    def __init__(self, name="recall", *args, **kwargs):
        super().__init__()
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds).reshape(-1)
        labels = _to_np(labels).reshape(-1)
        pred_pos = preds >= 0.5
        self.tp += int(np.sum(pred_pos & (labels == 1)))
        self.fn += int(np.sum(~pred_pos & (labels == 1)))

    def reset(self):
        self.tp = 0
        self.fn = 0

    def accumulate(self):
        denom = self.tp + self.fn
        return self.tp / denom if denom > 0 else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over `num_thresholds` buckets (Paddle's histogram)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name="auc",
                 *args, **kwargs):
        super().__init__()
        self.num_thresholds = num_thresholds
        self._name = name
        self.reset()

    def update(self, preds, labels):
        preds = _to_np(preds)
        labels = _to_np(labels).reshape(-1)
        if preds.ndim == 2 and preds.shape[1] == 2:
            pos_prob = preds[:, 1]
        else:
            pos_prob = preds.reshape(-1)
        bins = np.minimum((pos_prob * self.num_thresholds).astype(np.int64),
                          self.num_thresholds)
        pos = labels.astype(bool)
        np.add.at(self._stat_pos, bins[pos], 1)
        np.add.at(self._stat_neg, bins[~pos], 1)

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1, dtype=np.int64)
        self._stat_neg = np.zeros(self.num_thresholds + 1, dtype=np.int64)

    def accumulate(self):
        tot_pos = 0.0
        tot_neg = 0.0
        auc = 0.0
        for i in range(self.num_thresholds, -1, -1):
            pos = float(self._stat_pos[i])
            neg = float(self._stat_neg[i])
            auc += neg * (tot_pos + pos / 2.0)  # trapezoid
            tot_pos += pos
            tot_neg += neg
        return auc / (tot_pos * tot_neg) if tot_pos * tot_neg > 0 else 0.0

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """The share of rows whose label is among the top `k` predictions."""
    pred_np = _to_np(input)
    label_np = _to_np(label).reshape(-1)
    idx = np.argsort(-pred_np, axis=-1)[:, :k]
    ok = (idx == label_np[:, None]).any(axis=1)
    return torch.tensor(np.asarray(ok.mean(), dtype=np.float32))
