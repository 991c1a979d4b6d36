"""Metrics of the port (counterpart of `paddle_tpu/metric.py`).

`Accuracy.update_on_device` keeps its running sums as tensors on the
predictions' device, so a training loop that reads accuracy only at its
log boundaries fetches nothing per step; `accumulate()` folds them in with
one stacked copy.  The other metrics accumulate on the host, as in the
reference.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Metric", "Accuracy", "Precision", "Recall", "Auc", "accuracy"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Metric:
    def reset(self):
        raise NotImplementedError

    def update(self, *args):
        raise NotImplementedError

    def accumulate(self):
        raise NotImplementedError

    def name(self):
        return self.__class__.__name__.lower()

    def compute(self, *args):
        return args

    def update_on_device(self, pred, label):
        """Accumulate one batch without a host fetch; returns whether this
        metric did (the base class has no device path: the caller then
        takes `compute` / `update`)."""
        return False


class Accuracy(Metric):
    """Top-k accuracy for each k of `topk`."""

    def __init__(self, topk=(1,), name=None):
        self.topk = (topk,) if isinstance(topk, int) else tuple(topk)
        self.maxk = max(self.topk)
        self._name = name or "acc"
        self.reset()

    def reset(self):
        self.total = [0.0] * len(self.topk)
        self.count = [0] * len(self.topk)
        self._dev_total = None  # per-k 0-d tensors (update_on_device)
        self._dev_count = [0] * len(self.topk)

    def update_on_device(self, pred, label):
        """Top-k hits of a batch summed on the predictions' device (the
        count comes from the shapes), with the reference's ordering: a
        stable sort of the negated scores, so ties rank the lower class
        first."""
        if not isinstance(pred, torch.Tensor):
            return False
        lab = label if isinstance(label, torch.Tensor) else torch.as_tensor(
            np.asarray(label), device=pred.device)
        if lab.dim() == pred.dim() and lab.shape[-1] == 1:
            lab = lab[..., 0]
        with torch.no_grad():
            top = torch.argsort(-pred.detach(), dim=-1, stable=True)[..., :self.maxk]
            correct = (top == lab.to(top.device)[..., None]).float()
        n = int(np.prod(correct.shape[:-1]))
        if self._dev_total is None:
            self._dev_total = [torch.zeros((), device=pred.device) for _ in self.topk]
        for i, k in enumerate(self.topk):
            self._dev_total[i] = self._dev_total[i] + correct[..., :k].sum()
            self._dev_count[i] += n
        return True

    def _fold_device(self):
        """The device sums into the host totals: one stacked fetch."""
        if self._dev_total is None:
            return
        vals = torch.stack(self._dev_total).cpu().tolist()
        for i, v in enumerate(vals):
            self.total[i] += float(v)
            self.count[i] += self._dev_count[i]
        self._dev_total = None
        self._dev_count = [0] * len(self.topk)

    def compute(self, pred, label, *args):
        pred_np, label_np = _np(pred), _np(label)
        if label_np.ndim == pred_np.ndim and label_np.shape[-1] == 1:
            label_np = label_np[..., 0]
        top = np.argsort(-pred_np, axis=-1, kind="stable")[..., :self.maxk]
        return torch.from_numpy((top == label_np[..., None]).astype(np.float32))

    def update(self, correct, *args):
        c = _np(correct)
        n = int(np.prod(c.shape[:-1]))
        accs = []
        for i, k in enumerate(self.topk):
            num = float(c[..., :k].sum())
            self.total[i] += num
            self.count[i] += n
            accs.append(num / max(n, 1))
        return accs[0] if len(accs) == 1 else accs

    def accumulate(self):
        self._fold_device()
        res = [t / max(c, 1) for t, c in zip(self.total, self.count)]
        return res[0] if len(res) == 1 else res

    def name(self):
        return self._name


class Precision(Metric):
    """Binary precision of predictions > 0.5."""

    def __init__(self, name=None):
        self._name = name or "precision"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fp = 0

    def update(self, preds, labels):
        p = _np(preds) > 0.5
        lab = _np(labels).astype(bool)
        self.tp += int(np.sum(p & lab))
        self.fp += int(np.sum(p & ~lab))

    def accumulate(self):
        d = self.tp + self.fp
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Recall(Metric):
    """Binary recall of predictions > 0.5."""

    def __init__(self, name=None):
        self._name = name or "recall"
        self.reset()

    def reset(self):
        self.tp = 0
        self.fn = 0

    def update(self, preds, labels):
        p = _np(preds) > 0.5
        lab = _np(labels).astype(bool)
        self.tp += int(np.sum(p & lab))
        self.fn += int(np.sum(~p & lab))

    def accumulate(self):
        d = self.tp + self.fn
        return self.tp / d if d else 0.0

    def name(self):
        return self._name


class Auc(Metric):
    """ROC AUC over `num_thresholds` + 1 score bins (the positive class's
    column of a [n, 2] prediction)."""

    def __init__(self, curve="ROC", num_thresholds=4095, name=None):
        self._name = name or "auc"
        self.num_thresholds = num_thresholds
        self.reset()

    def reset(self):
        self._stat_pos = np.zeros(self.num_thresholds + 1)
        self._stat_neg = np.zeros(self.num_thresholds + 1)

    def update(self, preds, labels):
        p, lab = _np(preds), _np(labels)
        if p.ndim == 2:
            p = p[:, -1]
        lab = lab.reshape(-1)
        bins = np.minimum((p * self.num_thresholds).astype(int), self.num_thresholds)
        np.add.at(self._stat_pos, bins[lab != 0], 1)
        np.add.at(self._stat_neg, bins[lab == 0], 1)

    def accumulate(self):
        tot_pos, tot_neg = self._stat_pos.sum(), self._stat_neg.sum()
        if not tot_pos or not tot_neg:
            return 0.0
        area, neg = 0.0, 0.0
        for i in range(self.num_thresholds, -1, -1):
            area += self._stat_pos[i] * (neg + self._stat_neg[i] / 2)
            neg += self._stat_neg[i]
        return area / (tot_pos * tot_neg)

    def name(self):
        return self._name


def accuracy(input, label, k=1, correct=None, total=None, name=None):
    """Top-k accuracy of one batch as a float32 0-d tensor."""
    pred, lab = _np(input), _np(label)
    if lab.ndim == 2 and lab.shape[1] == 1:
        lab = lab[:, 0]
    topk = np.argsort(-pred, axis=-1, kind="stable")[:, :k]
    return torch.tensor(float(np.mean((topk == lab[:, None]).any(-1))),
                        dtype=torch.float32)
