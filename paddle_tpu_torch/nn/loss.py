"""Loss layers (counterpart of `paddle_tpu/nn/loss.py`'s `CrossEntropyLoss`
and `MSELoss`), as `hapi.Model.prepare` takes them."""

from __future__ import annotations

from torch import nn

from . import functional as F


class CrossEntropyLoss(nn.Module):
    """`functional.cross_entropy` with the reference's arguments (the forms
    it does not port raise there)."""

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0,
                 name=None):
        super().__init__()
        self.weight = weight
        self.ignore_index = ignore_index
        self.reduction = reduction
        self.soft_label = soft_label
        self.axis = axis
        self.use_softmax = use_softmax
        self.label_smoothing = label_smoothing

    def forward(self, input, label):
        return F.cross_entropy(input, label, self.weight, self.ignore_index,
                               self.reduction, self.soft_label, self.axis,
                               self.use_softmax, self.label_smoothing)


class MSELoss(nn.Module):
    def __init__(self, reduction="mean"):
        super().__init__()
        self.reduction = reduction

    def forward(self, input, label):
        return F.mse_loss(input, label, self.reduction)
