"""Activation layers of the port (counterpart of
`paddle_tpu/nn/activation.py`): `ReLU`, the one the vision models use.
The others are ROADMAP.md Queue 1, position 7."""

from __future__ import annotations

from torch import nn

from . import functional as F


class ReLU(nn.Module):
    def __init__(self, name=None):
        super().__init__()

    def forward(self, x):
        return F.relu(x)
