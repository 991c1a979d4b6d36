"""LeNet (counterpart of `paddle_tpu/vision/models/lenet.py`, the
reference's config 1)."""

from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ._build import init_weights, on_device


class LeNet(nn.Module):
    """Two conv + ReLU + max-pool stages and three Linears, for 1x28x28
    images (reference :8-32); `num_classes` 0 leaves out the Linears.
    Built on `device` (None: the CUDA card) with weights drawn from
    `seed`."""

    def __init__(self, num_classes=10, device=None, seed=0):
        super().__init__()
        self.num_classes = num_classes
        with on_device(device):
            self.features = nn.Sequential(
                pnn.Conv2D(1, 6, 3, stride=1, padding=1),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2),
                pnn.Conv2D(6, 16, 5, stride=1, padding=0),
                pnn.ReLU(),
                pnn.MaxPool2D(2, 2),
            )
            if num_classes > 0:
                self.fc = nn.Sequential(
                    nn.Linear(400, 120),
                    nn.Linear(120, 84),
                    nn.Linear(84, num_classes),
                )
        init_weights(self, seed)

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x
