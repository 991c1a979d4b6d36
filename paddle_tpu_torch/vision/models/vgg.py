"""VGG (counterpart of `paddle_tpu/vision/models/vgg.py`): `cfgs`,
`make_layers`, `VGG`, `vgg11/13/16/19`."""

from __future__ import annotations

from torch import nn

from ... import nn as pnn
from ...framework.core import resolve_device
from ._build import init_weights, on_device

cfgs = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M", 512,
          512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"],
}


def make_layers(cfg, batch_norm=False):
    """3x3 convs (with a BatchNorm2D each under `batch_norm`) and ReLUs,
    a 2x2 max pool at each "M" (reference :15-27)."""
    layers = []
    in_channels = 3
    for v in cfg:
        if v == "M":
            layers.append(pnn.MaxPool2D(2, 2))
        else:
            layers.append(pnn.Conv2D(in_channels, v, 3, padding=1))
            if batch_norm:
                layers.append(pnn.BatchNorm2D(v))
            layers.append(pnn.ReLU())
            in_channels = v
    return nn.Sequential(*layers)


class VGG(nn.Module):
    """`features`, an adaptive average pool to 7x7 (`with_pool`) and the
    three-Linear classifier with dropout (`num_classes` 0: none), moved to
    `device` (None: the CUDA card) with weights drawn from `seed`
    (reference :30-57).  The dropout masks come from torch's default
    generator."""

    def __init__(self, features, num_classes=1000, with_pool=True, device=None, seed=0):
        super().__init__()
        device = resolve_device(device)
        self.features = features.to(device)
        with on_device(device):
            self.with_pool = with_pool
            if with_pool:
                self.avgpool = pnn.AdaptiveAvgPool2D((7, 7))
            if num_classes > 0:
                self.classifier = nn.Sequential(
                    nn.Linear(512 * 7 * 7, 4096),
                    pnn.ReLU(),
                    pnn.Dropout(),
                    nn.Linear(4096, 4096),
                    pnn.ReLU(),
                    pnn.Dropout(),
                    nn.Linear(4096, num_classes),
                )
        self.num_classes = num_classes
        init_weights(self, seed)

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, device=None, **kwargs):
    with on_device(device):
        features = make_layers(cfgs[cfg], batch_norm)
    return VGG(features, device=device, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("A", batch_norm, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("B", batch_norm, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("D", batch_norm, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg("E", batch_norm, **kwargs)
