"""What the vision models share: where their layers are made and how
their weights start."""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from ...framework.core import resolve_device
from ...nn.conv import _ConvNd


@contextlib.contextmanager
def on_device(device):
    """Make every tensor a constructor creates inside on `device` (None:
    the CUDA card, which raises without CUDA; "cpu" for the plain path)."""
    with torch.device(resolve_device(device)):
        yield


@torch.no_grad()
def init_weights(model, seed):
    """Draw `model`'s weights from a torch.Generator seeded with `seed` on
    its device, with the reference's initialisers: convs Kaiming-uniform
    over the fan-in and biases uniform in +-1 / sqrt(fan_in) (nn/conv.py),
    Linear weights Xavier-normal and biases zero (nn/common.py:16-33); the
    norms keep weight 1 and bias 0.  The draws differ from the
    reference's: weights cross over by `models.convert.load_reference_state`."""
    device = next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for mod in model.modules():
        if isinstance(mod, _ConvNd):
            mod.reset_parameters(gen)
        elif isinstance(mod, nn.Linear):
            rows, cols = mod.weight.shape
            mod.weight.normal_(0.0, math.sqrt(2.0 / (rows + cols)), generator=gen)
            if mod.bias is not None:
                mod.bias.zero_()
    return model
