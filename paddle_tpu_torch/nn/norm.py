"""Normalisation layers of the port (counterpart of `paddle_tpu/nn/norm.py`)."""

from __future__ import annotations

import torch
from torch import nn


class RMSNorm(nn.Module):
    """RMSNorm with the reference's numerics (`rms_norm`,
    nn/functional/__init__.py:729-748): normalise in float32, cast back to
    the input dtype, then multiply by the weight cast to that dtype (a bf16
    stream times an f32 weight must not promote the residual stream)."""

    def __init__(self, hidden_size, epsilon=1e-6, device=None, dtype=None):
        super().__init__()
        self.epsilon = float(epsilon)
        self.weight = nn.Parameter(
            torch.ones(hidden_size, device=device, dtype=dtype)
        )

    def forward(self, x):
        x32 = x.float()
        out = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.epsilon)
        return out.to(x.dtype) * self.weight.to(x.dtype)
