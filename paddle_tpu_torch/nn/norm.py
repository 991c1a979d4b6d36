"""Normalisation layers of the port (counterpart of `paddle_tpu/nn/norm.py`):
RMSNorm (Llama) and LayerNorm (BERT, the transformer layers)."""

from __future__ import annotations

import torch
from torch import nn

from . import functional


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


class LayerNorm(nn.Module):
    """LayerNorm (reference: nn/norm.py:99) over the trailing
    `normalized_shape` dims, with `functional.layer_norm`'s numerics:
    statistics in float32, output in the input's dtype.  Weight 1 and bias
    0 at first; `weight_attr` / `bias_attr` False leave either out.  AMP O2
    keeps its parameters float32 (`amp.KEEP_FP32`)."""

    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, device=None, dtype=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self.normalized_shape = tuple(normalized_shape)
        self.epsilon = float(epsilon)
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(self.normalized_shape, **kw))
                       if weight_attr is not False else None)
        self.bias = (nn.Parameter(torch.zeros(self.normalized_shape, **kw))
                     if bias_attr is not False else None)

    def forward(self, x):
        return functional.layer_norm(x, self.normalized_shape, self.weight,
                                     self.bias, self.epsilon)

    def extra_repr(self):
        return f"normalized_shape={self.normalized_shape}, epsilon={self.epsilon}"
