"""Dropout as a layer (counterpart of `paddle_tpu/nn/common.py`'s
`Dropout`)."""

from __future__ import annotations

from torch import nn

from . import functional


class Dropout(nn.Module):
    """`functional.dropout` in training mode, the identity (or, for
    "downscale_in_infer", a scale) in eval mode.  `generator`: the
    torch.Generator the masks are drawn from (None: torch's default), so a
    seeded run repeats itself."""

    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", generator=None):
        super().__init__()
        self.p, self.axis, self.mode = float(p), axis, mode
        self.generator = generator

    def forward(self, x):
        return functional.dropout(x, self.p, self.axis, self.training, self.mode,
                                  self.generator)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"
