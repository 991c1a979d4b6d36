"""Convolution layers of the port (counterpart of `paddle_tpu/nn/conv.py`):
`Conv1D`, `Conv2D`, `Conv3D` and their transposes over `functional`'s
convs, with the reference's parameter names and shapes: `weight` [out,
in / groups, *k] (transposed: [in, out / groups, *k]) and `bias` [out],
left out with `bias_attr=False`.  Weights start Kaiming-uniform over the
fan-in, biases uniform in +-1 / sqrt(fan_in), as the reference's; a
seeded initialisation does not match the reference's draws, so weights
cross over by `models.convert.load_reference_state`."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import functional as F
from .functional import _refuse

_NOT_PORTED_ATTR = ("a ParamAttr is not ported yet (ROADMAP.md Queue 1, "
                    "position 7: nn, the rest)")


def check_attr(attr, what):
    """`weight_attr` / `bias_attr`: None (the default) or False (no such
    parameter; the reference's create_parameter returns None)."""
    if attr is not None and attr is not False:
        raise NotImplementedError(f"{what}={attr!r}: {_NOT_PORTED_ATTR}")
    return attr is not False


class _ConvNd(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, nd, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", transposed=False, device=None,
                 dtype=None):
        super().__init__()
        _refuse("padding_mode", padding_mode, "zeros", "conv.py:16-61")
        if not check_attr(weight_attr, "weight_attr"):
            raise ValueError("a convolution needs its weight (weight_attr=False)")
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = (tuple(kernel_size) if isinstance(kernel_size, (list, tuple))
                             else (kernel_size,) * nd)
        self._stride, self._padding, self._dilation = stride, padding, dilation
        self._groups, self._data_format = groups, data_format
        shape = ([in_channels, out_channels // groups] if transposed
                 else [out_channels, in_channels // groups]) + list(self._kernel_size)
        kw = dict(device=device, dtype=dtype)
        self.weight = nn.Parameter(torch.empty(shape, **kw))
        self.bias = (nn.Parameter(torch.empty(out_channels, **kw))
                     if check_attr(bias_attr, "bias_attr") else None)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None):
        """Kaiming-uniform weight (bound sqrt(6 / fan_in)), bias uniform in
        +-1 / sqrt(fan_in), fan_in = in / groups * prod(k) (reference
        conv.py:45-56), drawn from `generator` (None: torch's default)."""
        fan_in = self._in_channels // self._groups * math.prod(self._kernel_size)
        limit = math.sqrt(6.0 / fan_in)
        self.weight.uniform_(-limit, limit, generator=generator)
        if self.bias is not None:
            bound = 1.0 / math.sqrt(fan_in)
            self.bias.uniform_(-bound, bound, generator=generator)

    def extra_repr(self):
        return (f"{self._in_channels}, {self._out_channels}, kernel_size="
                f"{self._kernel_size}, stride={self._stride}, padding={self._padding}")


class Conv1D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCL", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv1d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv2D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv3D(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 dilation=1, groups=1, padding_mode="zeros", weight_attr=None,
                 bias_attr=None, data_format="NCDHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, padding_mode, weight_attr, bias_attr,
                         data_format, device=device, dtype=dtype)

    def forward(self, x):
        return F.conv3d(x, self.weight, self.bias, self._stride, self._padding,
                        self._dilation, self._groups, self._data_format)


class Conv1DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCL", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, device=device, dtype=dtype)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv1d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, self._data_format, output_size)


class Conv2DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, dilation=1, groups=1, weight_attr=None,
                 bias_attr=None, data_format="NCHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, device=device, dtype=dtype)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv2d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, self._data_format, output_size)


class Conv3DTranspose(_ConvNd):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1, padding=0,
                 output_padding=0, groups=1, dilation=1, weight_attr=None,
                 bias_attr=None, data_format="NCDHW", device=None, dtype=None):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride, padding,
                         dilation, groups, "zeros", weight_attr, bias_attr, data_format,
                         transposed=True, device=device, dtype=dtype)
        self._output_padding = output_padding

    def forward(self, x, output_size=None):
        return F.conv3d_transpose(x, self.weight, self.bias, self._stride,
                                  self._padding, self._output_padding, self._groups,
                                  self._dilation, self._data_format, output_size)
