"""Pooling layers of the port (counterpart of `paddle_tpu/nn/pooling.py`)
over `functional`'s pools.  What a reference layer takes and ignores
(`ceil_mode`, `return_mask`, the 3-D layers' `data_format`) raises
NotImplementedError for a value other than the default."""

from __future__ import annotations

from torch import nn

from . import functional as F
from .functional import _refuse

_WHERE = "pooling.py"


class MaxPool1D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, name=None):
        super().__init__()
        _refuse("MaxPool1D return_mask", return_mask, False, f"{_WHERE}:9-16")
        _refuse("MaxPool1D ceil_mode", ceil_mode, False, f"{_WHERE}:9-16")
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.max_pool1d(x, self.k, self.s, self.p)


class MaxPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCHW", name=None):
        super().__init__()
        _refuse("MaxPool2D return_mask", return_mask, False, f"{_WHERE}:19-27")
        _refuse("MaxPool2D ceil_mode", ceil_mode, False, f"{_WHERE}:19-27")
        self.k, self.s, self.p = kernel_size, stride, padding
        self.data_format = data_format

    def forward(self, x):
        return F.max_pool2d(x, self.k, self.s, self.p, data_format=self.data_format)


class AvgPool1D(nn.Module):
    """Window sums over k, whatever `exclusive` says (reference
    functional :625)."""

    def __init__(self, kernel_size, stride=None, padding=0, exclusive=True,
                 ceil_mode=False, name=None):
        super().__init__()
        _refuse("AvgPool1D ceil_mode", ceil_mode, False, f"{_WHERE}:30-37")
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive

    def forward(self, x):
        return F.avg_pool1d(x, self.k, self.s, self.p, self.exclusive)


class AvgPool2D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCHW", name=None):
        super().__init__()
        _refuse("AvgPool2D ceil_mode", ceil_mode, False, f"{_WHERE}:40-49")
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive
        self.divisor_override = divisor_override
        self.data_format = data_format

    def forward(self, x):
        return F.avg_pool2d(x, self.k, self.s, self.p, exclusive=self.exclusive,
                            divisor_override=self.divisor_override,
                            data_format=self.data_format)


class AdaptiveAvgPool1D(nn.Module):
    def __init__(self, output_size, name=None):
        super().__init__()
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool1d(x, self.output_size)


class AdaptiveAvgPool2D(nn.Module):
    def __init__(self, output_size, data_format="NCHW", name=None):
        super().__init__()
        self.output_size = output_size
        self.data_format = data_format

    def forward(self, x):
        return F.adaptive_avg_pool2d(x, self.output_size, data_format=self.data_format)


class AdaptiveMaxPool2D(nn.Module):
    def __init__(self, output_size, return_mask=False, name=None):
        super().__init__()
        _refuse("AdaptiveMaxPool2D return_mask", return_mask, False, f"{_WHERE}:71-77")
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_max_pool2d(x, self.output_size)


class MaxPool3D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, return_mask=False,
                 ceil_mode=False, data_format="NCDHW", name=None):
        super().__init__()
        for what, value, default in (("return_mask", return_mask, False),
                                     ("ceil_mode", ceil_mode, False),
                                     ("data_format", data_format, "NCDHW")):
            _refuse(f"MaxPool3D {what}", value, default, f"{_WHERE}:80-86")
        self.k, self.s, self.p = kernel_size, stride, padding

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p)


class AvgPool3D(nn.Module):
    def __init__(self, kernel_size, stride=None, padding=0, ceil_mode=False,
                 exclusive=True, divisor_override=None, data_format="NCDHW", name=None):
        super().__init__()
        _refuse("AvgPool3D ceil_mode", ceil_mode, False, f"{_WHERE}:89-97")
        _refuse("AvgPool3D data_format", data_format, "NCDHW", f"{_WHERE}:89-97")
        self.k, self.s, self.p = kernel_size, stride, padding
        self.exclusive = exclusive
        self.divisor_override = divisor_override

    def forward(self, x):
        return F.avg_pool3d(x, self.k, self.s, self.p, exclusive=self.exclusive,
                            divisor_override=self.divisor_override)


class AdaptiveAvgPool3D(nn.Module):
    def __init__(self, output_size, data_format="NCDHW", name=None):
        super().__init__()
        _refuse("AdaptiveAvgPool3D data_format", data_format, "NCDHW",
                f"{_WHERE}:100-106")
        self.output_size = output_size

    def forward(self, x):
        return F.adaptive_avg_pool3d(x, self.output_size)
