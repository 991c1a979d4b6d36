"""Normalisation layers of the port (counterpart of `paddle_tpu/nn/norm.py`):
RMSNorm (Llama), LayerNorm (BERT, the transformer layers), the batch
norms (ResNet, VGG), GroupNorm, InstanceNorm, LocalResponseNorm and
SpectralNorm."""

from __future__ import annotations

import math

import torch
from torch import nn

from . import functional
from .conv import check_attr
from .functional import _refuse


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


class _BatchNormBase(nn.Module):
    """Batch normalisation (reference: nn/norm.py:15-51) over
    `functional.batch_norm`: batch statistics in training, the running ones
    in eval or with `use_global_stats`; the running statistics, buffers
    `_mean` (zeros) and `_variance` (ones) in float32, move by paddle's
    `momentum` (0.9: running = 0.9 running + 0.1 batch), the variance
    unbiased.  Weight 1 and bias 0 at first; `weight_attr` / `bias_attr`
    False leave either out.  AMP O2 keeps the parameters float32
    (`amp.KEEP_FP32`) and the output in the input's dtype."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", use_global_stats=None, name=None,
                 device=None, dtype=None):
        super().__init__()
        self._num_features = num_features
        self._momentum = momentum
        self._epsilon = epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(num_features, **kw))
                       if check_attr(weight_attr, "weight_attr") else None)
        self.bias = (nn.Parameter(torch.zeros(num_features, **kw))
                     if check_attr(bias_attr, "bias_attr") else None)
        self.register_buffer("_mean", torch.zeros(num_features, dtype=torch.float32,
                                                  device=device))
        self.register_buffer("_variance", torch.ones(num_features, dtype=torch.float32,
                                                     device=device))

    def forward(self, x):
        return functional.batch_norm(x, self._mean, self._variance, self.weight,
                                     self.bias, training=self.training,
                                     momentum=self._momentum, epsilon=self._epsilon,
                                     data_format=self._data_format,
                                     use_global_stats=self._use_global_stats)

    def extra_repr(self):
        return (f"num_features={self._num_features}, momentum={self._momentum}, "
                f"epsilon={self._epsilon}")


class BatchNorm(_BatchNormBase):
    pass


class BatchNorm1D(_BatchNormBase):
    pass


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    pass


class SyncBatchNorm(_BatchNormBase):
    """Batch normalisation over the local batch: on one card the same as
    `BatchNorm` (reference: nn/norm.py:70-97, which computes global
    statistics only under a sharded compiled step).  Statistics across
    cards come with `distributed/` (ROADMAP.md Queue 1, position 5)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """`layer` with every batch norm in it (itself included) replaced by
        a SyncBatchNorm holding the same weight, bias and running
        statistics, as the reference converts."""
        out = layer
        if isinstance(layer, _BatchNormBase) and not isinstance(layer, SyncBatchNorm):
            ref = layer._mean
            out = cls(layer._num_features, layer._momentum, layer._epsilon,
                      data_format=layer._data_format, device=ref.device)
            with torch.no_grad():
                for name in ("weight", "bias"):
                    if getattr(layer, name) is not None:
                        getattr(out, name).data = getattr(layer, name).data
                out._mean, out._variance = layer._mean, layer._variance
        for name, sub in list(layer.named_children()):
            setattr(layer, name, cls.convert_sync_batchnorm(sub))
        return out


class GroupNorm(nn.Module):
    """Group normalisation (reference: nn/norm.py:137-153) over
    `functional.group_norm`, NCHW only (the reference ignores
    `data_format`).  AMP O2 keeps its parameters float32."""

    def __init__(self, num_groups, num_channels, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__()
        _refuse("GroupNorm data_format", data_format, "NCHW", "norm.py:137-153")
        self._num_groups = num_groups
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        self.weight = (nn.Parameter(torch.ones(num_channels, **kw))
                       if check_attr(weight_attr, "weight_attr") else None)
        self.bias = (nn.Parameter(torch.zeros(num_channels, **kw))
                     if check_attr(bias_attr, "bias_attr") else None)

    def forward(self, x):
        return functional.group_norm(x, self._num_groups, self._epsilon, self.weight,
                                     self.bias)


class InstanceNorm1D(nn.Module):
    """Instance normalisation (reference: nn/norm.py:155-171) over
    `functional.instance_norm`, channels first.  As in the reference,
    `weight_attr` False leaves out the weight and the bias, and a bias is
    made whatever `bias_attr` says otherwise; the reference ignores
    `momentum` and `data_format`, so other values raise here."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCL", name=None, device=None, dtype=None):
        super().__init__()
        where = "norm.py:155-171"
        _refuse(f"{type(self).__name__} momentum", momentum, 0.9, where)
        if not data_format.startswith("NC"):
            _refuse(f"{type(self).__name__} data_format", data_format, "NCL", where)
        self._epsilon = epsilon
        kw = dict(device=device, dtype=dtype)
        affine = check_attr(weight_attr, "weight_attr")
        check_attr(bias_attr, "bias_attr")
        self.weight = nn.Parameter(torch.ones(num_features, **kw)) if affine else None
        self.bias = nn.Parameter(torch.zeros(num_features, **kw)) if affine else None

    def forward(self, x):
        return functional.instance_norm(x, weight=self.weight, bias=self.bias,
                                        eps=self._epsilon)


class InstanceNorm2D(InstanceNorm1D):
    def __init__(self, num_features, epsilon=1e-5, momentum=0.9, weight_attr=None,
                 bias_attr=None, data_format="NCHW", name=None, device=None, dtype=None):
        super().__init__(num_features, epsilon, momentum, weight_attr, bias_attr,
                         data_format, name, device, dtype)


class LocalResponseNorm(nn.Module):
    """`functional.local_response_norm` (the reference's `alpha`, not
    torch's alpha / size), NCHW only."""

    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                 name=None):
        super().__init__()
        _refuse("LocalResponseNorm data_format", data_format, "NCHW", "norm.py:174-180")
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k

    def forward(self, x):
        return functional.local_response_norm(x, self.size, self.alpha, self.beta,
                                              self.k)


class SpectralNorm(nn.Module):
    """weight / sigma_max(weight) (reference: nn/norm.py:183-243), sigma
    from `power_iters` power iterations on `weight_u` [h] and `weight_v`
    [w] (parameters without gradients, unit vectors drawn from `generator`
    at first), h = weight_shape[dim] and w the rest.  The iterations run
    on the weight as a constant and u, v are constants in the backward, as
    the reference's spectral_norm_grad takes them; u and v advance only in
    training."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12, name=None,
                 device=None, generator=None):
        super().__init__()
        self.dim, self.power_iters, self.epsilon = dim, power_iters, epsilon
        h = int(weight_shape[dim])
        w = math.prod(int(n) for n in weight_shape) // h
        u, v = (torch.randn(n, generator=generator, dtype=torch.float32, device=device)
                for n in (h, w))
        self.weight_u = nn.Parameter(u / (u.norm() + epsilon), requires_grad=False)
        self.weight_v = nn.Parameter(v / (v.norm() + epsilon), requires_grad=False)

    def forward(self, weight):
        h = weight.shape[self.dim]
        mat = weight.movedim(self.dim, 0).reshape(h, -1).float()
        u, v = self.weight_u, self.weight_v
        with torch.no_grad():
            for _ in range(self.power_iters):
                v = mat.T @ u
                v = v / (v.norm() + self.epsilon)
                u = mat @ v
                u = u / (u.norm() + self.epsilon)
            if self.training:
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            u, v = u.clone(), v.clone()
        sigma = u @ mat @ v
        return weight / sigma.to(weight.dtype)
