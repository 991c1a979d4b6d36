"""Gradient clipping of the port (counterpart of `paddle_tpu/nn/clip.py`).

The clip classes are called by an optimizer (`grad_clip=`) on a list of
(param, grad) pairs and return new pairs; a parameter whose `need_clip`
attribute is False, or a missing gradient, passes through.  Everything
stays on the device: no host sync.  `clip_grad_norm_` and
`clip_grad_value_` clip the `.grad` of parameters in place."""

from __future__ import annotations

import torch


def _clipped(p, g):
    return g is not None and getattr(p, "need_clip", True)


class ClipGradByValue:
    """Clamp every gradient entry to [min, max] (min defaults to -max;
    reference nn/clip.py:17)."""

    def __init__(self, max, min=None):
        self.max = max
        self.min = min if min is not None else -max

    def __call__(self, params_grads):
        return [(p, torch.clamp(g, self.min, self.max)) if _clipped(p, g) else (p, g)
                for p, g in params_grads]


class ClipGradByNorm:
    """Scale each gradient by min(1, clip_norm / ||g||), its own L2 norm
    taken in its dtype (reference nn/clip.py:33)."""

    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def __call__(self, params_grads):
        out = []
        for p, g in params_grads:
            if _clipped(p, g):
                norm = torch.clamp((g * g).sum().sqrt(), min=1e-12)
                g = g * torch.clamp(self.clip_norm / norm, max=1.0)
            out.append((p, g))
        return out


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global_norm), the global
    norm taken in float32 over the clipped gradients (reference:
    nn/clip.py:52); each scaled gradient keeps its dtype."""

    def __init__(self, clip_norm, group_name="default_group", auto_skip_clip=False):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if _clipped(p, g)]
        if not grads:
            return params_grads
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        return [(p, g * scale.to(g.dtype)) if _clipped(p, g) else (p, g)
                for p, g in params_grads]


def clip_grad_norm_(parameters, max_norm, norm_type=2.0, error_if_nonfinite=False):
    """Clip the gradients of `parameters` in place by their global norm
    (`ClipGradByGlobalNorm`) and return the norm before clipping, summed
    in the gradients' dtype.  Only the L2 norm, as in the reference (which
    takes `norm_type` and ignores it)."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    pgs = [(p, p.grad) for p in parameters if p.grad is not None]
    for p, g in ClipGradByGlobalNorm(max_norm)(pgs):
        p.grad = g
    return torch.sqrt(sum((g * g).sum() for _, g in pgs))


def clip_grad_value_(parameters, clip_value):
    """Clamp the gradients of `parameters` to [-clip_value, clip_value] in
    place."""
    if isinstance(parameters, torch.Tensor):
        parameters = [parameters]
    for p in parameters:
        if p.grad is not None:
            p.grad = torch.clamp(p.grad, -clip_value, clip_value)


__all__ = ["ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm",
           "clip_grad_norm_", "clip_grad_value_"]
