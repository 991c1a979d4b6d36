"""Gradient clipping of the port (counterpart of `paddle_tpu/nn/clip.py`)."""

from __future__ import annotations

import torch


class ClipGradByGlobalNorm:
    """Scale every gradient by min(1, clip_norm / global_norm), the global
    norm taken in float32 over the gradients of the parameters whose
    `need_clip` attribute is not False (reference: nn/clip.py:52).  Called
    by an optimizer (`grad_clip=`) on a list of (param, grad) pairs; returns
    new pairs, each scaled gradient in its own dtype.  Stays on the device:
    no host sync."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    @staticmethod
    def _clipped(p, g):
        return g is not None and getattr(p, "need_clip", True)

    def __call__(self, params_grads):
        grads = [g for p, g in params_grads if self._clipped(p, g)]
        if not grads:
            return params_grads
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        scale = torch.clamp(self.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
        return [(p, g * scale.to(g.dtype)) if self._clipped(p, g) else (p, g)
                for p, g in params_grads]


__all__ = ["ClipGradByGlobalNorm"]
