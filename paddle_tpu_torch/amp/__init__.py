"""Mixed precision of the port (counterpart of `paddle_tpu/amp/__init__.py`).

Only bf16 O2 is ported: `decorate(level="O2")` casts every float32
parameter to bf16 except those of the normalisation layers, and gives the
optimizers float32 master weights.  The reference also casts at dispatch
level (white-list ops take bf16 inputs, black-list ops -- cross-entropy,
softmax, norm statistics -- take float32).  The port makes those casts
explicit where they land instead of using `torch.autocast`, which would
cast other ops than the reference does:

- `RMSNorm` and `LayerNorm` normalise in float32 and return the stream's
  dtype, so the residual stream stays bf16 (nn/norm.py; the reference's
  O2 casts layer_norm's input to float32, so its stream after a LayerNorm
  is float32);
- attention runs in the stream's dtype with float32 softmax in-kernel;
- logits go to float32 in `models._utils.sequence_ce` and
  `nn.functional.cross_entropy`.

O1 and fp16 loss scaling (`GradScaler`) are not needed by a bf16 step and
are not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ..framework.core import to_torch_dtype
from ..nn.norm import LayerNorm, RMSNorm

# layers whose parameters stay float32 under O2 (reference: amp :62; the
# port has no BatchNorm/GroupNorm/SpectralNorm of its own yet)
KEEP_FP32 = (LayerNorm, RMSNorm)

_NOT_PORTED = "is not ported yet (ROADMAP.md Queue 1, item 12b: fp16 GradScaler and AMP O1)"


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """Cast `models` (one nn.Module or a list) for bf16 O2 in place and give
    `optimizers` (one port Optimizer or a list) float32 master weights
    unless `master_weight` is False.  Returns (models, optimizers), or
    models alone when no optimizer is given, like the reference."""
    if level == "O1":
        raise NotImplementedError(f"AMP level O1 {_NOT_PORTED}")
    if level != "O2":
        raise ValueError(f"amp level must be O1 or O2, got {level!r}")
    target = to_torch_dtype(dtype)
    if target != torch.bfloat16:
        raise NotImplementedError(f"AMP O2 in {target} (needs loss scaling) {_NOT_PORTED}")
    model_list = [models] if isinstance(models, nn.Module) else list(models)
    for model in model_list:
        for mod in model.modules():
            if isinstance(mod, KEEP_FP32):
                continue
            for p in mod.parameters(recurse=False):
                if p.dtype == torch.float32:
                    p.data = p.data.to(target)
    if optimizers is None:
        return models
    if master_weight is None or master_weight:
        opts = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        for opt in opts:
            opt._create_master_weights()
    return models, optimizers


def auto_cast(*args, **kwargs):
    raise NotImplementedError(f"auto_cast (dispatch-level AMP) {_NOT_PORTED}")


class GradScaler:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"GradScaler {_NOT_PORTED}")


__all__ = ["decorate", "auto_cast", "GradScaler", "KEEP_FP32"]
