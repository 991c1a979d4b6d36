"""Weight-decay regularizers of the port (counterpart of
`paddle_tpu/regularizer.py`).  The optimizers take them wherever a float
`weight_decay` goes; `coeff` carries the strength and `float()` reads it."""

from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class _Decay:
    def __init__(self, coeff=0.0):
        self.coeff = float(coeff)

    def __float__(self):
        return self.coeff

    def __repr__(self):
        return f"{type(self).__name__}(coeff={self.coeff})"


class L2Decay(_Decay):
    """Classic weight decay: grad += coeff * param."""


class L1Decay(_Decay):
    """L1 regularization: grad += coeff * sign(param)."""
