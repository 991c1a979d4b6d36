"""Mixed precision of the port (counterpart of `paddle_tpu/amp/__init__.py`).

- `decorate(level="O2")` casts every float32 parameter to the AMP dtype
  (bf16, or fp16) except those of the normalisation layers, and gives the
  optimizers float32 master weights.  The port's O2 makes the reference's
  dispatch-level casts explicit where they land: `RMSNorm` and `LayerNorm`
  normalise in float32 and return the stream's dtype (nn/norm.py),
  attention runs in the stream's dtype with float32 softmax in-kernel, and
  logits go to float32 in `models._utils.sequence_ce` and
  `nn.functional.cross_entropy`.  Like the reference's `amp_forward`
  (paddle_tpu/amp/__init__.py:84-105), it also makes an O2 state active
  for the length of each decorated model's forward (a forward pre-hook
  and an always-called forward hook): the port's convolutions read it and
  cast their inputs to the AMP dtype, so a float32 image batch meets its
  first conv in bf16, and `batch_norm` keeps its weight and bias in
  float32.  No torch function is intercepted there (Llama's and BERT's
  host-bound steps pay for no `TorchFunctionMode`), and `layer_norm`
  keeps its own rule in that scope, so their O2 numerics stay as they
  were.  `decorate(level="O1")` returns its arguments unchanged, as the
  reference does.
- `auto_cast` (O1, O2) casts where the reference's dispatcher casts
  (`ops/dispatch.py:431-452`): the inputs of the white ops (`matmul`,
  `linear`, the convolutions, `conv2d_transpose`, `conv3d_transpose`)
  to the AMP dtype, the bf16 and fp16 inputs of the black ops (`softmax`,
  `log_softmax`, `layer_norm`, the weight and bias of `batch_norm`, the
  logits of `cross_entropy`) to float32.  The port's Linear layers are
  `torch.nn.Linear`, so the torch functions are cast by a
  `torch.overrides.TorchFunctionMode` entered for the context; the port's
  own `nn.functional.layer_norm` casts at its call site.  No other op is
  touched: `torch.autocast`'s lists are not the reference's.
  `custom_white_list` / `custom_black_list` move an op between the lists
  (the reference stores them and casts by its fixed lists).
- `GradScaler`: dynamic loss scaling with the scale, its counters and the
  found-inf flag on the device.  `unscale_` is one launch of the
  hand-written `unscale_fused` kernel on the card
  (`ops.optim.unscale_multi`); `step` hands the flag to the optimizer,
  whose Adam/AdamW kernel skips on the device (the other optimizers read
  it on the host, as the reference's eager `step` does); `update` moves
  the scale with device ops and no host sync.

Float16 CUDA tensors reach kernels K1-K6 (`ops/flash_attention.py`) as
bf16 ones do, each kernel with a float16 instantiation; on the CPU fp16
runs through the plain versions.
"""

from __future__ import annotations

import contextlib
import threading
import weakref

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.overrides import TorchFunctionMode

from ..framework import core as _core
from ..framework.core import to_torch_dtype
from ..nn.norm import (GroupNorm, LayerNorm, RMSNorm, SpectralNorm,
                       _BatchNormBase)
from ..ops import optim as _optim

# layers whose parameters stay float32 under O2 (reference: amp :60-62)
KEEP_FP32 = (_BatchNormBase, GroupNorm, LayerNorm, RMSNorm, SpectralNorm,
             nn.LayerNorm, nn.GroupNorm, nn.modules.batchnorm._NormBase)

WHITE_LIST = frozenset({"matmul", "linear", "conv1d", "conv2d", "conv3d",
                        "conv2d_transpose", "conv3d_transpose"})
BLACK_LIST = frozenset({"softmax", "log_softmax", "layer_norm", "batch_norm",
                        "cross_entropy"})

# the torch callables of each op the lists name, and which of their inputs
# the reference casts: None every tensor, else (position, keyword) pairs
_TORCH_OPS = {
    "linear": ((F.linear,), None),
    "matmul": ((torch.matmul, torch.Tensor.matmul, torch.Tensor.__matmul__,
                torch.Tensor.__rmatmul__), None),
    "conv1d": ((F.conv1d,), None),
    "conv2d": ((F.conv2d,), None),
    "conv3d": ((F.conv3d,), None),
    "conv2d_transpose": ((F.conv_transpose2d,), None),
    "conv3d_transpose": ((F.conv_transpose3d,), None),
    "softmax": ((F.softmax, torch.softmax, torch.Tensor.softmax), None),
    "log_softmax": ((F.log_softmax, torch.log_softmax, torch.Tensor.log_softmax),
                    None),
    "layer_norm": ((F.layer_norm,), None),
    "batch_norm": ((F.batch_norm,), ((3, "weight"), (4, "bias"))),
    "cross_entropy": ((F.cross_entropy,), ((0, "input"),)),
}
_OP_OF = {fn: (op, which) for op, (fns, which) in _TORCH_OPS.items() for fn in fns}


class _AutoCastMode(TorchFunctionMode):
    """Casts the inputs of the listed torch functions by an AmpState."""

    def __init__(self, state):
        super().__init__()
        self.state = state

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        found = _OP_OF.get(func)
        if found is not None:
            op, which = found
            cast = lambda t: self.state.cast(op, t)  # noqa: E731
            if which is None:
                args = tuple(cast(a) for a in args)
                kwargs = {k: cast(v) for k, v in kwargs.items()}
            else:
                args = list(args)
                for pos, key in which:
                    if pos < len(args):
                        args[pos] = cast(args[pos])
                    elif key in kwargs:
                        kwargs[key] = cast(kwargs[key])
        return func(*args, **kwargs)


@contextlib.contextmanager
def auto_cast(enable=True, custom_white_list=None, custom_black_list=None,
              level="O1", dtype="bfloat16", use_promote=True):
    """Within the context, the white ops run in `dtype` and the black ops in
    float32 (see the module docstring); `level` "O0" or `enable=False`
    casts nothing."""
    if level not in ("O0", "O1", "O2"):
        raise ValueError(f"amp level must be O0/O1/O2, got {level}")
    white, black = set(custom_white_list or ()), set(custom_black_list or ())
    if white & black:
        raise ValueError(f"ops in both custom lists: {sorted(white & black)}")
    if not enable or level == "O0":
        yield
        return
    state = _core.AmpState(to_torch_dtype(dtype), (WHITE_LIST - black) | white,
                           (BLACK_LIST - white) | black)
    old = _core.set_active_amp(state)
    try:
        with _AutoCastMode(state):
            yield
    finally:
        _core.set_active_amp(old)


amp_guard = auto_cast

_scopes = threading.local()  # per thread: the states the O2 scopes replaced


def _scope_forward(model, dtype):
    """Make an O2 state active for each call of `model`'s forward (the
    reference's `amp_forward`), by a pre-hook and an always-called hook; a
    model decorated twice keeps its first scope.  `layer_norm` is left to
    its own rule in this scope (float32 statistics, the stream's dtype
    out), as the port's O2 has it."""
    if getattr(model, "_amp_scoped", False):
        return
    state = _core.AmpState(dtype, WHITE_LIST, BLACK_LIST - {"layer_norm"})

    def enter(module, args):
        if not hasattr(_scopes, "stack"):
            _scopes.stack = []
        _scopes.stack.append(_core.set_active_amp(state))

    def leave(module, args, output):
        _core.set_active_amp(_scopes.stack.pop())

    model.register_forward_pre_hook(enter)
    model.register_forward_hook(leave, always_call=True)
    model._amp_scoped = True


def decorate(models, optimizers=None, level="O2", dtype="bfloat16",
             master_weight=None, save_dtype=None):
    """O2: cast `models` (one nn.Module or a list) to `dtype` in place,
    norm layers kept float32, scope the O2 state to each model's forward
    (see the module docstring), and give `optimizers` (one port Optimizer
    or a list) float32 master weights unless `master_weight` is False.
    O1: nothing changes.  Returns (models, optimizers), or models alone
    when no optimizer is given, like the reference."""
    if level not in ("O1", "O2"):
        raise ValueError(f"amp level must be O1 or O2, got {level!r}")
    if level == "O1":
        return (models, optimizers) if optimizers is not None else models
    target = to_torch_dtype(dtype)
    if target not in (torch.bfloat16, torch.float16):
        raise ValueError(f"AMP O2 casts to bfloat16 or float16, got {dtype!r}")
    model_list = [models] if isinstance(models, nn.Module) else list(models)
    for model in model_list:
        for mod in model.modules():
            if isinstance(mod, KEEP_FP32):
                continue
            for p in mod.parameters(recurse=False):
                if p.dtype == torch.float32:
                    p.data = p.data.to(target)
        _scope_forward(model, target)
    if optimizers is None:
        return models
    if master_weight is None or master_weight:
        opts = optimizers if isinstance(optimizers, (list, tuple)) else [optimizers]
        for opt in opts:
            opt._create_master_weights()
    return models, optimizers


class GradScaler:
    """Dynamic loss scaling (reference: amp/__init__.py:113-401).

    `scale(loss)` multiplies by the scale; `unscale_(opt)` divides opt's
    gradients by it in place and sets the device flag `found_inf` when one
    is not finite; `step(opt)` unscales if that was not done, then steps
    the optimizer unless the flag is set; `update()` halves the scale after
    `decr_every_n_nan_or_inf` bad steps, doubles it after
    `incr_every_n_steps` good ones (ratios `decr_ratio`, `incr_ratio`).
    Per optimizer, INIT -> UNSCALED -> STEPPED until `update()`; a second
    `unscale_` or `step` raises RuntimeError.  The scale and counters live
    on the device of the first loss or gradient they meet."""

    def __init__(self, enable=True, init_loss_scaling=2.0 ** 15, incr_ratio=2.0,
                 decr_ratio=0.5, incr_every_n_steps=2000, decr_every_n_nan_or_inf=1,
                 use_dynamic_loss_scaling=True):
        self._enable = enable
        self._scale = torch.tensor(float(init_loss_scaling), dtype=torch.float32)
        self._good_steps = torch.zeros((), dtype=torch.int32)
        self._bad_steps = torch.zeros((), dtype=torch.int32)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._found_inf = None  # int32 device flag of the current cycle
        self._last_found = None  # the last finished cycle's flag
        self._optimizer_states = weakref.WeakKeyDictionary()
        self._table = _optim.MultiTensorTable()

    def is_enable(self):
        return self._enable

    def is_use_dynamic_loss_scaling(self):
        return self._dynamic

    def get_loss_scaling(self):
        return self._scale

    def set_init_loss_scaling(self, v):
        self._scale.fill_(float(v))

    @property
    def last_found_inf(self):
        """Whether the last `update()`d cycle found an inf or nan (read from
        the device here, not in `update()`)."""
        return self._last_found is not None and bool(self._last_found)

    def _on(self, device):
        """The scale, its counters on `device` (moved there on first use)."""
        if self._scale.device != device:
            self._scale = self._scale.to(device)
            self._good_steps = self._good_steps.to(device)
            self._bad_steps = self._bad_steps.to(device)
        return self._scale

    def scale(self, var):
        if not self._enable:
            return var
        return var * self._on(var.device).to(var.dtype)

    def unscale_(self, optimizer):
        if not self._enable:
            return
        st = self._optimizer_states.get(optimizer, "INIT")
        if st == "UNSCALED":
            raise RuntimeError("unscale_() has already been called on this "
                               "optimizer since the last update().")
        if st == "STEPPED":
            raise RuntimeError("unscale_() must be called before step().")
        self._optimizer_states[optimizer] = "UNSCALED"
        grads = [g for _, g in optimizer._params_grads()]
        if not grads:
            return
        scale = self._on(grads[0].device)
        if self._found_inf is None:
            self._found_inf = torch.zeros((), dtype=torch.int32, device=scale.device)
        # one flag per cycle: a later optimizer's unscale ORs into it
        _optim.unscale_multi(grads, scale, self._found_inf, table=self._table)

    def step(self, optimizer):
        """The reference's contract: step(opt) then update(); step skips the
        update when an inf or nan was found and does not move the scale."""
        if not self._enable:
            optimizer.step()
            return
        st = self._optimizer_states.get(optimizer, "INIT")
        if st == "STEPPED":
            raise RuntimeError("step() has already been called since the last update().")
        if st == "INIT":
            self.unscale_(optimizer)
        if self._found_inf is None:
            optimizer.step()  # no gradient was unscaled
        else:
            optimizer.step(found_inf=self._found_inf)
        self._optimizer_states[optimizer] = "STEPPED"

    def minimize(self, optimizer, scaled_loss):
        scaled_loss.backward()
        self.step(optimizer)
        self.update()

    def update(self):
        """Move the scale and its counters by this cycle's flag, on the
        device, and start a new cycle."""
        if not self._enable:
            return
        found = self._found_inf
        if found is not None:
            self._last_found = found
            if self._dynamic:
                scale = self._on(found.device)
                good, bad = self._good_steps, self._bad_steps
                hit = found != 0
                bad_n = torch.where(hit, bad + 1, 0)
                good_n = torch.where(hit, 0, good + 1)
                dec = bad_n >= self._decr_every
                inc = good_n >= self._incr_every
                scale.copy_(torch.where(dec, scale * self._decr_ratio,
                                        torch.where(inc, scale * self._incr_ratio,
                                                    scale)))
                bad.copy_(torch.where(dec, 0, bad_n))
                good.copy_(torch.where(inc, 0, good_n))
        self._found_inf = None
        self._optimizer_states.clear()

    def state_dict(self):
        return {
            "scale": np.asarray(self._scale.cpu().numpy(), np.float32),
            "incr_ratio": self._incr_ratio,
            "decr_ratio": self._decr_ratio,
            "incr_every_n_steps": self._incr_every,
            "decr_every_n_nan_or_inf": self._decr_every,
            "good_steps": int(self._good_steps),
            "bad_steps": int(self._bad_steps),
        }

    def load_state_dict(self, state):
        self._scale.fill_(float(np.asarray(state["scale"])))
        self._good_steps.fill_(int(state.get("good_steps", 0)))
        self._bad_steps.fill_(int(state.get("bad_steps", 0)))


def is_float16_supported(device=None):
    return True


def is_bfloat16_supported(device=None):
    return True


class debugging:
    """Operator statistics (reference: no-ops as here)."""

    @staticmethod
    def enable_operator_stats_collection():
        pass

    @staticmethod
    def disable_operator_stats_collection():
        pass


__all__ = ["decorate", "auto_cast", "amp_guard", "GradScaler", "KEEP_FP32",
           "WHITE_LIST", "BLACK_LIST", "is_float16_supported",
           "is_bfloat16_supported", "debugging"]
