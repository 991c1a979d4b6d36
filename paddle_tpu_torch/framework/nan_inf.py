"""`FLAGS_check_nan_inf` of the port (reference: `ops/dispatch.py:391-408`,
`jit/__init__.py:491-510`): every floating output of every operator is
checked for NaN and Inf.

- Eager: turning the flag on (`set_flags`) pushes a `NanInfCheck`, a
  TorchDispatchMode, onto the calling thread's mode stack (autograd's
  threads inherit the stack for that thread's backward); an operator whose
  floating output is not finite raises FloatingPointError naming the
  operator, under `no_grad` too.  Turning the flag off pops it, so an
  unchecked program runs no mode, no extra kernel and no extra fetch.
  Each thread that turns the flag on is checked by a mode of its own;
  other threads are not checked.
- Inside a `jit.to_static` call (`recording`): a mode of the call's own
  adds each floating output's all-finite flag to the call's record, on the
  device without a sync; a captured step stacks them into one buffer its
  graph writes, and after each replay one host read (`raise_if_bad`)
  raises FloatingPointError naming the first operators that failed ("NaN
  or Inf found in compiled step; first offending ops: ...").  The flag is
  part of the call's signature, so turning it on or off traces again.
- Inside another CUDA graph capture (the serving engine's steps) nothing
  is checked, since a capture cannot read a value; the first such operator
  warns that it is not.

What is checked is what an operator wrote: the allocators (`empty`,
`empty_like`, `new_empty`, ...) hand out memory that still holds what it
last held, and a view shows what its base holds, so neither is read.  The
port's attention kernels launched through ctypes write their outputs
outside the dispatcher's sight; their wrappers hand those outputs to
`check_written` after the launch.  (The optimizer kernels update their
state in place from gradients that were checked where they were made.)
"""

from __future__ import annotations

import contextlib
import warnings

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import (TorchDispatchMode, _disable_current_modes,
                                         _get_current_dispatch_mode_stack)

# operators whose output holds no value they computed: memory as the
# allocator left it, or another tensor's storage
_UNWRITTEN = frozenset({"empty", "empty_like", "empty_strided", "empty_permuted",
                        "new_empty", "new_empty_strided", "resize_", "resize_as_", "set_"})

_eager_on = False  # FLAGS_check_nan_inf as `install` last set it


def _op_name(func):
    packet = getattr(func, "overloadpacket", None)
    return getattr(packet, "__name__", None) or getattr(func, "__name__", str(func))


def _unwritten(func, name):
    return name in _UNWRITTEN or getattr(func, "is_view", False)


def _checked(t):
    return (isinstance(t, torch.Tensor) and (t.is_floating_point() or t.is_complex())
            and t.device.type != "meta" and type(t) in (torch.Tensor, torch.nn.Parameter))


class NanInfCheck(TorchDispatchMode):
    """The check of one thread (`sink` None: each floating output read on
    the host while the flag is on) or of one to_static call (`sink` a list:
    (op name, 0-dim bool all-finite tensor) appended for each)."""

    def __init__(self, sink=None):
        super().__init__()
        self.sink = sink
        self.paused = False
        self._warned = False

    def live(self):
        return not self.paused and (self.sink is not None or _eager_on)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.live():
            name = _op_name(func)
            if not _unwritten(func, name):
                self.check(name, pytree.tree_leaves(out))
        return out

    def check(self, name, tensors):
        """Record or check the floating tensors among `tensors`, the
        outputs of the operator or kernel `name`."""
        for t in tensors:
            if not _checked(t):
                continue
            if self.sink is not None:
                self.sink.append((name, torch.isfinite(t).all()))
            elif t.is_cuda and torch.cuda.is_current_stream_capturing():
                if not self._warned:
                    self._warned = True
                    warnings.warn("FLAGS_check_nan_inf: operators captured into a CUDA "
                                  "graph outside jit.to_static are not checked",
                                  stacklevel=2)
            elif not bool(torch.isfinite(t).all()):
                raise FloatingPointError(f"NaN or Inf found in output of op '{name}'")


def _modes():
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, NanInfCheck)]


def installed():
    """Whether a check is on this thread's dispatch-mode stack."""
    return bool(_modes())


def install(on):
    """FLAGS_check_nan_inf's change: on, this thread's eager check is pushed
    (once); off, every thread's eager check passes every operator through,
    and this thread's is popped when it is the innermost mode (one under
    another mode stays until that mode is gone)."""
    global _eager_on
    _eager_on = bool(on)
    mine = [m for m in _modes() if m.sink is None]
    if on and not mine:
        NanInfCheck().__enter__()
    elif not on and mine:
        stack = _get_current_dispatch_mode_stack()
        if stack[-1] is mine[-1]:
            mine[-1].__exit__(None, None, None)


def check_written(name, tensors):
    """A kernel `name` wrote `tensors` outside the dispatcher: check them as
    the innermost live check on this thread would check an operator's
    outputs (nothing without one).  The check's own operators run past
    every mode, as they do inside an operator's dispatch."""
    if not torch._C._len_torch_dispatch_stack():
        return
    for mode in reversed(_modes()):
        if mode.live():
            with _disable_current_modes():
                mode.check(name, tensors)
            return


@contextlib.contextmanager
def recording():
    """Record the all-finite flags of every operator run inside (on this
    thread and on autograd's threads for its backward) into the yielded
    list, without a host read."""
    mode = NanInfCheck(sink=[])
    with mode:
        yield mode.sink


@contextlib.contextmanager
def paused():
    """No eager check of this thread inside (a to_static call's own copies
    of its inputs and outputs); a `recording` inside still records."""
    mine = [m for m in _modes() if m.sink is None and not m.paused]
    for m in mine:
        m.paused = True
    try:
        yield
    finally:
        for m in mine:
            m.paused = False


def stack_flags(sink):
    """(op names, one bool tensor of every recorded flag) of a record."""
    if not sink:
        return [], None
    names = [n for n, _ in sink]
    return names, torch.stack([f for _, f in sink])


def raise_if_bad(names, flags):
    """One host read of a step's flags: raise FloatingPointError with the
    first operators whose output was not finite."""
    if flags is None:
        return
    ok = flags.cpu()
    if not bool(ok.all()):
        bad = [n for n, good in zip(names, ok.tolist()) if not good]
        raise FloatingPointError("NaN or Inf found in compiled step; first offending "
                                 "ops: " + ", ".join(bad[:5]))
