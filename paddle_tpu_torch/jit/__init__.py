"""Whole-step capture of the port (counterpart of `paddle_tpu/jit/__init__.py`).

`to_static(fn)` wraps a step -- forward, `loss.backward()`, `opt.step()`,
`opt.clear_grad()` -- into a `StaticFunction` with the reference's
contract:

- one executable per input signature, counted by `trace_count`
  (reference :183, :246).  The signature is the structure, shape, dtype
  and device of every tensor argument and the value of every other one
  (the reference's `_struct_signature`, :153);
- implicit state: the parameters, masters, optimizer moments, batch-norm
  statistics, the learning-rate scalar, the loss scaler's scale and
  counters and the random generators the step reads and writes are found
  while it runs (the reference's `_discover`, :189) and read and written
  in place;
- refreshers (`register_state_refresh`, :62-69) run before every call: an
  optimizer registers the copy of its learning rate into its device
  scalar, so a scheduler stepped between calls is seen, and a capture
  never bakes the rate of its own time in;
- no Python of the step after the trace.

On the card the executable is a CUDA graph, which keeps the hand-written
kernels (K1, K3, `adam_fused`, `unscale_fused`) as they are, so a replay
equals an eager step bit for bit.  The first call with a signature is the
trace:

1. an eager warm run of the step on a side stream, on static copies of the
   arguments.  This run is the call: its effects stay and its outputs are
   returned.  Under a `TorchFunctionMode` it finds the state (every tensor
   it touches that it did not make) and the `torch.Generator`s it draws
   from, including ones passed as `generator=` (BERT's dropout);
2. the gradients put back to their binding at the call (so the capture
   allocates them as the first call did), the cache emptied, and the
   capture (`inference.graphs.capture`, shared with the serving
   engine's `StepGraph`) with those generators registered.  The capture
   executes nothing, so no state moves twice.

A later call copies its arguments into the static inputs, checks that
every tensor the graph reads or writes is still the one captured at the
same address (the reference's stale-state retrace, `_prepare` :450-477:
a tensor rebound through `.data`, gradients cleared another way), retraces
if not, replays, puts the gradients the step leaves back in place and
returns copies of the outputs, which never alias the graph's buffers.  A
failed capture raises; there is no eager fallback on the card.

On the CPU each call runs the step eagerly on the static inputs, with the
same keys, discovery, refreshers, stale checks, `trace_count` and errors.

Inside a trace a host read raises as in the reference: `Tensor.numpy()`,
`item()` and `tolist()` RuntimeError (`paddle_tpu/tensor.py:186-192`), a
tensor used as a Python bool, int or float the TypeError that names
`paddle.static.nn.cond` (`tensor.py:337-349`), which branches on the
device inside a captured step.  `trace_count` and
`inference.graphs.trace_total` (`/metrics`' `paddle_sanitizer_traces_
total`) count every trace.

With `FLAGS_check_nan_inf` on (a part of the signature), a call records
every floating operator output's all-finite flag on the device (a capture
into one buffer its graph writes at every replay) and raises
FloatingPointError after the run, with the first operators that failed
(`framework/nan_inf.py`; reference :491-510).

`jit.save` exports a Layer, or the function of a bound StaticFunction,
through `inference.export` when given an `input_spec` (else it saves the
weights), and `jit.load` returns an `inference.Predictor` for an exported
program (reference :602-675).  `warmup(<dir>)` and
`clear_cache(persistent=True)` raise NotImplementedError naming the
ROADMAP.md item that ports them; `lowered_text` has no counterpart.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
import logging
import os
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from ..framework import core as _core
from ..framework import nan_inf as _nan
from ..ops import flash_attention as _fa
from ..ops import optim as _optim

_SNAPSHOTS = ("is not ported yet (ROADMAP.md Queue 1, item 13f: the AOT snapshot tier, "
              "paddle_tpu/jit/cache.py)")

# callables run before each call, keyed weakly by their owner (reference
# :62-69): an optimizer's learning-rate refresh
_state_refreshers = weakref.WeakKeyDictionary()

_NOT_TRACED = object()


def register_state_refresh(owner, fn):
    """Run fn(owner) before every StaticFunction call while owner lives."""
    _state_refreshers[owner] = fn


def _run_refreshers():
    for owner, fn in list(_state_refreshers.items()):
        fn(owner)


class _Call:
    """What one call's runs told the port's stateful objects' code: the
    loss scalers the step used and the accumulators it created (with their
    initial fill, which `warmup` puts back)."""

    __slots__ = ("scalers", "created")

    def __init__(self):
        self.scalers = {}
        self.created = []


def note_scaler(scaler):
    """Record that the active call's step uses `scaler` (amp.GradScaler)."""
    call = _core.active_static_call()
    if call is not None:
        call.scalers[id(scaler)] = scaler


def note_created(t, fill):
    """Record that the active call's step created the state tensor `t`
    filled with `fill` (an optimizer accumulator, the scaler's flag)."""
    call = _core.active_static_call()
    if call is not None:
        call.created.append((t, fill))


# -- the trace's view of a run -------------------------------------------------

_HOST_READS = {torch.Tensor.numpy: "numpy", torch.Tensor.item: "item",
               torch.Tensor.tolist: "tolist"}
_PY_SCALARS = {torch.Tensor.__bool__: "bool", torch.Tensor.__int__: "int",
               torch.Tensor.__float__: "float"}


def _refuse(func):
    what = _HOST_READS.get(func)
    if what is not None:
        raise RuntimeError(
            f"Tensor.{what}() is not allowed inside a @to_static traced "
            "function; return the tensor instead or compute on device.")
    kind = _PY_SCALARS.get(func)
    if kind is not None:
        raise TypeError(
            "A tensor's value was used as a Python {} inside a @to_static "
            "function.  The traced program runs once with abstract values, "
            "so data-dependent Python control flow (`if tensor:` / `while "
            "tensor:`) cannot be captured (reference contract: paddle.jit "
            "dy2static rewrites these to graph ops).  Use paddle.static.nn.cond "
            "/ paddle.static.nn.while_loop for tensor-dependent branching, or "
            "hoist the condition out of the compiled step.".format(kind))


def _tensors(obj):
    sink = []
    _flatten(obj, sink)
    return sink


class _Born(TorchDispatchMode):
    """Marks every tensor an operator makes during the run (the backward's
    too) as born in it, so that only tensors that existed before the call
    count as state."""

    def __init__(self, view):
        super().__init__()
        self.view = view

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.view.mark_born(out)
        return out


class _View(TorchFunctionMode):
    """One run of the step seen from the torch functions it calls.  Raises
    the reference's errors on host reads; with `record`, collects the state
    (pre-existing tensors, in first-touch order), each leaf's gradient
    binding at its first touch (None or its address) and the generators the
    step draws from; with `snapshot`, also keeps a copy of each before its
    first use (`warmup` puts them back)."""

    def __init__(self, inputs, record=True, snapshot=False):
        super().__init__()
        self.record = record
        self.snapshot = snapshot
        self.inputs = {id(t) for t in inputs}
        self.born = weakref.WeakValueDictionary()
        self.state = {}
        self.grads = {}
        self.generators = {}
        self.saved = []  # (tensor, copy) / (param, grad, copy) / (gen, state)
        self._born_mode = _Born(self) if record else None

    def __enter__(self):
        super().__enter__()
        if self._born_mode is not None:
            self._born_mode.__enter__()
        return self

    def __exit__(self, *exc):
        if self._born_mode is not None:
            self._born_mode.__exit__(*exc)
        return super().__exit__(*exc)

    def mark_born(self, out):
        for t in _tensors(out):
            if id(t) not in self.state and id(t) not in self.inputs:
                self.born[id(t)] = t

    def _see(self, t):
        key = id(t)
        if key in self.inputs or key in self.state or self.born.get(key) is t:
            return
        self.state[key] = t
        if self.snapshot:
            self.saved.append((t, t.detach().clone()))
        if t.is_leaf and t.requires_grad:
            g = t.grad
            self.grads[key] = (t, None if g is None else g.data_ptr())
            if self.snapshot and g is not None:
                self.saved.append((t, g, g.detach().clone()))

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        _refuse(func)
        if not self.record:
            return func(*args, **kwargs)
        for t in _tensors((args, kwargs)):
            self._see(t)
        gen = kwargs.get("generator")
        if isinstance(gen, torch.Generator) and id(gen) not in self.generators:
            self.generators[id(gen)] = gen
            if self.snapshot:
                self.saved.append((gen, gen.get_state()))
        out = func(*args, **kwargs)
        self.mark_born(out)  # made by the step (a gradient it reads too)
        return out


# -- arguments, signatures, outputs ---------------------------------------------


def _flatten(obj, sink):
    """obj with each tensor replaced by its index in `sink`."""
    if isinstance(obj, torch.Tensor):
        sink.append(obj)
        return ("__tensor__", len(sink) - 1)
    if isinstance(obj, (list, tuple)):
        items = [_flatten(o, sink) for o in obj]
        return tuple(items) if isinstance(obj, tuple) else items
    if isinstance(obj, dict):
        return {k: _flatten(v, sink) for k, v in obj.items()}
    return obj


def _rebuild(obj, tensors):
    if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == "__tensor__":
        return tensors[obj[1]]
    if isinstance(obj, list):
        return [_rebuild(o, tensors) for o in obj]
    if isinstance(obj, tuple):
        return tuple(_rebuild(o, tensors) for o in obj)
    if isinstance(obj, dict):
        return {k: _rebuild(v, tensors) for k, v in obj.items()}
    return obj


def _signature(obj):
    """The cache key of the arguments: each tensor's shape, dtype and
    device, every other value itself (a numpy array by its bytes: the step
    would bake it in)."""
    if isinstance(obj, torch.Tensor):
        return ("T", tuple(obj.shape), str(obj.dtype), str(obj.device))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__,) + tuple(_signature(o) for o in obj)
    if isinstance(obj, dict):
        return ("dict",) + tuple(sorted(((k, _signature(v)) for k, v in obj.items()),
                                        key=repr))
    if isinstance(obj, np.ndarray):
        return ("A", obj.shape, str(obj.dtype), obj.tobytes())
    return ("S", repr(obj))


def _counters():
    return (_fa.launch_counts, _optim.launch_counts, _fa.fallback_counts)


class _Entry:
    """One signature's executable: static inputs, the output template, and
    on the card the graph, its static outputs and the launch-count delta of
    one replay; the state and gradient bindings its stale check holds."""

    __slots__ = ("inputs", "template", "template_out", "graph", "outputs", "delta",
                 "state", "grads", "scalers", "nan_check", "nan")

    def __init__(self, inputs, template, nan_check=False):
        self.inputs = inputs
        self.template = template
        self.template_out = None
        self.graph = None
        self.outputs = ()
        self.delta = [{} for _ in _counters()]
        self.state = []
        self.grads = []
        self.scalers = []
        self.nan_check = nan_check  # FLAGS_check_nan_inf at the trace
        self.nan = ([], None)  # a capture's op names and their flags' buffer

    def stale(self):
        """Whether a tensor the step reads or writes was rebound since the
        trace, or a gradient binding differs from the one it started from."""
        for t, ptr in self.state:
            if t.data_ptr() != ptr:
                return True
        for p, pre, _ in self.grads:
            g = p.grad
            if (g is None) != (pre is None) or g is not None and g.data_ptr() != pre:
                return True
        return False


class StaticFunction:
    """Callable wrapper produced by `to_static` (reference:
    paddle.jit.dy2static StaticFunction with its program cache).
    `trace_count` counts traces; `pool_bytes` the device memory the graphs'
    pool grew by while capturing."""

    def __init__(self, fn):
        self._fn = fn
        self._cache = {}
        self._pool = None
        self.trace_count = 0
        self.pool_bytes = 0
        functools.update_wrapper(self, fn)

    # -- call ---------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _core.active_static_call() is not None:
            return self._fn(*args, **kwargs)  # nested to_static: inline (:480)
        with _nan.paused():
            entry, flat, traced = self._prepare(args, kwargs, snapshot=False)
            if traced is not _NOT_TRACED:
                result, flags = traced  # the trace's warm run was this call
            else:
                result, flags = self._replay(entry, flat)
        _nan.raise_if_bad(*flags)
        return result

    def warmup(self, *args, **kwargs):
        """Trace this signature without moving any state (reference :439):
        every parameter, master, moment, buffer, scaler counter, gradient
        and generator the warm run changed is put back, and the
        accumulators it created go back to their initial fill.  A
        signature already traced is left as it is."""
        if _core.active_static_call() is not None:
            raise RuntimeError("jit warmup inside a to_static step")
        with _nan.paused():
            self._prepare(args, kwargs, snapshot=True)
        return self

    def _prepare(self, args, kwargs, snapshot):
        """Refreshers, then the entry of this signature: a valid cached one,
        or a fresh trace.  Returns (entry, flat tensor arguments, the
        trace's result or _NOT_TRACED)."""
        _run_refreshers()
        flat = []
        template = _flatten((args, kwargs), flat)
        key = (_signature((args, tuple(sorted(kwargs.items(), key=lambda kv: kv[0])))),
               bool(_core.flag("FLAGS_check_nan_inf")))
        entry = self._cache.get(key)
        if entry is not None and not entry.stale():
            return entry, flat, _NOT_TRACED
        self._cache.pop(key, None)  # its graph and buffers go before the retrace
        entry, result = self._trace(key, flat, template, snapshot)
        return entry, flat, result

    def _card(self, flat, state):
        devices = {t.device for t in flat if t.device.type == "cuda"}
        devices |= {t.device for t in state if t.device.type == "cuda"}
        if len(devices) > 1:
            raise ValueError(f"{self.__name__}: tensors on several CUDA devices "
                             f"{sorted(map(str, devices))}")
        return devices.pop() if devices else None

    def _trace(self, key, flat, template, snapshot):
        from ..inference import graphs as _graphs

        inputs = [t.detach().clone() for t in flat]
        entry = _Entry(inputs, template, nan_check=key[1])

        def body():
            a, k = _rebuild(template, inputs)
            return self._fn(*a, **k)

        device = self._card(flat, ())
        side = device or (torch.device("cuda", torch.cuda.current_device())
                          if torch.cuda.is_available() else None)
        view = _View(inputs, snapshot=snapshot)
        call = _Call()
        rng = ((torch.get_rng_state(), torch.cuda.get_rng_state(side) if side else None)
               if snapshot else None)
        before = [dict(c) for c in _counters()]
        old = _core.set_active_static_call(call)
        try:
            with self._checking(entry) as sink, view:
                out = _graphs.warm_run(body, side) if side is not None else body()
        finally:
            _core.set_active_static_call(old)
        flags = _nan.stack_flags(sink)
        result = self._copy_out(out)
        del out  # the warm run's autograd graph goes before the capture
        device = device or self._card((), view.state.values())
        if device is None:
            # the CPU: that run was the call; its state is what it touched
            entry.delta = [_graphs.count_delta(c, b) for c, b in zip(_counters(), before)]
            entry.state = [(t, t.data_ptr()) for t in view.state.values()]
            entry.grads = [(p, pre, None) for p, pre in view.grads.values()]
            entry.scalers = list(call.scalers.values())
        else:
            self._capture(entry, body, view, call, device)
        self._cache[key] = entry
        self.trace_count += 1
        _graphs.note_trace()
        if snapshot:
            self._put_back(view, call, rng, side)
        else:
            self._close_cycles(entry)
        if device is not None:
            torch.cuda.synchronize(device)
        return entry, (result, flags)

    @staticmethod
    def _checking(entry):
        """The run's NaN/Inf record when the entry checks, else None."""
        if entry.nan_check:
            return _nan.recording()
        return contextlib.nullcontext()

    def _capture(self, entry, body, view, call, device):
        """The capture of a traced step on the card, after its warm run."""
        from ..inference import graphs as _graphs

        # the gradients back to their binding at the call, so that the
        # capture allocates (or accumulates into) them as the call did
        warm = {}
        for key, (p, pre) in view.grads.items():
            warm[key] = p.grad
            if pre is None:
                p.grad = None
        for scaler in call.scalers.values():
            scaler._reset_cycle()  # the warm run's open cycle, if any
        gens = [g for g in view.generators.values() if g.device.type == "cuda"]
        if self._pool is None:
            self._pool = _graphs.new_pool(device)
        seen = _View(entry.inputs)
        cap = _Call()

        def checked():
            with self._checking(entry) as sink:
                out = body()
            return out, _nan.stack_flags(sink)

        old = _core.set_active_static_call(cap)
        try:
            with seen:
                graph, (outs, entry.nan), delta, grew = _graphs.capture(
                    checked, device, self._pool, gens, _counters())
        finally:
            _core.set_active_static_call(old)
        flat_out = []
        entry.template_out = _flatten(outs, flat_out)
        # detached: a loss's autograd graph would keep the capture's
        # AccumulateGrad nodes, on the capture's stream, for later eager steps
        entry.outputs = [t.detach() for t in flat_out]
        entry.graph, entry.delta = graph, delta
        entry.state = [(t, t.data_ptr()) for t in seen.state.values()]
        entry.scalers = list(cap.scalers.values())
        self.pool_bytes += grew
        for key, (p, pre) in seen.grads.items():
            post = p.grad
            w = warm.get(key)
            if w is not None and post is not None and post is not w:
                post.copy_(w)  # the warm run's gradients, in the graph's
            elif key not in view.grads and pre is None:
                # only the capture reached it (a cond's other branch): the
                # call leaves it unbound, as its warm run did
                p.grad = None
            entry.grads.append((p, pre, post))

    def _replay(self, entry, flat):
        from ..inference import graphs as _graphs

        for buf, arg in zip(entry.inputs, flat):
            buf.copy_(arg)
        counters = _counters()
        if entry.graph is not None:
            entry.graph.replay()
            for c, d in zip(counters, entry.delta):
                _graphs.add_delta(c, d)
            for p, _, post in entry.grads:
                if p.grad is not post:
                    p.grad = post
            result = self._copy_out(_rebuild(entry.template_out, entry.outputs))
            flags = entry.nan
        else:
            snap = [dict(c) for c in counters]
            dispatches = dict(_fa.pallas_calls)
            old = _core.set_active_static_call(_Call())
            try:
                with self._checking(entry) as sink, _View((), record=False):
                    a, k = _rebuild(entry.template, entry.inputs)
                    out = self._fn(*a, **k)
                flags = _nan.stack_flags(sink)
            finally:
                _core.set_active_static_call(old)
                for c, s, d in zip(counters, snap, entry.delta):
                    _graphs.set_counts(c, s)  # the eager body bumps them itself
                    _graphs.add_delta(c, d)
                _fa.pallas_calls.update(dispatches)
            result = self._copy_out(out)
        self._close_cycles(entry)
        return result, flags

    @staticmethod
    def _copy_out(out):
        """The outputs as the caller keeps them: every tensor a detached copy,
        so none aliases a static buffer or the state."""
        flat = []
        template = _flatten(out, flat)
        return _rebuild(template, [t.detach().clone() for t in flat])

    @staticmethod
    def _close_cycles(entry):
        """A loss scaler whose cycle the step left open (`update()` outside
        the step) is closed on the host and raises at that `update()`, as
        the reference's does (amp/__init__.py:337)."""
        for scaler in entry.scalers:
            scaler._close_traced_cycle()

    @staticmethod
    @torch.no_grad()
    def _put_back(view, call, rng, device):
        """`warmup`'s undo: every state tensor, gradient and generator the
        trace's warm run touched back to its copy from before its first
        use, each accumulator it created back to its fill, every gradient
        binding and the default generators back to the call's."""
        for item in view.saved:
            if isinstance(item[0], torch.Generator):
                item[0].set_state(item[1])
            elif len(item) == 3:
                p, g, copy = item
                p.grad = g
                g.copy_(copy)
            else:
                item[0].copy_(item[1])
        for t, fill in call.created:
            t.fill_(fill)
        for p, pre in view.grads.values():
            if pre is None:
                p.grad = None
        for scaler in call.scalers.values():
            scaler._reset_cycle()
        cpu, cuda = rng
        torch.set_rng_state(cpu)
        if cuda is not None:
            torch.cuda.set_rng_state(cuda, device)

    # -- the rest of the reference's surface ----------------------------------
    def clear_cache(self, persistent=False):
        """Drop every traced executable (the next call traces again);
        returns 0, the number of persistent entries removed."""
        if persistent:
            raise NotImplementedError(f"clear_cache(persistent=True) {_SNAPSHOTS}")
        self._cache.clear()
        return 0

    def lowered_text(self, *args, **kwargs):
        raise NotImplementedError(
            "lowered_text (the optimized HLO of the step) has no counterpart: a "
            "captured step is a CUDA graph of kernel launches, with no compiler "
            "IR to print; `jit.save` exports the program of a Layer instead")

    @property
    def code(self):
        return inspect.getsource(self._fn)


def to_static(function=None, input_spec=None, build_strategy=None, backend=None,
              **kwargs):
    """Decorator: capture a train or eval step once per input signature
    (reference :546).  `input_spec`, `build_strategy` and `backend` are
    accepted and, as in the reference, change nothing: tracing
    specializes on the arguments of each call."""

    def wrap(fn):
        if isinstance(fn, StaticFunction):
            return fn
        return StaticFunction(fn)

    if function is not None:
        return wrap(function)
    return wrap


def warmup(fns_or_dir):
    """`warmup([(fn, args), (fn, args, kwargs), ...])`: trace each
    StaticFunction for those arguments without moving any state (reference
    :559); returns the number of functions warmed.  A directory (the AOT
    snapshot tier's prefetch) raises NotImplementedError."""
    if isinstance(fns_or_dir, (str, os.PathLike)):
        raise NotImplementedError(f"jit.warmup(<cache dir>) {_SNAPSHOTS}")
    n = 0
    for item in fns_or_dir:
        fn, rest = item[0], item[1:]
        if not isinstance(fn, StaticFunction):
            raise TypeError(
                f"jit.warmup expects StaticFunction entries, got {type(fn).__name__}")
        fn.warmup(*(rest[0] if rest else ()), **(rest[1] if len(rest) > 1 else {}))
        n += 1
    return n


def not_to_static(fn):
    fn._not_to_static = True
    return fn


class InputSpec:
    """Shape/dtype spec (reference: paddle.static.InputSpec): the example
    inputs of `jit.save`'s export; `to_static` ignores it and specializes
    on the arguments of each call."""

    def __init__(self, shape, dtype="float32", name=None, stop_gradient=False):
        self.shape = shape
        self.dtype = dtype
        self.name = name
        self.stop_gradient = stop_gradient


def _owner(layer):
    """The Layer whose weights `save` writes: the layer itself, or the
    module a StaticFunction's function is bound to (None if neither)."""
    if isinstance(layer, torch.nn.Module):
        return layer
    if isinstance(layer, StaticFunction):
        target = getattr(layer._fn, "__self__", None)
        if isinstance(target, torch.nn.Module):
            return target
    return None


def save(layer, path, input_spec=None, **configs):
    """paddle.jit.save (reference :602).  With `input_spec` ([InputSpec]),
    the program of a Layer's forward -- or of a bound StaticFunction's own
    function, with the owning Layer's weights -- is exported at those
    shapes and dtypes through `inference.export` (<path>.pt2 with
    <path>.pdiparams), loadable by `jit.load` and `inference.Predictor`.
    A dynamic dim (None or -1) is pinned to 1, with a warning: the program
    is shape-specialized.  The example inputs are zeros on the weights'
    device.  Without a spec only the weights are saved, to <path>.pdparams,
    with a warning.  Anything else raises TypeError."""
    from ..framework import io as _io

    target = _owner(layer)
    if input_spec:
        from ..inference import export

        if any(d is None or d == -1 for spec in input_spec for d in spec.shape):
            logging.getLogger("paddle_tpu_torch").warning(
                "jit.save: dynamic dims (None/-1) in input_spec are pinned to 1 — "
                "the exported program is shape-specialized; export one spec per "
                "shape bucket you serve")
        if target is None:
            raise TypeError("jit.save expects a Layer (or a bound StaticFunction)")
        param = next(iter(target.parameters()), None)
        device = param.device if param is not None else _core.resolve_device(None)
        example = [torch.zeros([1 if d is None or d == -1 else int(d) for d in spec.shape],
                               dtype=_core.to_torch_dtype(spec.dtype), device=device)
                   for spec in input_spec]
        if isinstance(layer, StaticFunction):
            export(layer._fn, path, example, params_from=target)
        else:
            export(layer, path, example)
        return
    if target is None:
        raise TypeError("jit.save expects a Layer")
    logging.getLogger("paddle_tpu_torch").warning(
        "jit.save: no input_spec given — saving weights only; pass "
        "input_spec=[InputSpec(shape, dtype)] to also export the program, or "
        "use paddle_tpu_torch.inference.export")
    _io.save(target.state_dict(), path + ".pdparams")


def load(path, **configs):
    """paddle.jit.load (reference :664): an exported program (<path>.pt2)
    loads as an `inference.Predictor` (on `device=`, the card unless
    given); a weights-only save loads as its state dict."""
    if os.path.exists(path + ".pt2"):
        from ..inference import Predictor

        return Predictor(path, device=configs.get("device"))
    from ..framework import io as _io

    return _io.load(path + ".pdparams")


def enable_to_static(flag=True):
    pass


def ignore_module(modules):
    pass


__all__ = ["StaticFunction", "to_static", "warmup", "not_to_static", "InputSpec",
           "save", "load", "enable_to_static", "ignore_module",
           "register_state_refresh"]
