"""`paddle.static` of the port (counterpart of `paddle_tpu/static/__init__.py`).

The reference's static graph (ProgramDesc and Executor) has no program of
its own here either: a step captured by `jit.to_static` is the graph.  This
shim keeps the Program / Executor surface working for code that builds a
forward function imperatively and runs it through an Executor, exports
inference models through `inference.export`, and holds the static control
flow the traced steps need: `nn.cond` and `nn.while_loop`.

Control flow (reference: `static.nn.cond` :289, `while_loop` :343, which
lower to XLA's `conditional` and `while`):

- outside a `jit.to_static` step and outside a capture, each reads its
  predicate on the host and runs only the branch taken, or the loop's
  live passes, as plain PyTorch;
- inside a step that runs eagerly (the CPU, and on the card the trace's
  warm run) the same, through the step's autograd form below;
- inside a CUDA graph capture on the card (a `to_static` step's, or any
  `inference.graphs.capture`), each branch and each loop body is captured
  into the body of a conditional node of the graph
  (`inference.graphs.conditional_body`, csrc/graph_cond.cu): the graph
  reads the predicate on the device at every replay and executes only the
  branch taken, or the passes the loop makes, so one capture serves every
  predicate value and trip count.

Inside a step, `cond` is an autograd Function whose operands are the
tensors its branches read and did not make (found while they run, and
replaced there by detached aliases, so each branch builds a graph of its
own: the reference's lifting of captured tensors).  Its backward
differentiates the branch taken alone -- under the same IF nodes on the
card -- so the untaken branch's gradient, NaN or not, never reaches a
weight, and a branch that returns a captured tensor unchanged passes its
gradient through.  `while_loop(max_iters=n)` is n such conds, each a pass
of the body or the loop vars unchanged, so it is differentiable through
the loop vars and the tensors the body reads, and executes only the live
passes; without `max_iters` it is a WHILE node and forward only, as the
reference's `lax.while_loop` is.  A branch may update device state in
place (a counter): only the branch taken does.

A branch that applies an autograd Function to a tensor it did not make
(rather than to one it computed) gets that tensor's gradient outside the
cond; the port's ops (`sdpa` and the rest) compute on what the branch
made.
"""

from __future__ import annotations

import contextlib
import math
import weakref

import numpy as np
import torch
from torch.overrides import TorchFunctionMode
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from ..framework import core as _core
from ..jit import InputSpec  # noqa: F401

__all__ = ["InputSpec", "Program", "default_main_program", "default_startup_program",
           "program_guard", "data", "Executor", "cuda_places", "cpu_places",
           "device_guard", "save_inference_model", "load_inference_model",
           "set_program_state", "amp", "gradients", "nn"]


class Program:
    """Holds a Python callable (`_build_fn`) in the place of a ProgramDesc."""

    def __init__(self):
        self._build_fn = None
        self.random_seed = 0

    def global_block(self):
        return self

    def clone(self, for_test=False):
        return self


_default_main = Program()
_default_startup = Program()


def default_main_program():
    return _default_main


def default_startup_program():
    return _default_startup


class program_guard:
    def __init__(self, main_program, startup_program=None):
        self.main = main_program

    def __enter__(self):
        return self.main

    def __exit__(self, *exc):
        return False


def data(name, shape, dtype="float32", lod_level=0, device=None):
    """A zero tensor of the spec, dynamic dims (None, -1) pinned to 1, on
    `device` (the card unless given).  `name` is accepted: a torch tensor
    has no name to set, and the Executor feeds by keyword instead."""
    shape = [1 if (s is None or s < 0) else int(s) for s in shape]
    return torch.zeros(shape, dtype=_core.to_torch_dtype(dtype),
                       device=_core.resolve_device(device))


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class Executor:
    """Runs a Program's callable on a feed (reference: the StandaloneExecutor
    over a ProgramDesc).  `place`: the device a loaded inference model runs
    on (`load_inference_model`), the card when None."""

    def __init__(self, place=None):
        self.place = place

    def run(self, program=None, feed=None, fetch_list=None, **kwargs):
        """`program._build_fn(**feed)`'s outputs, or the tensors of
        `fetch_list`, as numpy arrays."""
        feed = feed or {}
        if callable(getattr(program, "_build_fn", None)):
            out = program._build_fn(**{k: torch.as_tensor(v) for k, v in feed.items()})
            outs = out if isinstance(out, (list, tuple)) else [out]
            return [_numpy(o) for o in outs]
        return [_numpy(f) for f in fetch_list or ()]

    def close(self):
        pass


def cuda_places(device_ids=None):
    return [torch.device("cuda", i) for i in (device_ids or [0])]


def cpu_places(device_count=1):
    return [torch.device("cpu") for _ in range(device_count)]


def device_guard(device=None):
    return contextlib.nullcontext()


def save_inference_model(path_prefix, feed_vars, fetch_vars, executor, program=None,
                         layer=None):
    """Export an inference model (reference: static/__init__.py:113): the
    Layer given as `program=` or `layer=`, traced at `feed_vars`' shapes and
    dtypes, through `inference.export` (<path_prefix>.pt2 and
    .pdiparams).  `fetch_vars` is accepted; the outputs are the layer's."""
    target = layer if layer is not None else program
    if not isinstance(target, torch.nn.Module):
        raise TypeError(
            "save_inference_model needs the model Layer (pass program=<Layer>); "
            "a static ProgramDesc does not exist in this framework — the "
            "exported program of the layer is the program")
    feed = feed_vars if isinstance(feed_vars, (list, tuple)) else [feed_vars]
    if not feed or any(f is None for f in feed):
        raise TypeError(
            "save_inference_model needs non-empty feed_vars (example input "
            "tensors defining the traced shapes/dtypes)")
    from ..inference import export

    return export(target, path_prefix, feed)


def load_inference_model(path_prefix, executor):
    """(predictor, feed names, fetch names) of an exported model; the
    predictor runs on the executor's place (the card when None)."""
    from ..inference import Predictor

    p = Predictor(path_prefix, device=getattr(executor, "place", None))
    return p, p.get_input_names(), p.get_output_names()


def set_program_state(program, state):
    pass


class amp:
    @staticmethod
    def decorate(*args, **kwargs):
        from .. import amp as _amp

        return _amp.decorate(*args, **kwargs)

    @staticmethod
    def auto_cast(*args, **kwargs):
        from .. import amp as _amp

        return _amp.auto_cast(*args, **kwargs)


def gradients(targets, inputs, target_gradients=None):
    """Gradients of `targets` with respect to `inputs` (torch.autograd.grad,
    the graph retained, unused inputs None)."""
    targets = targets if isinstance(targets, (list, tuple)) else [targets]
    inputs = inputs if isinstance(inputs, (list, tuple)) else [inputs]
    if target_gradients is not None and not isinstance(target_gradients, (list, tuple)):
        target_gradients = [target_gradients]
    return list(torch.autograd.grad(targets, inputs, grad_outputs=target_gradients,
                                    retain_graph=True, allow_unused=True))


# -- static control flow ----------------------------------------------------------


def _host_bool(pred):
    """The predicate's value on the host, past the trace's refusal of a
    tensor used as a bool (a sync on the card)."""
    if not isinstance(pred, torch.Tensor):
        return bool(pred)
    with torch._C.DisableTorchFunction():
        return bool(pred.reshape(()))


def _capturing(pred):
    return (isinstance(pred, torch.Tensor) and pred.is_cuda
            and torch.cuda.is_current_stream_capturing())


class _Made(TorchDispatchMode):
    """Marks every tensor an operator makes while a branch runs."""

    def __init__(self, lift):
        super().__init__()
        self.lift = lift

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.lift.made(out)
        return out


class _Lift(TorchFunctionMode):
    """Runs a branch on detached aliases of the tensors it reads and did
    not make: `lifted` maps each such tensor's id to (the tensor, its
    alias), the alias requiring grad where the tensor does, shared by both
    branches of a cond."""

    def __init__(self, lifted):
        super().__init__()
        self.lifted = lifted
        self.born = weakref.WeakValueDictionary()
        self._made = _Made(self)

    def __enter__(self):
        super().__enter__()
        self._made.__enter__()
        return self

    def __exit__(self, *exc):
        self._made.__exit__(*exc)
        return super().__exit__(*exc)

    def made(self, out):
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.born[id(t)] = t

    def alias(self, t):
        if not isinstance(t, torch.Tensor) or self.born.get(id(t)) is t:
            return t
        hit = self.lifted.get(id(t))
        if hit is not None and hit[0] is t:
            return hit[1]
        a = t.detach()
        if t.requires_grad:
            a.requires_grad_()
        self.lifted[id(t)] = (t, a)
        self.born[id(a)] = a
        return a

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map_only(torch.Tensor, self.alias, (args, kwargs or {}))
        out = func(*args, **kwargs)
        self.made(out)
        return out


def _leaves(out):
    leaves, spec = pytree.tree_flatten(out)
    for x in leaves:
        if x is not None and not isinstance(x, torch.Tensor):
            raise TypeError("paddle.static.nn.cond: a branch returns tensors, got "
                            f"{type(x).__name__}")
    return leaves, spec


def _run_branch(fn, lifted):
    """fn() with grad recorded, on aliases (`_Lift`); returns its output's
    tensors (a tensor it returns unchanged as its alias) and their tree."""
    lift = _Lift(lifted)
    with torch.enable_grad():
        with lift:
            out = fn() if fn is not None else None
        leaves, spec = _leaves(out)
        # outside the mode: the alias's detach is seen by the modes below
        return [lift.alias(x) for x in leaves], spec


class _Branches:
    """One cond inside a step: the predicate, the lifted (tensor, alias)
    pairs, and the output tensors of each branch that ran ({taken: ...} on
    the host, both under a capture)."""

    def __init__(self, pred, lifted, outs, taken=None):
        self.pred = pred
        self.lifted = list(lifted.values())
        self.outs = outs
        self.taken = taken  # True / False on the host; None: both, on the card

    def backward(self, grads):
        """Gradients of the lifted tensors from the branch taken alone."""
        want = [i for i, (_, a) in enumerate(self.lifted) if a.requires_grad]
        result = [None] * len(self.lifted)
        if not want:
            return result
        aliases = [self.lifted[i][1] for i in want]
        if self.taken is not None:
            for i, g in zip(want, self._grad(self.outs[self.taken], grads, aliases)):
                result[i] = g
            return result
        from ..inference.graphs import conditional_body

        acc = [torch.zeros_like(a) for a in aliases]
        for branch in (True, False):
            with conditional_body(self.pred, negate=not branch):
                for a, g in zip(acc, self._grad(self.outs[branch], grads, aliases)):
                    if g is not None:
                        a.copy_(g)
        for i, a in zip(want, acc):
            result[i] = a
        return result

    @staticmethod
    def _grad(leaves, grads, aliases):
        pairs = [(x, g) for x, g in zip(leaves, grads)
                 if x is not None and x.requires_grad]
        if not pairs:
            return [None] * len(aliases)
        return torch.autograd.grad([x for x, _ in pairs], aliases,
                                   [g for _, g in pairs], allow_unused=True)


class _Cond(torch.autograd.Function):
    """The cond's node in the step's autograd graph: its inputs are the
    lifted tensors, its outputs the cond's (computed before, by the branch
    or branches), its backward `_Branches.backward`."""

    @staticmethod
    def forward(ctx, branches, outs, *lifted):
        ctx.branches = branches
        fixed = [o for o in outs if not o.is_floating_point()]
        if fixed:
            ctx.mark_non_differentiable(*fixed)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.branches.backward(grads))


def _outputs(branches, outs, spec):
    lifted = [t for t, _ in branches.lifted]
    res = _Cond.apply(branches, [o.detach() for o in outs], *lifted)
    return pytree.tree_unflatten(list(res), spec)


def _cond_host(pred, true_fn, false_fn):
    taken = _host_bool(pred)
    lifted = {}
    leaves, spec = _run_branch(true_fn if taken else false_fn, lifted)
    if not leaves:
        return pytree.tree_unflatten(leaves, spec)
    return _outputs(_Branches(pred, lifted, {taken: leaves}, taken), leaves, spec)


def _cond_card(pred, true_fn, false_fn):
    from ..inference.graphs import conditional_body

    lifted, outs = {}, {}
    res, spec = None, None
    for branch, fn in ((True, true_fn), (False, false_fn)):
        with conditional_body(pred, negate=not branch):
            leaves, tree = _run_branch(fn, lifted)
            if res is None:
                spec = tree
                res = [torch.empty_like(x, memory_format=torch.contiguous_format)
                       for x in leaves]
            elif tree != spec or any(
                    x.shape != r.shape or x.dtype != r.dtype for x, r in zip(leaves, res)):
                raise ValueError(
                    "paddle.static.nn.cond: true_fn and false_fn must return the "
                    "same structure of tensors with equal shapes and dtypes, got "
                    f"{spec} {[(tuple(r.shape), r.dtype) for r in res]} and {tree} "
                    f"{[(tuple(x.shape), x.dtype) for x in leaves]}")
            with torch.no_grad():
                for r, x in zip(res, leaves):
                    r.copy_(x)
            outs[branch] = leaves
    if not res:
        return pytree.tree_unflatten([], spec)
    return _outputs(_Branches(pred, lifted, outs), res, spec)


def _vars(out, spec, what):
    leaves, tree = pytree.tree_flatten(list(out))
    if tree != spec:
        raise ValueError(f"paddle.static.nn.while_loop: {what} must return "
                         "loop_vars-shaped outputs")
    return leaves


def _loop_flag(r):
    return r[0] if isinstance(r, (list, tuple)) else r


class nn:
    """Static control flow and `fc` (reference: static/__init__.py:271)."""

    @staticmethod
    def cond(pred, true_fn=None, false_fn=None, name=None, return_names=None):
        """true_fn() if the one-element tensor `pred` is true, else
        false_fn() (see the module docstring for how each runs inside a
        captured step).  Both branches return the same structure of
        tensors, with equal shapes and dtypes."""
        if _capturing(pred):
            return _cond_card(pred, true_fn, false_fn)
        if _core.active_static_call() is None:
            fn = true_fn if _host_bool(pred) else false_fn
            return fn() if fn is not None else None
        return _cond_host(pred, true_fn, false_fn)

    @staticmethod
    def while_loop(cond, body, loop_vars, is_test=False, name=None, max_iters=None):
        """loop_vars <- body(*loop_vars) while cond(*loop_vars) holds, at most
        `max_iters` passes when given; returns the list of loop vars.
        Without `max_iters` the outputs carry no gradient (the reference's
        forward-only `lax.while_loop`); with it, gradients flow through the
        loop vars and the tensors the body reads."""
        loop_vars = list(loop_vars)
        leaves, spec = pytree.tree_flatten(loop_vars)
        capturing = _capturing(_first_tensor(leaves))
        if max_iters is not None and (capturing or _core.active_static_call() is not None):
            return _bounded_loop(cond, body, leaves, spec, int(max_iters))
        if max_iters is None and capturing:
            return _while_card(cond, body, leaves, spec)
        # on the host: the predicate read each pass
        limit = math.inf if max_iters is None else int(max_iters)
        n = 0
        with torch.no_grad() if max_iters is None else contextlib.nullcontext():
            while n < limit and _host_bool(_loop_flag(cond(*loop_vars))):
                loop_vars = list(body(*loop_vars))
                _vars(loop_vars, spec, "body")
                n += 1
        if max_iters is not None:
            return loop_vars
        return [pytree.tree_map_only(torch.Tensor, torch.Tensor.detach, v)
                for v in loop_vars]

    @staticmethod
    def fc(x, size, num_flatten_dims=1, weight_attr=None, bias_attr=None,
           activation=None, name=None):
        """static.nn.fc: flatten the dims from `num_flatten_dims` on, apply
        a fresh Linear of `size` outputs (on x's device and dtype), then
        `activation` by name.  Its weights are made per call, as in the
        reference; reuse a Linear for shared weights."""
        from ..nn import functional as F

        if not 1 <= num_flatten_dims < x.ndim:
            raise ValueError(
                f"fc: num_flatten_dims must be in [1, {x.ndim - 1}] for a "
                f"rank-{x.ndim} input, got {num_flatten_dims}")
        lead = list(x.shape[:num_flatten_dims])
        flat = int(np.prod(x.shape[num_flatten_dims:]))
        layer = torch.nn.Linear(flat, size, bias=bias_attr is not False,
                                device=x.device, dtype=x.dtype)
        out = layer(x.reshape(lead + [flat]))
        if activation is not None:
            act = getattr(F, activation, None) or getattr(torch.nn.functional, activation)
            out = act(out)
        return out


def _first_tensor(leaves):
    return next((x for x in leaves if isinstance(x, torch.Tensor)), None)


def _bounded_loop(cond, body, leaves, spec, max_iters):
    """`max_iters` conds, each a pass of the body (and the next flag) while
    the loop lives, else the loop vars unchanged: differentiable, and only
    the live passes execute."""
    vals = list(leaves)
    alive = _loop_flag(cond(*pytree.tree_unflatten(vals, spec)))
    if not isinstance(alive, torch.Tensor):
        alive = torch.tensor(bool(alive), device=_first_tensor(vals).device)
    alive = alive.reshape(()).to(torch.bool)
    for _ in range(max_iters):
        if not _capturing(alive) and not _host_bool(alive):
            break

        def live(vals=vals):
            new = _vars(body(*pytree.tree_unflatten(vals, spec)), spec, "body")
            flag = _loop_flag(cond(*pytree.tree_unflatten(new, spec)))
            return new, torch.as_tensor(flag, device=alive.device).reshape(()).to(torch.bool)

        def done(vals=vals, alive=alive):
            return list(vals), alive

        vals, alive = nn.cond(alive, live, done)
    return pytree.tree_unflatten(vals, spec)


def _while_card(cond, body, leaves, spec):
    """The WHILE node: the loop vars in buffers the body updates in place,
    its flag set by the body's last launch."""
    from ..inference.graphs import conditional_body

    with torch.no_grad():
        carry = [x.detach().clone() for x in leaves]
        first = _loop_flag(cond(*pytree.tree_unflatten(carry, spec)))
        with conditional_body(first, loop=True) as next_pass:
            new = _vars(body(*pytree.tree_unflatten(carry, spec)), spec, "body")
            for c, x in zip(carry, new):
                if x.shape != c.shape or x.dtype != c.dtype:
                    raise ValueError(
                        "paddle.static.nn.while_loop: the body changed a loop var "
                        f"from {tuple(c.shape)} {c.dtype} to {tuple(x.shape)} {x.dtype}")
                c.copy_(x)
            next_pass(_loop_flag(cond(*pytree.tree_unflatten(carry, spec))))
    return list(pytree.tree_unflatten(carry, spec))
