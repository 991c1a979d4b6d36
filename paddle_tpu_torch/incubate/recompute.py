"""Activation recompute for the PyTorch/CUDA port (counterpart of
`paddle_tpu/incubate/recompute.py`, the reference's
`fleet/utils/recompute.py`).

`recompute(function, *args, **kwargs)` runs `function` without keeping the
activations its backward would read, and runs it again inside the backward
to get them (`torch.utils.checkpoint` in its non-reentrant form).  The
reference wraps the segment in `jax.checkpoint`; both give the gradients
of the plain forward.  Gradients reach the parameters `function` reads and
every tensor argument that requires them, and tensors the segment leaves
on a module (an MoE layer's `aux_loss`) stay differentiable.

Dropout masks repeat in the recompute: torch's checkpoint restores the
default generators' state, and the states of the explicit
`torch.Generator`s of the `Dropout` layers under `function`'s module (the
port's models draw their masks from such a generator) are put back to
where the forward found them for the length of the recompute.
"""

from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint


def _dropout_generators(function):
    """The explicit generators of the live dropouts under `function`'s
    module (a bound method's owner), each once."""
    owner = getattr(function, "__self__", None)
    if not isinstance(owner, torch.nn.Module):
        return []
    gens = {}
    for mod in owner.modules():
        gen = getattr(mod, "generator", None)
        if isinstance(gen, torch.Generator) and getattr(mod, "p", 0.0) > 0.0:
            gens[id(gen)] = gen
    return list(gens.values())


def _generator_contexts(gens):
    """(forward context, recompute context) for `checkpoint`'s
    `context_fn`: the first notes each generator's state as the forward
    starts, the second runs the recompute from those states and then puts
    back the ones it found."""
    saved = []

    @contextlib.contextmanager
    def forward():
        saved[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def again():
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, saved):
            g.set_state(st)
        try:
            yield
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return forward(), again()


def recompute(function, *args, use_reentrant=True, **kwargs):
    """`function(*args, **kwargs)` with its activations recomputed in the
    backward (reference: incubate/recompute.py:47).  `use_reentrant` is
    taken and ignored, as in the reference: the port always runs torch's
    non-reentrant checkpoint, which gives the same gradients.  Returns
    `function`'s output."""
    gens = _dropout_generators(function)
    if not gens:
        return checkpoint(function, *args, use_reentrant=False, **kwargs)
    return checkpoint(function, *args, use_reentrant=False,
                      context_fn=lambda: _generator_contexts(gens), **kwargs)
