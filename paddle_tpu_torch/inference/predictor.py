"""The inference export of the port (counterpart of `export`, `Config`,
`Predictor` and `create_predictor` in `paddle_tpu/inference/__init__.py`:25-123).

`export` traces a Layer's forward with `torch.export` into a program of
ATen operators and the port's registered ops: K1's forward stays one
`paddle_tpu_torch::flash_fwd` node per attention (`ops.flash_attention.
flash_fwd_op`), so the program runs the kernel wherever it is loaded on the
card, where plain tensor code would have been traced into its plain
version.  The artifact is the reference's layout: <path>.pt2 (the
program) and <path>.pdiparams (the weights, the reference's file format).

`Predictor` loads the program on the card (on the CPU when its `Config`
says `disable_gpu()` or the caller passes device="cpu"), moving its
weights, constants and every device the traced code named (an `arange`
in a mask, RoPE's tables) to that device: a program exported on the CPU
runs on the card and the other way round.  As the reference jits the
exported call, it runs the program as one `inference.graphs.StepGraph`
executable per input signature: on the card a CUDA graph captured at the
first call with that signature after a warm run (each trace counted in
`graphs.trace_total`), on the CPU the program itself.
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch.export.passes import move_to_device_pass
from torch.utils import _pytree as pytree

from ..framework import core as _core
from ..framework import io as _io
from . import graphs as _graphs

PROGRAM_SUFFIX = ".pt2"
PARAMS_SUFFIX = ".pdiparams"


class _Callable(torch.nn.Module):
    """A bare callable as a module to export; `owner` (a Layer whose
    weights the callable reads, such as the one a method is bound to)
    becomes a submodule, so its weights are the program's parameters."""

    def __init__(self, fn, owner=None):
        super().__init__()
        self.fn = fn
        self.owner = owner

    def forward(self, *xs):
        return self.fn(*xs)


def _device_of(module):
    for t in module.parameters():
        return t.device
    for t in module.buffers():
        return t.device
    return None


def export(layer, path, example_inputs, with_weights=True, params_from=None):
    """Export `layer.forward` (or a plain callable, its weights from the
    Layer `params_from`) traced at `example_inputs` (tensors or arrays:
    their shapes and dtypes fix the program's) with `torch.export`, in eval
    mode and under no_grad.  Writes <path>.pt2 and, with `with_weights`,
    the weights' state dict to <path>.pdiparams in the reference's format.

    The .pt2 carries the weights too: a `torch.export` program holds its
    parameters and buffers as inputs of its graph, bound to the tensors it
    was traced with, and `torch.export.save` writes them beside the graph,
    so `Predictor` needs the .pt2 alone.  The .pdiparams is the
    reference's artifact, for code that reads the weights without the
    program.  A layer in training mode is put back in it afterwards.
    Returns `path`."""
    owner = params_from if params_from is not None else layer
    module = layer if isinstance(layer, torch.nn.Module) else _Callable(
        layer, params_from if isinstance(params_from, torch.nn.Module) else None)
    was_training = getattr(owner, "training", False)
    device = _device_of(module)
    inputs = tuple(
        x if isinstance(x, torch.Tensor)
        else torch.as_tensor(np.asarray(x), device=device)
        for x in example_inputs)
    module.eval()
    try:
        with torch.no_grad():
            program = torch.export.export(module, inputs, strict=False)
    finally:
        if was_training:
            owner.train()  # the export must not leave the live model in eval
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path + PROGRAM_SUFFIX)
    if with_weights and isinstance(owner, torch.nn.Module):
        _io.save(owner.state_dict(), path + PARAMS_SUFFIX)
    return path


class Config:
    """The predictor's configuration (reference: paddle_infer::Config):
    the model's path prefix and where it runs, the card unless
    `disable_gpu()`.  `set_cpu_math_library_num_threads` and
    `switch_ir_optim` are kept and change nothing, as in the reference."""

    def __init__(self, model_path=None, params_path=None):
        self.model_path = model_path
        self.params_path = params_path
        self._gpu = True
        self._device_id = None
        self._threads = None
        self._ir_optim = True

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        self._gpu = True
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._gpu = False

    def use_gpu(self):
        return self._gpu

    def set_cpu_math_library_num_threads(self, n):
        self._threads = int(n)

    def switch_ir_optim(self, flag=True):
        self._ir_optim = bool(flag)

    def device(self):
        if not self._gpu:
            return torch.device("cpu")
        return None if self._device_id is None else torch.device("cuda", self._device_id)


def _numpy(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:  # numpy has no bfloat16: widened exactly
        t = t.float()
    return t.to("cpu", copy=True).numpy()  # never the static output's memory


class Predictor:
    """Runs an exported program (reference: AnalysisPredictor::Run).
    `path_or_config`: the path prefix `export` wrote, or a `Config`;
    `device`: where it runs (the Config's, else the card).  `program` is
    the loaded `torch.export` program."""

    def __init__(self, path_or_config, device=None):
        config = (path_or_config if isinstance(path_or_config, Config)
                  else Config(path_or_config))
        self.device = _core.resolve_device(device if device is not None
                                           else config.device())
        program = torch.export.load(config.model_path + PROGRAM_SUFFIX)
        self.program = move_to_device_pass(program, self.device)
        self._module = self.program.module()
        names = set(self.program.graph_signature.user_inputs)
        self._inputs = [n.meta["val"] for n in self.program.graph.nodes
                        if n.op == "placeholder" and n.name in names]
        self._n_out = len(self.program.graph_signature.user_outputs)
        self._graph = _graphs.StepGraph("predictor", self._body, self.device,
                                        _graphs.new_pool(self.device))
        self._key = None

    def _body(self, **inputs):
        out = self._module(*(inputs[f"x{i}"] for i in range(len(inputs))))
        return tuple(pytree.tree_leaves(out))

    @property
    def input_dtypes(self):
        """The torch dtype of each input the program was traced with."""
        return [v.dtype for v in self._inputs]

    @property
    def trace_count(self):
        return self._graph.trace_count

    def _tensors(self, inputs, cast):
        out = []
        for i, x in enumerate(inputs):
            t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
            if cast and i < len(self._inputs):
                t = t.to(self._inputs[i].dtype)
            else:
                t = t.to(_core.to_torch_dtype(t.dtype))  # the x64 demotion
            out.append(t)
        return out

    def run(self, inputs, cast=False):
        """The program's outputs on `inputs` (arrays or tensors, in the
        traced order; with `cast`, each cast to its traced dtype, else only
        64-bit types demoted to 32) as numpy arrays (bfloat16 widened to
        float32).  The program is shape-specialized: an input of another
        shape or dtype raises ValueError.  The first call traces."""
        if len(inputs) != len(self._inputs):
            raise ValueError(f"the program takes {len(self._inputs)} inputs, got "
                             f"{len(inputs)}")
        tensors = self._tensors(inputs, cast)
        for i, (t, spec) in enumerate(zip(tensors, self._inputs)):
            if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
                raise ValueError(
                    f"input x{i} is {tuple(t.shape)} {t.dtype}; the program was "
                    f"traced at {tuple(spec.shape)} {spec.dtype}")
        self._key = tuple((tuple(t.shape), t.dtype) for t in tensors)
        outs = self._graph(self._key, **{f"x{i}": t for i, t in enumerate(tensors)})
        return [_numpy(o) for o in outs]

    def compare_eager(self):
        """(replayed outputs, eager outputs) of the last signature on its
        last inputs, as `StepGraph.compare_eager` gives them."""
        return self._graph.compare_eager(self._key)

    def get_input_names(self):
        return [f"x{i}" for i in range(len(self._inputs))]

    def get_output_names(self):
        return [f"y{i}" for i in range(self._n_out)]


def create_predictor(config):
    return Predictor(config)
