"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package serves a
Llama (paged or dense slot-pool engine, or lock-step `generate` behind a
`GenerationPredictor`) and GPT (lock-step `generate`, with the GShard
mixture of experts of `incubate.moe` on every other layer when asked),
trains them and fine-tunes BERT (AMP O1 and O2,
`GradScaler`, the reference's optimizers and LR schedulers) with
hand-written Hopper kernels (`csrc/`), and runs the reference's training
loop: `io` (datasets, samplers, `BucketSampler`, the `DataLoader` with
workers, device prefetch and exactly-once resume), `metric`, `Model.fit`
/ `evaluate` / `predict` with `callbacks` under the training
`fault.Supervisor`, `save` / `load` in the reference's file format, and
hardened checkpoints (`distributed.checkpoint`), and trains the vision
models (`vision`: LeNet, ResNet, VGG on the conv, pool and batch-norm
layers of `nn`, with their transforms and datasets).  `jit.to_static`
captures a whole training step (forward, backward, optimizer) once per
input signature as a CUDA graph, with `static.nn.cond` and `while_loop`
as conditional nodes of the graph; `jit.save` and `inference.export` export
a Layer's program with K1 as a registered op, which `jit.load` and
`inference.Predictor` run (and `inference.serve` serves at /predict).
Entry points run on the CUDA card unless the caller passes device="cpu".
"""

import sys as _sys

from . import amp, fault, incubate, io, jit, metric, nn, optimizer, regularizer, static, vision
from . import hapi
from . import hapi as callbacks
from .framework.io import load, save
from .hapi import Model
from .jit import to_static

# `from paddle_tpu_torch.callbacks import X` works, as in the reference
_sys.modules[__name__ + ".callbacks"] = callbacks

__version__ = "0.1.0"

__all__ = ["Model", "amp", "callbacks", "fault", "hapi", "incubate", "io", "jit", "load",
           "metric", "nn", "optimizer", "regularizer", "save", "static", "to_static",
           "vision"]
