"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package serves a
Llama (paged or dense slot-pool engine, or lock-step `generate` behind a
`GenerationPredictor`), trains it and fine-tunes BERT (AMP O1 and O2,
`GradScaler`, the reference's optimizers and LR schedulers) with
hand-written Hopper kernels (`csrc/`), and runs the reference's training
loop: `io` (datasets, samplers, `BucketSampler`, the `DataLoader` with
workers, device prefetch and exactly-once resume), `metric`, `Model.fit`
/ `evaluate` / `predict` with `callbacks` under the training
`fault.Supervisor`, `save` / `load` in the reference's file format, and
hardened checkpoints (`distributed.checkpoint`), and trains the vision
models (`vision`: LeNet, ResNet, VGG on the conv, pool and batch-norm
layers of `nn`, with their transforms and datasets).  Entry points run on
the CUDA card unless the caller passes device="cpu".
"""

import sys as _sys

from . import amp, fault, io, metric, nn, optimizer, regularizer, vision
from . import hapi
from . import hapi as callbacks
from .framework.io import load, save
from .hapi import Model

# `from paddle_tpu_torch.callbacks import X` works, as in the reference
_sys.modules[__name__ + ".callbacks"] = callbacks

__version__ = "0.1.0"

__all__ = ["Model", "amp", "callbacks", "fault", "hapi", "io", "load", "metric", "nn",
           "optimizer", "regularizer", "save", "vision"]
