"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package serves a
Llama (paged or dense slot-pool engine, or lock-step `generate` behind a
`GenerationPredictor`), trains it and fine-tunes BERT (AMP O1 and O2, `GradScaler`, the
reference's optimizers and LR schedulers) with hand-written Hopper kernels
(`csrc/`).  Entry points run on the CUDA card unless the caller
passes device="cpu".
"""

from . import amp, nn, optimizer, regularizer

__version__ = "0.1.0"

__all__ = ["amp", "nn", "optimizer", "regularizer"]
