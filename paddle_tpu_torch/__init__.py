"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

The JAX package `paddle_tpu` stays the reference; this package serves a
paged Llama with hand-written Hopper kernels (`csrc/`).  Entry points run on
the CUDA card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
