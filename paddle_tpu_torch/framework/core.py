"""Flags, dtypes and the default device of the PyTorch/CUDA port.

Counterpart of `paddle_tpu/framework/core.py`, cut to what the paged
serving path reads.  The flag names and defaults are the reference's, so a
deployment's `FLAGS_serve_*` environment means the same thing to both
packages.  One default differs on purpose: `FLAGS_serve_prefix_cache` is
off, because the prefix cache is not ported yet (ROADMAP, Queue 1).
"""

from __future__ import annotations

import os

import torch

# ---------------------------------------------------------------------------
# dtypes
# ---------------------------------------------------------------------------

# The reference runs JAX with x64 off, so int64/float64 demote to 32 bits.
# The port keeps that contract: positions, page tables and token ids are
# int32 everywhere.
INDEX_DTYPE = torch.int32

_DTYPES = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "int32": torch.int32,
    # x64 demotion, as in the reference's to_jax_dtype
    "int64": torch.int32,
    "float64": torch.float32,
}
_ALIASES = {"fp32": "float32", "fp16": "float16", "bf16": "bfloat16",
            "float": "float32", "half": "float16", "int": "int32",
            "long": "int64", "double": "float64"}


def to_torch_dtype(dtype):
    """A dtype name (reference spelling or alias) or torch dtype -> torch
    dtype, with int64/float64 demoted to 32 bits."""
    if isinstance(dtype, torch.dtype):
        return {torch.int64: torch.int32, torch.float64: torch.float32}.get(
            dtype, dtype
        )
    name = _ALIASES.get(str(dtype), str(dtype))
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}")
    return _DTYPES[name]


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------


def default_device():
    """The device an entry point runs on when the caller names none: the
    CUDA card.  Raises when CUDA is absent: the port never drops to the CPU
    unless the caller asks for it with device="cpu"."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve_device(device):
    """`device` as a torch.device, `default_device()` for None; a bare
    "cuda" gets the current device's index, so devices compare equal."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


# ---------------------------------------------------------------------------
# flags
# ---------------------------------------------------------------------------

_flags = {}  # set from the environment at import (FLAGS_name=value)


def _parse_flag(typ, text):
    if typ is bool:
        return text.lower() in ("1", "true", "yes", "on")
    return typ(text)


def define_flag(name, default, help=""):
    """Register a flag; `help` documents it.  The environment variable of
    the same name overrides the default."""
    env = os.environ.get(name)
    _flags[name] = default if env is None else _parse_flag(type(default), env)


def flag(name):
    return _flags[name]


define_flag(
    "FLAGS_serve_slots", 4,
    "continuous-batching engine: number of slots (max concurrently decoding "
    "requests)",
)
define_flag(
    "FLAGS_serve_queue_depth", 32,
    "continuous-batching engine: admission queue bound; submissions beyond "
    "it fail fast (serve() maps this to HTTP 503)",
)
define_flag(
    "FLAGS_serve_prefill_buckets", "16,32,64,128",
    "continuous-batching engine: comma-separated prompt-length buckets "
    "(prompts pad up to their bucket)",
)
define_flag(
    "FLAGS_serve_paged_kv", True,
    "continuous-batching engine: back the KV cache with a block-paged pool "
    "addressed through per-slot page tables",
)
define_flag(
    "FLAGS_serve_kv_page_size", 128,
    "paged KV: tokens per page, clamped to the engine max_len",
)
define_flag(
    "FLAGS_serve_kv_pool_pages", 0,
    "paged KV: total pages in the pool (page 0 is a permanent scratch page "
    "for masked and inactive writes).  0 = auto: slots * pages_per_seq + 1",
)
define_flag(
    "FLAGS_serve_prefix_cache", False,
    "paged KV: prefix cache over committed prompt pages.  Not ported yet; "
    "True raises NotImplementedError at engine construction",
)
define_flag(
    "FLAGS_serve_decode_kernel", "auto",
    "paged engine: attention kernel of the decode step.  'auto' and 'fused' "
    "run the paged_decode_fused kernel (its plain version on CPU tensors), "
    "'gather' the materialised-gather oracle",
)
define_flag(
    "FLAGS_serve_spec_k", 0,
    "speculative decoding draft length.  Not ported yet; > 0 raises",
)
define_flag(
    "FLAGS_serve_kv_quant", "none",
    "KV storage precision.  Only 'none' is ported; 'int8' raises",
)
define_flag("FLAGS_serve_tp", 1, "tensor-parallel degree.  Not ported; > 1 raises")
define_flag("FLAGS_serve_cp", 1, "context-parallel degree.  Not ported; > 1 raises")
