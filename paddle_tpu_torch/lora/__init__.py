"""Multi-tenant LoRA serving (counterpart of `paddle_tpu/lora/`).

Serve N LoRA adapters from one base model on one paged engine:

- `AdapterRegistry` (registry.py): validated low-rank A·B weight sets per
  target projection, each with a stable, monotonically assigned integer
  id.  The stable id (never the arena slot) keys everything
  identity-sensitive -- prefix-cache chains, session chains, healthz
  residency -- because arena slots are recycled across evictions.
- `AdapterArena` (arena.py): device-resident stacked factors rationed as
  KV pages are: a `PagePool` refcounts a slot axis of `[capacity+1, ...]`
  A/B stacks, slot 0 is the pinned all-zero base passthrough, eviction is
  LRU over slots nothing is bound to.  Loading an adapter rewrites one row
  in place, so the engine's step graphs never retrace.
- the batched-gather delta (`lora_delta_add`, through the `lora=` hooks of
  `models/llama.py`): per-slot arena ids ride the step graphs as data
  ([slots] int32, like positions and page tables), and every projection
  adds `x @ A[ids] @ B[ids] * scale[ids]`; slot 0's zero rows keep base
  rows co-batched with adapter rows bit-identical to the base model.
"""

from .registry import (
    TARGETS,
    AdapterRegistry,
    AdapterUnknown,
    LoRAAdapter,
    make_random,
    target_dims,
)
from .arena import AdapterArena, AdapterArenaFull, lora_delta_add

__all__ = [
    "TARGETS",
    "AdapterUnknown",
    "AdapterArenaFull",
    "AdapterRegistry",
    "AdapterArena",
    "LoRAAdapter",
    "lora_delta_add",
    "make_random",
    "target_dims",
]
