"""Paged adapter arena: device-resident LoRA factors rationed like KV pages
(counterpart of `paddle_tpu/lora/arena.py`).

The device side is one float32 buffer `[capacity+1, row]`, allocated once
on the engine's device, outside any graph's memory pool.  Row `slot` holds
one adapter: for every (layer, target) its `A [in, r_max]` and
`B [r_max, out]`, then its scale.  The per-(layer, target) stacks
`A [capacity+1, in, r_max]`, `B [capacity+1, r_max, out]` and the shared
`scale [capacity+1]` are strided views of that buffer, so the step graphs
read fixed addresses at every replay, and loading an adapter is ONE host
to device copy into its row: the storage never moves, no graph retraces.

Slot 0 is the pinned base-model passthrough: all-zero factors, scale 0, so
the gathered delta of id 0 is exactly zero and co-batched base rows stay
bit-identical to the base model.  Slots 1..capacity are refcounted by the
port's `PagePool`, as KV pages are: residency holds one ref, every bound
engine slot another, and eviction is LRU over slots at refcount 1 only, so
an adapter a request is decoding with is never evicted under it.

Ranks below `r_max` are zero-padded (exact: padded columns add nothing);
targets an adapter does not provide stay zero (a zero delta is the base
projection).

Uploads are ordered on the current stream of the engine's device, the
stream every step graph replays on, so an upload lands after every replay
dispatched before it and before the next one.  The refcount rule keeps it
off any row an in-flight step reads: only an unbound adapter is evicted,
and a request binds its slot before its first dispatch.

The delta itself (`lora_delta_add`) is the reference's XLA math, outside
any Pallas kernel: an `index_select` gather of each slot's factors and two
batched matmuls in float32, cast to the activations' dtype at the add.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import profiler
from ..framework import core as _core
from ..inference.paging import PagePool
from .registry import TARGETS, target_dims


class AdapterArenaFull(RuntimeError):
    """Every arena slot is bound to an in-flight request: the load must wait
    for a decode to finish.  Admission parks the request (retriable
    backpressure, like page-pool pressure); it is never failed."""


def lora_delta_add(y, x, ids, A, B, scale):
    """`y + ((x @ A[ids]) @ B[ids] * scale[ids])` (reference: `_delta_add`,
    arena.py:49): the batched-gather LoRA delta.  y [b, s, out] is the base
    projection of x [b, s, in]; ids [b] int32 are arena slots (data, like
    page tables), so one graph serves every adapter mix.  The product runs
    in the stacks' float32 (no TF32 under `parity_matmuls()`) and is cast
    to y's dtype at the add."""
    a = A.index_select(0, ids)  # [b, in, r]
    b = B.index_select(0, ids)  # [b, r, out]
    s = scale.index_select(0, ids)  # [b]
    t = torch.bmm(x.to(A.dtype), a)
    d = torch.bmm(t, b) * s[:, None, None]
    return y + d.to(y.dtype)


class _LayerView:
    """One layer's slice of the arena, bound to this step's slot ids."""

    __slots__ = ("_arena", "_layer", "_ids")

    def __init__(self, arena, layer, ids):
        self._arena = arena
        self._layer = layer
        self._ids = ids

    def add(self, target, y, x):
        """Base projection output `y` (from input `x`) plus this layer's
        gathered delta for `target`."""
        A, B = self._arena._stacks[(self._layer, target)]
        return lora_delta_add(y, x, self._ids, A, B, self._arena._scale)


class ArenaView:
    """A dispatch's binding of the arena to a [b] int32 slot-id tensor; the
    model asks it for per-layer views as it walks the decoder."""

    __slots__ = ("_arena", "_ids")

    def __init__(self, arena, ids):
        self._arena = arena
        self._ids = ids

    def layer(self, i):
        return _LayerView(self._arena, i, self._ids)


class AdapterArena:
    """Refcounted LRU arena of device-resident adapters over one registry.

    `capacity` (resident adapters) and `rank_max` (the padded rank) default
    to FLAGS_serve_lora_capacity and FLAGS_serve_lora_rank_max;
    `device=None` means the CUDA card (pass the engine's device).  Every
    mutation (acquire, release, evict, upload) holds `_mu`; the step graphs
    read the device rows without it.
    """

    def __init__(self, registry, capacity=None, rank_max=None, device=None):
        self.registry = registry
        self.capacity = int(_core.flag("FLAGS_serve_lora_capacity")
                            if capacity is None else capacity)
        self.rank_max = int(_core.flag("FLAGS_serve_lora_rank_max")
                            if rank_max is None else rank_max)
        if self.capacity < 1:
            raise ValueError("adapter arena needs capacity >= 1")
        if self.rank_max < 1:
            raise ValueError("adapter arena needs rank_max >= 1")
        self.device = _core.resolve_device(device)
        self._mu = threading.Lock()
        # slot 0 = the pinned base passthrough, exactly PagePool's scratch page
        self._pool = PagePool(self.capacity + 1)
        self._slot_of = {}     # adapter_id -> arena slot
        self._adapter_at = {}  # arena slot -> LoRAAdapter
        self._clock = 0
        self._last_used = {}   # arena slot -> LRU tick
        self._hits = 0
        self._misses = 0
        r = self.rank_max
        dims = target_dims(registry.config)
        # (layer, target) -> (offset of A in a row, offset of B)
        self._layout = {}
        off = 0
        for layer in range(registry.num_layers):
            for t in TARGETS:
                d_in, d_out = dims[t]
                self._layout[(layer, t)] = (off, off + d_in * r)
                off += (d_in + d_out) * r
        self.row_elems = off + 1  # the scale last
        n = self.capacity + 1
        self._rows = torch.zeros(n, self.row_elems, dtype=torch.float32,
                                 device=self.device)
        self._stacks = {}
        for (layer, t), (a_off, b_off) in self._layout.items():
            d_in, d_out = dims[t]
            A = self._rows[:, a_off:a_off + d_in * r].view(n, d_in, r)
            B = self._rows[:, b_off:b_off + r * d_out].view(n, r, d_out)
            self._stacks[(layer, t)] = (A, B)
        self._scale = self._rows[:, off]

    @property
    def nbytes(self):
        """Device bytes of the stacks, the base slot included."""
        return self._rows.numel() * self._rows.element_size()

    def view(self, ids):
        return ArenaView(self, ids)

    def shard_for_tp(self):
        """The reference re-places the stacks on the 'mp' mesh; the port
        has no tensor-parallel serving yet."""
        raise NotImplementedError(
            "shard_for_tp is not ported to paddle_tpu_torch yet (ROADMAP "
            "Queue 1: tensor-parallel serving)")

    # -- residency ----------------------------------------------------------

    def acquire(self, adapter):
        """Bind one request to `adapter`: incref its slot if resident, else
        evict if needed and upload.  Returns the arena slot.  Raises
        AdapterArenaFull when every slot is bound to in-flight requests."""
        with self._mu:
            slot = self._slot_of.get(adapter.adapter_id)
            if slot is not None:
                self._pool.incref(slot)
                self._tick_locked(slot)
                self._hits += 1
                profiler.record_lora_event("residency_hits")
                return slot
            self._misses += 1
            profiler.record_lora_event("residency_misses")
            if self._pool.free_count() == 0 and self._evict_one_locked() is None:
                raise AdapterArenaFull(
                    f"adapter arena full: {self.capacity} slots all bound to "
                    "in-flight requests")
            slot = self._pool.alloc()  # refcount 1: the residency hold
            self._upload_locked(slot, adapter)
            self._slot_of[adapter.adapter_id] = slot
            self._adapter_at[slot] = adapter
            self._tick_locked(slot)
            self._pool.incref(slot)  # the caller's binding
            profiler.record_lora_event("loads")
            profiler.record_lora_residency(len(self._slot_of), self.capacity)
            return slot

    def release(self, slot):
        """Drop one request's binding.  The residency hold keeps the slot
        at refcount >= 1: the adapter stays resident (warm) until LRU
        eviction needs the slot."""
        if slot == 0:
            return
        with self._mu:
            self._pool.decref(slot)

    def _tick_locked(self, slot):
        self._clock += 1
        self._last_used[slot] = self._clock

    def _evict_one_locked(self):
        """Evict the LRU resident adapter nothing is bound to (refcount 1,
        the residency hold alone).  Returns the freed slot or None."""
        victim = None
        for aid, slot in self._slot_of.items():
            if self._pool.refs[slot] != 1:
                continue
            if victim is None or self._last_used[slot] < self._last_used[victim[1]]:
                victim = (aid, slot)
        if victim is None:
            return None
        aid, slot = victim
        del self._slot_of[aid]
        del self._adapter_at[slot]
        del self._last_used[slot]
        self._pool.decref(slot)  # refcount 1 -> 0: back on the free list
        profiler.record_lora_event("evictions")
        profiler.record_lora_residency(len(self._slot_of), self.capacity)
        return slot

    def _upload_locked(self, slot, adapter):
        """Rewrite arena row `slot` with the adapter's zero-padded factors
        and scale, in one copy into the same storage.  Targets the adapter
        does not provide are zeroed: the previous tenant's rows must not
        leak.  On the card the row is filled in pinned host memory and
        copied without a sync, ordered on the current stream (the host
        allocator keeps the block until the copy has run)."""
        on_card = self.device.type == "cuda"
        host = torch.zeros(self.row_elems, dtype=torch.float32,
                           pin_memory=on_card)
        row = host.numpy()
        r, rmax = adapter.rank, self.rank_max
        dims = self.registry.dims
        for key, (A, B) in adapter.weights.items():
            d_in, d_out = dims[key[1]]
            a_off, b_off = self._layout[key]
            row[a_off:a_off + d_in * rmax].reshape(d_in, rmax)[:, :r] = A
            row[b_off:b_off + rmax * d_out].reshape(rmax, d_out)[:r] = B
        row[-1] = adapter.scale
        self._rows[slot].copy_(host, non_blocking=on_card)

    # -- introspection ------------------------------------------------------

    def slot_of(self, adapter_id):
        """Resident arena slot of a stable adapter id, or None."""
        with self._mu:
            return self._slot_of.get(adapter_id)

    def resident(self):
        """Sorted resident adapter names (healthz, the flight recorder)."""
        with self._mu:
            return sorted(a.name for a in self._adapter_at.values())

    def stats(self):
        with self._mu:
            lookups = self._hits + self._misses
            return {
                "capacity": self.capacity,
                "resident": len(self._slot_of),
                "free": self._pool.free_count(),
                "hit_rate": (self._hits / lookups) if lookups else 1.0,
            }

    def check_invariants(self, bindings):
        """Refcount audit (FLAGS_serve_debug_invariants): `bindings` maps
        arena slot -> engine slots bound to it.  Every resident slot holds
        exactly 1 (residency) + its bindings, and the free list is exactly
        the non-resident slots.  Raises AssertionError."""
        with self._mu:
            expected = np.zeros(self.capacity + 1, np.int64)
            expected[0] = 1  # the pinned base slot
            for slot in self._slot_of.values():
                expected[slot] = 1 + int(bindings.get(slot, 0))
            if not np.array_equal(expected, self._pool.refs):
                raise AssertionError(
                    f"adapter arena refcount mismatch: expected "
                    f"{expected.tolist()}, pool has {self._pool.refs.tolist()}")
            free = set(range(1, self.capacity + 1)) - set(self._slot_of.values())
            if free != set(self._pool._free):
                raise AssertionError(
                    f"adapter arena free list {sorted(self._pool._free)} != "
                    f"non-resident slots {sorted(free)}")
