"""Adapter registry: validated LoRA weight sets with stable integer ids
(counterpart of `paddle_tpu/lora/registry.py`; the same names, errors and
random stream).

An adapter is a dict `{(layer, target): (A, B)}` of numpy low-rank factors
in the repo's Linear layout (`y = x @ W`, weights `[in, out]`): A is
`[in_features, rank]`, B is `[rank, out_features]`, and the served delta is
`x @ A @ B * (alpha / rank)`.  Targets cover every projection the decoder
touches (q/k/v/o + gate/up/down); an adapter may provide any subset — the
arena zero-fills the rest, which is exact (a zero delta IS the base model).

Ids start at 1 and are never reused; id 0 is reserved engine-wide for "no
adapter" (the arena's pinned base slot).  `AdapterUnknown` is the typed
miss: serve() maps it to HTTP 404 with `retriable: false`.

The weights dict is the reference's format as it is, so one dict
registers in both packages, and `make_random` draws the reference's
`numpy.random.RandomState` stream: the same seed gives the same float32
factors.
"""

from __future__ import annotations

import threading

import numpy as np

# every projection the LoRA delta can target, in decoder order
TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


def target_dims(config):
    """(in_features, out_features) per target for a LlamaConfig."""
    h = config.hidden_size
    kv = config.num_key_value_heads * (h // config.num_attention_heads)
    inter = config.intermediate_size
    return {
        "q_proj": (h, h),
        "k_proj": (h, kv),
        "v_proj": (h, kv),
        "o_proj": (h, h),
        "gate_proj": (h, inter),
        "up_proj": (h, inter),
        "down_proj": (inter, h),
    }


class AdapterUnknown(Exception):
    """Request named an adapter the registry has never seen.  Terminal for
    the request (HTTP 404, retriable: false) — retrying cannot help until
    someone registers the adapter."""

    def __init__(self, name):
        super().__init__(f"unknown adapter {name!r}")
        self.adapter = name


class LoRAAdapter:
    """One validated adapter: name, stable id, rank, scale, and the numpy
    A/B factors keyed `(layer, target)`."""

    __slots__ = ("name", "adapter_id", "rank", "scale", "weights")

    def __init__(self, name, adapter_id, rank, scale, weights):
        self.name = name
        self.adapter_id = int(adapter_id)
        self.rank = int(rank)
        self.scale = float(scale)
        self.weights = weights


class AdapterRegistry:
    """Name -> adapter index with shape validation against one model config.

    Thread-safe: registration happens from test/bench setup or an admin
    path while the serving scheduler resolves names concurrently.
    """

    def __init__(self, config):
        self.config = config
        self.dims = target_dims(config)
        self.num_layers = int(config.num_hidden_layers)
        self._mu = threading.Lock()
        self._by_name = {}
        self._by_id = {}
        self._next_id = 1

    def register(self, name, weights, rank, alpha=None):
        """Validate and admit one adapter; returns the LoRAAdapter.  `alpha`
        defaults to `rank` (scale 1.0).  Re-registering a name is an error —
        ids are stable precisely because entries are immutable."""
        if rank < 1:
            raise ValueError(f"adapter {name!r}: rank must be >= 1, got {rank}")
        checked = {}
        for key, (A, B) in weights.items():
            layer, target = key
            if not (0 <= int(layer) < self.num_layers):
                raise ValueError(
                    f"adapter {name!r}: layer {layer} out of range "
                    f"[0, {self.num_layers})"
                )
            if target not in self.dims:
                raise ValueError(
                    f"adapter {name!r}: unknown target {target!r} "
                    f"(expected one of {TARGETS})"
                )
            d_in, d_out = self.dims[target]
            A = np.asarray(A, np.float32)
            B = np.asarray(B, np.float32)
            if A.shape != (d_in, rank):
                raise ValueError(
                    f"adapter {name!r} {target} layer {layer}: A shape "
                    f"{A.shape} != {(d_in, rank)}"
                )
            if B.shape != (rank, d_out):
                raise ValueError(
                    f"adapter {name!r} {target} layer {layer}: B shape "
                    f"{B.shape} != {(rank, d_out)}"
                )
            checked[(int(layer), target)] = (A, B)
        scale = (rank if alpha is None else alpha) / float(rank)
        with self._mu:
            if name in self._by_name:
                raise ValueError(f"adapter {name!r} already registered")
            adapter = LoRAAdapter(name, self._next_id, rank, scale, checked)
            self._next_id += 1
            self._by_name[name] = adapter
            self._by_id[adapter.adapter_id] = adapter
        return adapter

    def resolve(self, name):
        """Name (or stable id) -> LoRAAdapter; raises AdapterUnknown."""
        with self._mu:
            a = self._by_name.get(name)
            if a is None and isinstance(name, int):
                a = self._by_id.get(name)
        if a is None:
            raise AdapterUnknown(name)
        return a

    def names(self):
        with self._mu:
            return sorted(self._by_name)

    def __len__(self):
        with self._mu:
            return len(self._by_name)


def make_random(registry, name, rank=4, seed=0, alpha=None, targets=TARGETS,
                scale=0.02):
    """Register a random adapter covering `targets` on every layer (the
    tests' and chip checks' generator).  Factors are small-normal so deltas perturb logits
    without swamping them; distinct seeds give distinct greedy outputs."""
    rng = np.random.RandomState(seed)
    dims = registry.dims
    weights = {}
    for layer in range(registry.num_layers):
        for t in targets:
            d_in, d_out = dims[t]
            A = rng.normal(0.0, scale, (d_in, rank)).astype(np.float32)
            B = rng.normal(0.0, scale, (rank, d_out)).astype(np.float32)
            weights[(layer, t)] = (A, B)
    return registry.register(name, weights, rank, alpha=alpha)
