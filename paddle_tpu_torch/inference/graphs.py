"""Captured step executables of the serving engine: the port's counterpart
of `paddle_tpu/jit/__init__.py`'s `StaticFunction` (its `trace_count`,
jit/__init__.py:183, :247), with a CUDA graph in the place of an XLA
executable.

A `StepGraph` owns one step body and, per key (a prefill bucket, or None
for a step of one shape), the body's static input buffers and its static
outputs.  The first call with a key is the trace:

- on CUDA, one eager warm run of the body on a side stream (kernel builds,
  shared-memory limits, cuBLAS workspaces), the inputs the body updated in
  place and the generators it drew from put back (so the replay draws what
  the warm run drew, and a re-seeded call repeats a traced one), then the
  capture into a `torch.cuda.CUDAGraph`
  (`capture_error_mode="thread_local"`, so a capture on the scheduler
  thread never catches another thread's work) in the memory pool shared by
  every graph of the engine, then one replay;
- on the CPU, one eager run of the body.

Later calls copy the inputs they name into the static buffers (numpy values
through pinned host memory) and replay the graph, or on the CPU run the
body again on the same buffers and copy its results into the same output
tensors.  Either way the outputs are the static tensors themselves: the
caller copies whatever it keeps past the next call, on the CPU too, so the
CPU tests catch a result that aliases them.

Launch counts (`ops.flash_attention.launch_counts`) are bumped in Python
where a wrapper launches its kernel, so a replay would count nothing: the
trace records the counts that the capture added (and takes them back, since
a capture launches nothing) and every replay adds that delta.  The counts
stay "kernels launched": a trace on CUDA counts its warm run and its
replay.  On the CPU a replay counts the same delta, whatever the eager body
bumped.

A failed capture raises; there is no eager fallback on CUDA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import flash_attention as _fa


def new_pool(device):
    """A graph memory pool for every StepGraph of one engine (they never run
    at the same time), or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


class _Entry:
    """One key's executable: static inputs, static outputs, the CUDA graph
    (None on the CPU) and the launch-count delta of one run."""

    __slots__ = ("inputs", "outputs", "graph", "delta")

    def __init__(self, inputs):
        self.inputs = inputs
        self.outputs = None
        self.graph = None
        self.delta = {}


class StepGraph:
    """`body(**inputs)` -> tuple of tensors, run as one executable per key.

    `name` labels errors; `device` is the engine's; `pool` is `new_pool`'s
    handle; `generators` are the torch.Generators the body draws from,
    registered with every graph so that each replay advances them;
    `counters` is the launch-count dict whose capture delta each replay adds
    (the kernels' `launch_counts` unless a test passes its own).
    `trace_count` counts traced keys, `replay_count` the calls after them,
    `last_key` is the key of the last call, `pool_bytes` the device memory
    reserved while capturing, `tracing` whether a trace (on CUDA: a warm
    run and a capture) is in progress."""

    def __init__(self, name, body, device, pool=None, generators=(),
                 counters=None):
        self.name = str(name)
        self.body = body
        self.device = torch.device(device)
        self.pool = pool
        self.generators = tuple(generators)
        self.counters = _fa.launch_counts if counters is None else counters
        self.trace_count = 0
        self.replay_count = 0
        self.pool_bytes = 0
        self.last_key = None
        self.tracing = False
        self._entries = {}

    @property
    def on_card(self):
        return self.device.type == "cuda"

    def inputs(self, key):
        """The static input buffers of `key` (a dict), as its last call left
        them."""
        return self._entries[key].inputs

    def __call__(self, key, **inputs):
        """Run the executable of `key` after copying `inputs` (numpy arrays
        or tensors, by name) into its static buffers; the first call with a
        key must name every input and traces.  Returns the static outputs."""
        self.last_key = key
        ent = self._entries.get(key)
        if ent is None:
            self.tracing = True
            try:
                ent = self._trace(key, inputs)
            finally:
                self.tracing = False
            self._entries[key] = ent
            self.trace_count += 1
            return ent.outputs
        for name, value in inputs.items():
            if name not in ent.inputs:
                raise KeyError(f"{self.name}: no static input {name!r}")
            self._copy_in(ent.inputs[name], value, name)
        self._replay(ent)
        self.replay_count += 1
        return ent.outputs

    def compare_eager(self, key, state=()):
        """One replay of `key` beside one eager run of its body on the same
        static inputs (restored between and after them, arenas aside, which
        both write alike).  `state`: other tensors the body rewrites in
        place and reads again (beam search reorders its KV caches), saved
        and restored likewise.  Launch counts are left as they were.
        Returns (replayed outputs, eager outputs), copies both."""
        ent = self._entries[key]
        saved = {n: b.clone() for n, b in ent.inputs.items()}
        kept = [t.clone() for t in state]

        def restore():
            self._put_back(ent.inputs, saved)
            for t, old in zip(state, kept):
                t.copy_(old)

        snap = dict(self.counters)
        try:
            self._run(ent)
            replayed = tuple(o.clone() for o in ent.outputs)
            restore()
            eager = tuple(o.clone() for o in self.body(**ent.inputs))
            restore()
        finally:
            self._set_counts(snap)
        if self.on_card:
            torch.cuda.synchronize(self.device)
        return replayed, eager

    # -- internals -------------------------------------------------------------

    def _copy_in(self, buf, value, name):
        src = (value if isinstance(value, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(value)))
        if tuple(src.shape) != tuple(buf.shape) or src.dtype != buf.dtype:
            raise ValueError(
                f"{self.name}: input {name!r} is {tuple(src.shape)} {src.dtype}, "
                f"its static buffer {tuple(buf.shape)} {buf.dtype}"
            )
        # host values reach the card from pinned memory, without a sync;
        # the host allocator keeps the block until the copy has run
        upload = self.on_card and src.device.type == "cpu"
        if upload and not src.is_pinned():
            src = src.pin_memory()
        buf.copy_(src, non_blocking=upload)

    def _static(self, value):
        if isinstance(value, torch.Tensor):
            return value.detach().to(self.device, copy=True)
        return torch.from_numpy(np.array(value)).to(self.device)

    @staticmethod
    def _put_back(bufs, saved):
        for n, b in bufs.items():
            b.copy_(saved[n])

    def _set_counts(self, snap):
        for k in self.counters:
            self.counters[k] = snap.get(k, 0)

    def _add_delta(self, delta):
        for k, n in delta.items():
            self.counters[k] = self.counters.get(k, 0) + n

    def _delta(self, before):
        return {k: v - before.get(k, 0) for k, v in self.counters.items()
                if v != before.get(k, 0)}

    def _trace(self, key, inputs):
        ent = _Entry({n: self._static(v) for n, v in inputs.items()})
        if not self.on_card:
            before = dict(self.counters)
            ent.outputs = self._as_tuple(self.body(**ent.inputs))
            ent.delta = self._delta(before)
            return ent
        dev = self.device
        saved = {n: b.clone() for n, b in ent.inputs.items()}
        gen_states = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self.body(**ent.inputs)  # the warm run: real launches, counted
        torch.cuda.current_stream(dev).wait_stream(side)
        self._put_back(ent.inputs, saved)
        torch.cuda.synchronize(dev)
        for gen, state in zip(self.generators, gen_states):
            gen.set_state(state)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        before = dict(self.counters)
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            outs = self._as_tuple(self.body(**ent.inputs))
        ent.delta = self._delta(before)
        self._set_counts(before)  # a capture launches nothing
        self.pool_bytes += max(0, torch.cuda.memory_reserved(dev) - reserved)
        ent.graph, ent.outputs = graph, outs
        self._replay(ent)
        return ent

    def _as_tuple(self, outs):
        if not isinstance(outs, tuple) or not all(isinstance(o, torch.Tensor)
                                                 for o in outs):
            raise TypeError(f"{self.name}: a step body returns a tuple of tensors")
        return outs

    def _run(self, ent):
        if ent.graph is not None:
            ent.graph.replay()
            return
        for out, new in zip(ent.outputs, self._as_tuple(self.body(**ent.inputs))):
            out.copy_(new)

    def _replay(self, ent):
        snap = dict(self.counters)
        self._run(ent)
        self._set_counts(snap)  # the eager CPU body bumps them itself
        self._add_delta(ent.delta)
