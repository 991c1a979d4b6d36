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

The per-compiled-shape dispatch counts (`ops.flash_attention.
pallas_calls`, the reference's meaning) move only in a trace's warm run
(on the CPU, its one eager run): the capture, every replay and
`compare_eager` leave them as they were.  `trace_total` counts every
trace in the process, of a StepGraph or of a `jit.StaticFunction`
(`/metrics`' `paddle_sanitizer_traces_total`).

The capture core (`warm_run`, `capture`) is shared with
`jit.StaticFunction`, which captures whole training steps the same way.
Inside a capture, `conditional_body` puts what runs under it into the body
of an IF or WHILE node of the graph (`static.nn.cond`, `while_loop`).

A failed capture raises; there is no eager fallback on CUDA.
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref

import numpy as np
import torch

from ..ops import flash_attention as _fa

trace_total = 0  # StepGraph and StaticFunction traces in this process

# the captures in progress, by the handle of each stream that captures
# into them (the capture's own stream, and a conditional body's while it is
# captured) -> _Capture: what `conditional_body` finds from the current
# stream, on the capturing thread and on autograd's device thread, which
# runs a captured step's backward on the stream of its forward
_captures = {}


def note_trace():
    """Count one trace in `trace_total`."""
    global trace_total
    trace_total += 1


def new_pool(device):
    """A graph memory pool for every StepGraph of one engine (they never run
    at the same time), or None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    return torch.cuda.graph_pool_handle()


def set_counts(counters, snap):
    """Put the launch-count dict `counters` back to the snapshot `snap`."""
    for k in counters:
        counters[k] = snap.get(k, 0)


def add_delta(counters, delta):
    for k, n in delta.items():
        counters[k] = counters.get(k, 0) + n


def count_delta(counters, before):
    """What `counters` gained since the snapshot `before`."""
    return {k: v - before.get(k, 0) for k, v in counters.items()
            if v != before.get(k, 0)}


def warm_run(fn, device):
    """fn() on a side stream, ordered after and before the current one
    (kernel builds, shared-memory limits, cuBLAS and cuDNN workspaces and
    their autotuning happen here, outside any capture).  Returns fn()'s
    result."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        out = fn()
    cur.wait_stream(side)
    return out


def capture(body, device, pool=None, generators=(), counters=()):
    """Capture body() into a `torch.cuda.CUDAGraph` in the memory pool
    `pool` (`capture_error_mode="thread_local"`, so another thread's work
    never lands in it), with `generators` registered so that each replay
    draws on from their state at that time.  The device is synchronized
    and the cache emptied first, so the warm run's cached blocks do not sit
    beside the graph's pool.  A capture launches nothing: the launch
    counts it bumped in each dict of `counters` are taken back and
    returned as the delta each replay adds, and the per-compiled-shape
    dispatch counts (`pallas_calls`, which the warm run counted) are put
    back.  Returns (graph, body's outputs, [delta per dict], the bytes the
    pool grew by).  A failed capture raises."""
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    for gen in generators:
        graph.register_generator_state(gen)
    before = [dict(c) for c in counters]
    dispatches = dict(_fa.pallas_calls)
    index = torch.device(device).index
    rec = _Capture(torch.cuda.current_device() if index is None else index)
    key = None
    try:
        with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
            key = torch.cuda.current_stream().cuda_stream
            _captures[key] = rec
            outs = body()
    finally:
        _captures.pop(key, None)
        rec.close(graph)
        delta = [count_delta(c, b) for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            set_counts(c, b)
        _fa.pallas_calls.update(dispatches)
    grew = max(0, torch.cuda.memory_reserved(device) - reserved)
    return graph, outs, delta, grew


class _Capture:
    """What the conditional bodies of one capture share: the side streams
    their bodies are captured on (one per nesting depth, the same for a
    forward branch and its backward, so autograd never joins two streams
    inside a body) and the memory pool their allocations come from.  The
    graph's own pool takes only the capturing stream's allocations, so a
    body's go to a pool of its own, routed by thread while the body runs
    and kept alive as long as the graph (`close`)."""

    def __init__(self, index):
        self.index = index
        self.depth = 0
        self.streams = []
        self.pool = None

    def stream(self):
        while len(self.streams) <= self.depth:
            # torch hands out new streams round-robin from a fixed pool that
            # also holds the capturing stream (`torch.cuda.graph`'s default):
            # skip a stream that a capture or a body already uses
            busy = set(_captures) | {s.cuda_stream for s in self.streams}
            side = torch.cuda.Stream(self.index)
            while side.cuda_stream in busy:
                side = torch.cuda.Stream(self.index)
            self.streams.append(side)
        return self.streams[self.depth]

    def route(self):
        """Route this thread's allocations to the bodies' pool (created with
        a use held for the graph at the first body); returns the undo."""
        if self.pool is None:
            self.pool = torch.cuda.graph_pool_handle()
            torch._C._cuda_beginAllocateCurrentThreadToPool(self.index, self.pool)
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
        torch._C._cuda_beginAllocateCurrentThreadToPool(self.index, self.pool)

        def undo():
            torch._C._cuda_endAllocateToPool(self.index, self.pool)
            torch._C._cuda_releasePool(self.index, self.pool)

        return undo

    def close(self, graph):
        if self.pool is not None:
            weakref.finalize(graph, torch._C._cuda_releasePool, self.index, self.pool)


def _flag(pred, device):
    """pred as a one-byte device flag (nonzero: true)."""
    if not isinstance(pred, torch.Tensor) or pred.device != device or pred.numel() != 1:
        raise ValueError(
            f"a conditional node's predicate must be a one-element tensor on "
            f"{device}, got {pred if not isinstance(pred, torch.Tensor) else pred.shape}")
    if pred.dtype not in (torch.bool, torch.uint8):
        pred = pred != 0
    return pred.reshape(1).contiguous()


@contextlib.contextmanager
def conditional_body(pred, negate=False, loop=False):
    """Inside a capture (`capture`), capture the block into the body of a
    conditional node at the current stream's position: an IF node
    (`loop=False`), whose body runs at a replay when the device flag `pred`
    (a one-element tensor; `negate` flips it) is true, or a WHILE node
    (`loop=True`), whose body runs while it is true.  The block runs with a
    side stream current, whose captured work is the body; for a WHILE node
    it yields a callable `next(flag)` that the body calls last, with the
    device flag of the next pass.  No work of the block executes here: a
    capture launches nothing.  Raises outside a capture."""
    from ..ops._build import check, lib

    cur = torch.cuda.current_stream()
    rec = _captures.get(cur.cuda_stream)
    if rec is None or not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a conditional node is made only inside a CUDA graph "
                           "capture (`inference.graphs.capture`)")
    flag = _flag(pred, cur.device)
    child = rec.stream()
    handle = ctypes.c_ulonglong()
    check(lib().ptt_cond_begin(cur.cuda_stream, child.cuda_stream, flag.data_ptr(),
                               int(bool(negate)), int(bool(loop)), ctypes.byref(handle)),
          "conditional node")
    rec.depth += 1
    _captures[child.cuda_stream] = rec
    undo = rec.route()

    def next_pass(new):
        new = _flag(new, cur.device)
        check(lib().ptt_cond_set(handle.value, new.data_ptr(), 0, child.cuda_stream),
              "conditional node flag")

    try:
        with torch.cuda.stream(child):
            yield next_pass if loop else None
    finally:
        undo()
        rec.depth -= 1
        del _captures[child.cuda_stream]
        check(lib().ptt_cond_end(child.cuda_stream), "conditional node body")


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
            note_trace()
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
        dispatches = dict(_fa.pallas_calls)
        try:
            self._run(ent)
            replayed = tuple(o.clone() for o in ent.outputs)
            restore()
            eager = tuple(o.clone() for o in self.body(**ent.inputs))
            restore()
        finally:
            set_counts(self.counters, snap)
            _fa.pallas_calls.update(dispatches)
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

    def _trace(self, key, inputs):
        ent = _Entry({n: self._static(v) for n, v in inputs.items()})
        if not self.on_card:
            before = dict(self.counters)
            ent.outputs = self._as_tuple(self.body(**ent.inputs))
            ent.delta = count_delta(self.counters, before)
            return ent
        dev = self.device
        saved = {n: b.clone() for n, b in ent.inputs.items()}
        gen_states = [g.get_state() for g in self.generators]
        warm_run(lambda: self.body(**ent.inputs), dev)  # real launches, counted
        self._put_back(ent.inputs, saved)
        for gen, state in zip(self.generators, gen_states):
            gen.set_state(state)
        graph, outs, (delta,), grew = capture(
            lambda: self._as_tuple(self.body(**ent.inputs)), dev, self.pool,
            self.generators, (self.counters,))
        ent.delta = delta
        self.pool_bytes += grew
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
        dispatches = dict(_fa.pallas_calls)
        self._run(ent)
        set_counts(self.counters, snap)  # the eager CPU body bumps them itself
        _fa.pallas_calls.update(dispatches)
        add_delta(self.counters, ent.delta)
