"""Continuous-batching engine of the port (counterpart of the paged core
and the dense slot pool of `paddle_tpu/inference/engine.py`).

A persistent pool of `slots` decodes together: every scheduler step admits
queued requests into free slots through a bucketed fresh prefill, then runs
ONE decode step over all slots.  Per-slot positions, page tables and the
active mask are data, so requests joining and finishing never change a
shape.  K/V live in a block-paged arena per layer (`[num_pages, page_size,
kv_heads, head_dim]`), addressed through per-slot page tables; a request
holds only the pages that cover `prompt + max_new_tokens`.

Why padding and inactive writes are safe: a prefill's bucket-padding rows
and every inactive slot's decode write land on scratch page 0, which no
live sequence maps; decode attends only rows j <= pos of a slot's own
pages, and every row it attends was written by that slot (or, for a
shared prefix, by the request that committed it) first.

Prefix cache (on by default, as in the reference): a request whose prompt
starts with at least `min_prefix_match` committed tokens maps the shared
full pages read-only, copies a matched partial page (copy-on-write, scale
rows included under int8) and chunk-prefills only the unshared suffix at
its offset, attending the shared pages through the paged kernel.  Every
prefill then commits its prompt's pages; cached pages are evicted LRU when
the allocator runs dry.

kv_quant="int8" stores every page as int8 with a float32 scale per (row,
kv head); the auto-sized pool then holds the bytes of the full-precision
pool, about twice the pages.  A fresh prefill still attends its own
full-precision K/V; decode steps and chunk prefills read the int8 pages
through the `paged_decode_fused_q8` kernel.

Context parallelism (cp > 1, the reference's layout): the pool splits into
cp equal page ranges, each with its own scratch page first, and sequence
page k of every request comes from shard k % cp (fresh pages, the COW tail
and eviction alike).  Admission covers each shard's share of a request's
pages.  Every paged attention (decode step, verify window, chunk prefill)
runs one `paged_decode_partials` (K5) launch per shard over that shard's
slice of the arena and merges the shards' softmax partials.  On one card
the shards are page ranges of the same arena and the merge is torch ops;
across cards it becomes the reference's pmax/psum.

Speculative decoding (spec_k > 0, paged only): each greedy slot drafts up
to k tokens by prompt lookup over its own history (`spec.NgramDrafter`),
and one verify step scores the committed last token plus the drafts, k + 1
rows per slot through the paged kernels.  Draft i is accepted while it
equals the model's greedy token after the rows before it, so the emitted
tokens are the ones one-at-a-time decode gives; a verify step fetches its
tokens every step, as the next drafts need them.  Sampled slots and
requests with spec_k=0 ride the verify step at one row.

paged=False keeps the reference's dense slot pool: one StaticKVCache per
layer, `[slots, max_len, kv_heads, head_dim]`.  A prefill writes the
bucket's K/V rows [0, bucket) of its slot's pool row (`SlotView`) while the
prompt attends to itself through `flash_fwd`; a decode step writes row
pos[s] of every slot and attends rows j <= pos[s] through
`paged_decode_fused` over the pool's page view (each StaticKVCache's
`table`, on the device since construction; per-slot positions never take
`dense_decode`), so it reads only the live rows.  Inactive slots run at pos
0 and write row 0 of their own pool row; bucket padding past the true
prompt length stays until decode overwrites it.  Both are safe because a
slot attends only rows j <= pos of its own pool row, each written first.
The dense pool has no prefix cache, int8 pages (QuantConfigError),
context parallelism or LoRA (ValueError), and speculation is off, as in
the reference.

Multi-tenant LoRA (`lora=` a `lora.AdapterArena`, paged only; reference:
engine.py:638-650): a request names an adapter (`submit(adapter=)`, by
name or stable id); admission binds it to an arena slot (uploading it,
LRU-evicting an unbound adapter if need be) after the page check, and a
full arena parks the request as retriable backpressure.  Each engine
slot's arena slot (`_slot_adapter`, 0 the base model) is a static input
`adapters` of the decode and verify graphs ([slots] int32, loaded with the
rest of the loop state at a membership change) and of the prefill graphs
([1]), and every projection of the model adds its slot's gathered delta:
any adapter mix runs the same graphs, and base rows stay bit-identical to
a no-LoRA engine's.  The binding drops at every terminal resolution;
residency survives a warm restart.  Prefix-cache lookups and commits key
on the stable adapter id (never the arena slot), so pages are shared only
within an adapter, and speculation's drafts are accepted against the
adapter's own greedy tokens.  An engine without `lora=` builds no
`adapters` input: its graphs are the base model's.

Sessions (`submit(session_id=)`, reference: engine.py:2917-2990): with a
prefix cache, a turn that finishes on eos or length commits its whole
committed sequence (prompt and generated tokens whose K/V landed) and
pins that chain in the `SessionStore` under the request's adapter, so the
next turn's prompt -- the transcript so far plus the new user tokens --
hits the pinned pages and chunk-prefills only its suffix.  The allocator
evicts a whole LRU session only once evicting unpinned cache entries
cannot free a page; admission counts session-pinned pages as reachable.
Without a prefix cache `session_id` is accepted and every turn re-prefills
statelessly.

Compiled steps (the reference's `jit.to_static` executables,
engine.py:604-660): every step kind is a `graphs.StepGraph` -- the fresh
prefill and the chunk prefill one per bucket, the decode step, the verify
step and the COW page copy one each -- traced once (`warmup()` traces them
all before traffic) and replayed after that; `compile_counts()` reads their
trace counts under the reference's keys.  On the card each executable is a
CUDA graph around the step's kernels (K1 in the fresh-prefill buckets, K2
or K4 in the decode, verify and chunk steps, K5 in all three under cp; the
dense pool: K1 in its prefills, K2 over its page view in its decode); on
the CPU the same bodies run eagerly on the same static buffers.  Every
per-request value a step reads is data in a static buffer: tokens,
positions, the active mask, temperatures, page tables (and their cp local
tables), a prefill's true length, a chunk's start, a copy's pages.
Sampling runs on the card: greedy and a draw from the engine's generator
are both computed and the temperature picks one.

In-flight decode (the reference's deferred token fetch, engine.py:2594,
:2822): between slot-membership changes the decode loop state lives in the
decode graph's static inputs, which the step itself advances, so a decode
step is one graph replay with no host transfer.  Each dispatched step
leaves a copy of its tokens and finite flags on `_pending_fetch`;
`_flush_pending_locked` fetches them all at once and emits them.  A step
flushes when one of its slots has an EOS watch, an `on_token` consumer,
`keep_logits` or a length bound within reach; admission flushes first, and
so does stop().  A slot whose logits went non-finite errors alone with
NonFiniteLogits; its co-batched slots go on.  Verify steps and the first
token of a prefill are still fetched at once, as in the reference: the
next drafts, and the landing, need them.

Serving fault domain (the reference's, engine.py:51-75):

- Request lifecycle: every submitted request resolves exactly once,
  queued -> prefilling -> decoding -> one of {eos, length, timeout,
  cancelled, restarted, error}.  `deadline_s` evicts an expired slot at
  step granularity (host clock only; the dispatched tokens are flushed
  first, then the slot is recycled, no retrace), and `submit` refuses a
  deadline the queue-drain estimate cannot meet (`DeadlineUnattainable`);
  `cancel()` frees the slot the same way.
- Watchdogged regions: the prefill dispatch, the decode dispatch and the
  host token fetch run under the engine's `fault.Watchdog` with deadline
  FLAGS_serve_step_timeout_sec; an overrun records a trip that the
  `fault.EngineSupervisor` turns into a bounded warm restart.
- Warm restart: `restart()` abandons the scheduler thread behind a
  generation counter, requeues the in-flight requests that emitted nothing,
  fails the rest with `EngineRestarted`, and keeps the pool, the prefix
  cache and every StepGraph (0 new traces).  The graphs' static inputs are
  shared by every thread that replays them, so each dispatch -- static
  input copies, the replay and the copies of its outputs -- runs under a
  launch lock that first checks the generation (`_launch`): a thread of an
  earlier life (one that woke from a hang after the restart) raises
  `_StaleEngine` there and replays nothing.  `restart()` takes that lock
  (bounded; it waits out a capture in progress) before it moves the
  generation, then reloads the loop state from the host mirrors.
- Injectable faults: `serve.prefill.hang` (blocks the prefill dispatch),
  `serve.decode.nan` (a one-hot [S] bool static input of the decode and
  verify graphs NaNs one slot's logits before the finite check for one
  step, then is zeroed on the card; co-batched slots are bit-identical to
  an unpoisoned run) and `serve.loop.crash` (the scheduler thread dies).

A warm restart recovers host-side wedges: a hung dispatch, a crashed
loop, a stalled scheduler.  A kernel that never retires leaves the CUDA
context wedged: no restart can recover it, the supervisor's budget runs
out, and `fail_all()` resolves every request without taking `_mu` from
the thread stuck in the fetch (a bounded acquire) and without a CUDA call.

Observability (the reference's, engine.py:2217-2862): a request
submitted with `trace=(trace_id, parent_span_id)` records, under
FLAGS_trace, an `engine.queue` span (submission to the prefill's
dispatch), `engine.prefill` (or `engine.chunk_prefill` after a prefix
hit), one `engine.decode` span per decode epoch (a stretch of constant
slot membership, opened where the loop state is reloaded and closed at
every membership change; with `engine.verify` and the epoch's drafts
proposed and accepted under speculation) and `engine.fetch` per token
fetch that emitted for it.  Every hook is host code around a dispatch or a
fetch, never inside a step body, and reads the host clock only: with
decode in flight an epoch and a fetch measure host time, as the
reference's do.  Span attributes and the epoch's bookkeeping hold request
ids and trace ids, never a request.  Admission refusals
(`rejected_deadline`, `queue_full`) go to the flight recorder's ring, and
so do restarts and `fail_all` (through `fault.injection.record_event`).

Disaggregated prefill/decode (`role=`, FLAGS_serve_role; reference:
engine.py:447-475, :2428-2530, :2895-3033): paged engines play one side of
a KV handoff.  A request submitted with `export_kv=True` (any paged role;
POST /prefill on a prefill-role server) has its committed prompt rows [0,
L) of every layer read out at its finish on eos or length, while the slot
still maps its pages: one `index_select` per arena tensor into one device
buffer, one copy to pinned host memory, serialized into
`req.kv_export` with the first token (`paging.serialize_kv_handoff`).  A
decode-role engine takes such a payload in `submit(handoff=)`, validated
and staged on the host before it queues; its admission maps fresh pages
(never prefix-shared), uploads the rows once and lands them page by page
through the "import" StepGraph (`[n_layers, page_size, kv_heads,
head_dim]` tiles and the destination page as static inputs; a partial
last page zero-padded, its int8 scale rows 1.0), commits the prompt's
pages to the prefix cache and seats the slot as a prefill landing does:
pos = L, the shipped first token emitted first.  Only decode-role engines
build that graph, so the other roles' `compile_counts()` keep their keys.
`reserve_pages()` holds decode-side headroom before the prefill starts
elsewhere: a counter against fresh-allocation headroom (no pool refs),
consumed by the handoff's admission before its page check, purged on the
scheduler tick after its TTL.

Tensor parallelism (`tp=` or FLAGS_serve_tp, with `devices=`, one torch
device per rank; reference: engine.py:380-428): the model must be built
with `tensor_parallel_degree` tp (else ShardingError, as are heads or kv
heads that do not divide and too few devices: `validate_tp`).  The 'mp'
mesh's ranks run in this process, several on one device where the list
names it several times; without a list they take the visible CUDA
devices, each once.  Rank r owns its column and row blocks of every
projection and its vocabulary block of the embedding and the lm_head
(views of the model's weights), its own KV arena of every layer holding
kv heads [r*hk/tp, (r+1)*hk/tp) (int8 scale arenas likewise; the dense
pool's caches too), and its kernel launches: K1 over its heads in a fresh
prefill, K2 (K4 over int8 pages) over its arena in every decode step,
verify window and chunk prefill.  The row-parallel partial products meet
in the mesh's reduce, the lm_head's blocks in the sampler's gather; every
step is still one StepGraph.  Page ids, tables, the prefix cache, COW and
sessions are rank-agnostic: a page copy copies the page on every rank.  A
LoRA arena is cut per rank (`AdapterArena.shard_for_tp`).  `/healthz`
carries tp and the mesh's shape, the mesh gauges `2 x layers + 1`
reduces per step.

Not ported yet (ROADMAP, Queue 1): tp with cp (item 15b: K5 per head
shard), tp with a disaggregated role or `export_kv` (item 15c), and tp
ranks or cp shards across cards (NCCL, item 17).  A knob that asks for one
of them raises NotImplementedError.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import math
import queue
import threading
import time

import numpy as np
import torch

from .. import profiler as _prof
from ..fault import injection as _inj
from ..fault import watchdog as _wd
from ..framework import core as _fcore
from ..obs import flight as _flight
from ..obs import trace as _obs
from ..models.llama import (
    PagedDecodeView,
    PagedKVCache,
    PagedPrefillView,
    SlotView,
    StaticKVCache,
)
from ..ops.flash_attention import MAX_HEAD_DIM, cp_local_tables
from .graphs import StepGraph, new_pool
from .paging import (
    HandoffFormatError,
    PagePool,
    PrefixCache,
    SessionStore,
    check_scale_arenas,
    check_table_bounds,
    deserialize_kv_handoff,
    kv_page_bytes,
    serialize_kv_handoff,
    shard_kv_for_tp,
    spec_write_pages,
    validate_kv_quant,
    wire_dtype_name,
)
from .spec import NgramDrafter

logger = logging.getLogger("paddle_tpu_torch")

# deadline-miss-rate EWMA weight per terminal resolution (the reference's
# _MISS_EWMA_ALPHA): ~20-request memory
_MISS_EWMA_ALPHA = 0.05
# how long restart() waits for a capture in progress to end before it gives
# up on the launch lock (a capture that never ends means a wedged card)
_CAPTURE_WAIT_S = 120.0


class EngineUnavailable(RuntimeError):
    """The engine cannot take this request now (queue full, draining, dead,
    or an unattainable deadline): serve() answers 503 with a Retry-After
    from the queue-drain estimate (reference: engine.py:146)."""

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class QueueFull(EngineUnavailable):
    """Admission queue at capacity, or a request whose page need exceeds
    the whole pool; serve() answers 503 with a Retry-After header."""


class DeadlineUnattainable(EngineUnavailable):
    """Deadline-aware admission: the request's deadline cannot beat the
    current queue-drain estimate (reference: engine.py:161)."""


class ContextOverflow(ValueError):
    """The prompt does not fit the engine's context (max_len): raised at
    submit, before any page is touched, with the capacity geometry (per
    shard under cp) that serve() returns in its 400 body (reference:
    engine.py:167)."""

    def __init__(self, prompt_len, max_len, cp=1, pages_per_shard=0,
                 page_size=0):
        self.prompt_len = int(prompt_len)
        self.max_len = int(max_len)
        self.cp = int(cp)
        self.pages_per_shard = int(pages_per_shard)
        self.page_size = int(page_size)
        detail = (f"prompt length {self.prompt_len} exceeds engine capacity: "
                  f"max_len={self.max_len}")
        if self.cp > 1:
            detail += (f" (cp={self.cp} shards x {self.pages_per_shard} pages "
                       f"x {self.page_size} tokens/page per shard)")
        super().__init__(detail)

    def body(self):
        """JSON-safe capacity record for the HTTP 400 body."""
        out = {"prompt_len": self.prompt_len, "max_len": self.max_len,
               "cp": self.cp}
        if self.pages_per_shard:
            out["pages_per_shard"] = self.pages_per_shard
            out["page_size"] = self.page_size
            out["tokens_per_shard"] = self.pages_per_shard * self.page_size
        return out


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired mid-flight; its slot was evicted at
    step granularity, with no retrace (reference: engine.py:203)."""

    def __init__(self, request_id, tokens_done, max_new_tokens, deadline_s):
        self.request_id = request_id
        self.tokens_done = tokens_done
        super().__init__(
            f"request {request_id} missed its {deadline_s}s deadline "
            f"({tokens_done}/{max_new_tokens} tokens generated)"
        )


class RequestCancelled(RuntimeError):
    """The request was cancelled via EngineRequest.cancel()."""

    def __init__(self, request_id, tokens_done):
        self.request_id = request_id
        self.tokens_done = tokens_done
        super().__init__(
            f"request {request_id} cancelled ({tokens_done} tokens generated)"
        )


class EngineRestarted(RuntimeError):
    """The engine restarted (or died) while this request was in flight and
    its decode state was lost; serve() answers a retriable 503."""

    def __init__(self, request_id, reason=""):
        self.request_id = request_id
        self.reason = reason
        msg = f"engine restarted while request {request_id} was in flight"
        if reason:
            msg += f" ({reason})"
        super().__init__(msg + "; retry the request")


class NonFiniteLogits(FloatingPointError):
    """This request's decode step produced non-finite logits (reference:
    engine.py:241); it errors alone, its co-batched slots are
    row-independent and go on.  serve() answers 500."""


class _StaleEngine(Exception):
    """Internal: a restart superseded the scheduler generation this thread
    was started for; abort without touching engine state or the card."""


def _not_ported(knob, item):
    return NotImplementedError(
        f"{knob} is not ported to paddle_tpu_torch yet (ROADMAP Queue 1: "
        f"{item})"
    )


class EngineRequest:
    """Handle for one submitted generation.  Lifecycle: queued ->
    prefilling -> decoding -> one of {eos, length, timeout, cancelled,
    restarted, error}, exactly once.  `on_token(tok)` is called with every
    emitted token (a raising consumer is ignored).  With `keep_logits`, the
    float32 logits row behind every emitted token is kept in `logits` (a
    list of device tensors, copies of the steps' outputs).  `spec_k` caps
    this request's draft length below the engine's (0 opts out, None = the
    engine's).  `deadline_s` is relative to submission; the absolute
    deadline is `_deadline_t` on `time.perf_counter`'s clock.  `trace` is
    the request's trace context, (trace_id, parent_span_id) strings, or
    None.  `adapter` is the resolved `lora.LoRAAdapter` (None: the base
    model) and `adapter_slot` its arena slot while bound; `session_id`
    names the request's session and `session_reused_tokens` counts the
    prompt tokens whose K/V came from cached pages.  Disaggregated serving:
    with `export_kv` the finish fills `kv_export` (the handoff payload, or
    None when the export failed); `handoff` holds an import's staged rows
    and first token until its admission; `reservation` names the
    `reserve_pages` hold the admission consumes."""

    def __init__(self, rid, prompt, max_new_tokens, temperature, eos_token_id,
                 keep_logits=False, spec_k=None, on_token=None, deadline_s=None,
                 trace=None, adapter=None, session_id=None):
        self.id = int(rid)
        self.prompt = prompt  # np.int32 [L]
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.eos_token_id = eos_token_id
        self.on_token = on_token
        self.keep_logits = bool(keep_logits)
        self.spec_k = None if spec_k is None else int(spec_k)
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.trace = (None if trace is None
                      else (str(trace[0]), str(trace[1] or "")))
        self.adapter = adapter
        self.adapter_slot = None
        self.session_id = None if session_id is None else str(session_id)
        self.session_reused_tokens = 0
        self.export_kv = False
        self.kv_export = None
        self.handoff = None
        self.reservation = None
        self.logits = []
        self.tokens = []  # generated ids (eos included when hit)
        self.finished = threading.Event()
        self.finish_reason = None  # eos|length|timeout|cancelled|restarted|error
        self.state = "queued"  # the live phase; finish_reason once terminal
        self.cancelled = False
        self.error = None
        self.ttft_s = None
        self._submit_t = None
        self._deadline_t = None  # absolute deadline (perf_counter)
        self._finish_t = None

    def cancel(self):
        """Ask the scheduler to evict this request at its next step: a
        queued request resolves without taking a slot, a slotted one has
        its slot recycled (no retrace).  Idempotent; the resolution is still
        exactly once (`finish_reason == "cancelled"`)."""
        self.cancelled = True
        return self

    def expired(self, now=None):
        if self._deadline_t is None:
            return False
        return (time.perf_counter() if now is None else now) >= self._deadline_t

    def wait(self, timeout=None):
        """Block until the request finishes; returns prompt + generated ids
        (np.int32).  Raises a TimeoutError naming the request and its live
        state when `timeout` elapses first, and re-raises the request's
        typed error (DeadlineExceeded, RequestCancelled, EngineRestarted,
        NonFiniteLogits, ...) when it resolved unsuccessfully."""
        if not self.finished.wait(timeout):
            raise TimeoutError(
                f"request {self.id} not finished after {timeout}s "
                f"(state={self.state}, {len(self.tokens)}/"
                f"{self.max_new_tokens} tokens)"
            )
        if self.error is not None:
            raise self.error
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int32)])


class ContinuousBatchingEngine:
    """Continuous-batching engine over a port `LlamaForCausalLM`: paged
    (the default, FLAGS_serve_paged_kv) or the dense slot pool.

    submit() enqueues (bounded queue -> QueueFull, deadline-aware admission
    -> DeadlineUnattainable); the scheduler -- the thread started by
    start()/serve(), or synchronous step() / run_until_idle() calls --
    evicts cancelled and expired slots, admits queued requests into free
    slots and advances every active slot one token per decode step.
    restart(), fail_all() and drain() are the fault domain's (a
    `fault.EngineSupervisor` calls the first two).  `device=None` means the
    CUDA card; the model must live on the engine's device, and with `tp` >
    1 so must every rank of `devices`.
    """

    _req_ids = itertools.count(1)  # request ids unique across engines

    def __init__(self, model, slots=None, max_len=None, prefill_buckets=None,
                 queue_depth=None, seed=0, paged=None, page_size=None,
                 pool_pages=None, prefix_cache=None, spec_k=None, lora=None,
                 decode_kernel=None, tp=None, kv_quant=None, role=None, cp=None,
                 device=None, session_max=None, devices=None):
        self.device = _fcore.resolve_device(device)
        if model.device != self.device:
            raise ValueError(
                f"model lives on {model.device}, engine on {self.device}"
            )
        flag = _fcore.flag
        paged = bool(flag("FLAGS_serve_paged_kv") if paged is None else paged)
        # typed QuantConfigError at construction, the reference's contract
        self.kv_quant = validate_kv_quant(
            flag("FLAGS_serve_kv_quant") if kv_quant is None else kv_quant,
            paged=paged,
        )
        self.role = str(flag("FLAGS_serve_role") if role is None
                        else role).strip().lower()
        self.tp = int(flag("FLAGS_serve_tp") if tp is None else tp)
        self.cp = int(flag("FLAGS_serve_cp") if cp is None else cp)
        self._check_not_ported(paged, lora, self.tp, self.cp, self.role)
        self.paged = paged
        self.session_max = int(flag("FLAGS_serve_session_max")
                               if session_max is None else session_max)
        cfg = model.config
        self._mesh = self._init_tp(model, devices)
        if lora is not None:
            # lora.arena imports this package's paging: import it here
            from ..lora.registry import target_dims

            if lora.device != self.device:
                raise ValueError(
                    f"adapter arena lives on {lora.device}, engine on "
                    f"{self.device}")
            if (lora.registry.num_layers != cfg.num_hidden_layers
                    or lora.registry.dims != target_dims(cfg)):
                raise ValueError(
                    "adapter arena's registry was built for another model "
                    "configuration")
            if self._mesh is not None:
                # column targets' B and row targets' A per rank, views of
                # the arena's rows: an upload writes every rank's shard
                lora.shard_for_tp(self._mesh)
        self._lora = lora
        # context parallelism splits the page arena: paged engines only
        if self.cp < 1:
            raise ValueError(f"cp must be >= 1, got {self.cp}")
        if self.cp > 1 and not paged:
            raise ValueError(
                f"cp={self.cp} requires the paged engine: context parallelism "
                "shards the page arena, not dense slot buffers"
            )
        if self.cp > 1 and self.role != "colocated":
            raise ValueError(
                f"cp={self.cp} with role={self.role!r}: the disaggregated "
                "handoff assumes single-shard page ownership; run cp on "
                "colocated replicas"
            )
        # speculation rides the paged scatter's scratch redirect for its
        # rejected rows: the dense pool keeps it off, as the reference does
        sk = int(flag("FLAGS_serve_spec_k") if spec_k is None else spec_k)
        if sk < 0:
            raise ValueError("spec_k must be >= 0")
        self.spec_k = sk if paged else 0
        self._spec_on = self.spec_k > 0
        # the drafters' longest n-gram, read once as the reference does
        self._spec_ngram = int(flag("FLAGS_serve_spec_ngram"))
        self.model = model
        self.slots = int(slots if slots is not None else _fcore.flag("FLAGS_serve_slots"))
        max_len = max_len if max_len is not None else cfg.max_position_embeddings
        # rope tables (so positions) top out at max_position_embeddings
        self.max_len = int(min(max_len, cfg.max_position_embeddings))
        if prefill_buckets is None:
            raw = str(_fcore.flag("FLAGS_serve_prefill_buckets"))
            prefill_buckets = [int(x) for x in raw.split(",") if x.strip()]
        self.prefill_buckets = sorted(
            {int(b) for b in prefill_buckets if 0 < int(b) < self.max_len}
        )
        if not self.prefill_buckets:
            raise ValueError("prefill_buckets must contain a value < max_len")
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else _fcore.flag("FLAGS_serve_queue_depth")
        )

        # the cache dtype follows the lm_head weight (bf16 serving stays bf16)
        cache_dtype = model.lm_head.weight.dtype
        if paged:
            self._init_paged(cfg, page_size, decode_kernel, pool_pages,
                             prefix_cache, cache_dtype)
        else:
            # the dense slot pool: no pages, no prefix cache, no paged kernel
            self.decode_kernel = "auto"
            self.page_size = self.pages_per_seq = self.pool_pages = 0
            self._arenas = self._pool = self._prefix = self._sessions = None
            with torch.no_grad():
                # under tp each layer's entry is the ranks' list of caches
                # over their kv heads, K2 per rank over its page view
                self._caches = [
                    self._shard_kv(StaticKVCache(
                        self.slots, self.max_len, cfg.num_key_value_heads,
                        cfg.head_dim, cache_dtype, self.device))
                    for _ in range(cfg.num_hidden_layers)
                ]
        self._gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._init_graphs()
        # per step at tp > 1: one reduce per row-parallel output (o_proj and
        # down_proj of every layer) and the lm_head's vocabulary gather; under
        # cp one partials merge per layer per paged attention (the
        # reference's all-reduces; torch ops on one card).  `devices` counts
        # the distinct devices in use, not the ranks
        _prof.record_mesh_topology(
            devices=len(set(self._mesh.devices)) if self._mesh is not None else 1,
            tp=self.tp, cp=self.cp,
            allreduce_per_step=(
                (2 * cfg.num_hidden_layers + 1 if self.tp > 1 else 0)
                + (cfg.num_hidden_layers if self.cp > 1 else 0)),
        )

        # host-side slot table, mutated under _mu by the scheduler
        self._slot_req = [None] * self.slots
        self._pos = np.zeros(self.slots, np.int32)
        self._last_tok = np.zeros(self.slots, np.int32)
        self._temps = np.zeros(self.slots, np.float32)
        self._drafters = [None] * self.slots  # per-slot NgramDrafter or None
        # the arena slot bound per engine slot (0 = the base model), the
        # host mirror of the steps' `adapters` input: set when a slot
        # lands, cleared at recycle
        self._slot_adapter = np.zeros(self.slots, np.int32)
        # EWMA of emitted tokens per active slot per verify step (1.0
        # without speculation, where every step emits one per slot), the
        # reference's /healthz tokens_per_step (engine.py:666, :2749)
        self._tok_rate_ewma = 1.0
        # the device-resident decode loop state: the decode (or verify)
        # graph's static inputs, reloaded from the host mirrors only when
        # slot membership changes (None until then)
        self._dev = None
        # the open decode epoch of traced members (_obs_epoch_open), or None
        self._ep = None
        # decode steps dispatched but not fetched yet: [(copy of [nxt;
        # finite] [2, S] int32, active slots, dispatch time, copy of the
        # logits or None)]
        self._pending_fetch = []

        self._queue = queue.Queue(maxsize=self.queue_depth)
        # page-deferred and restart-requeued requests, ahead of the queue
        self._requeue = []
        self._queued_new_tokens = 0  # tokens owed to queued + requeued work
        self._admitting = None  # request between queue pop and slot landing
        # decode-side page reservations: id -> (pages, expiry on the
        # perf_counter clock), and their sum; a counter against fresh
        # headroom, never pool refs (the page audit holds refs to holds)
        self._reserved = {}
        self._reserved_pages = 0
        self._cv = threading.Condition()
        self._mu = threading.RLock()  # slot table, host mirrors, requeue
        # held across each dispatch (static input copies, replay, output
        # copies) after the generation check: see _launch
        self._launch_mu = threading.Lock()
        self._thread = None
        self._stop = False

        # fault domain: the generation counter fences restarted-away
        # scheduler threads; the engine's watchdog records trips (it makes
        # no CUDA call) for the EngineSupervisor to act on
        self._generation = 0
        self._dead = False
        self._draining = False
        self.restart_count = 0
        self._watchdog = _wd.Watchdog(action=self._on_watchdog)
        self._watchdog_trip = None  # (region, deadline_s), set by the monitor
        self._last_progress = time.monotonic()
        # EWMA wall seconds per decode step, from dispatch to fetch
        self._step_ewma_s = None
        # deadline-miss rate over terminal resolutions (EWMA): 1 for a
        # timeout eviction, 0 for a normal finish
        self._miss_ewma = 0.0

    def _init_paged(self, cfg, page_size, decode_kernel, pool_pages,
                    prefix_cache, cache_dtype):
        """Page geometry, per-layer arenas, page pool, prefix cache and page
        tables of the paged engine."""
        flag = _fcore.flag
        head_dim = cfg.head_dim
        ps = int(page_size if page_size is not None
                 else flag("FLAGS_serve_kv_page_size"))
        # a page never needs to exceed a sequence
        self.page_size = max(1, min(ps, self.max_len))
        self.pages_per_seq = -(-self.max_len // self.page_size)
        # sequence page k lives on shard k % cp: the table width pads to a
        # cp multiple, so shard s's local table is columns s, s + cp, ...
        self.pages_per_seq = -(-self.pages_per_seq // self.cp) * self.cp
        dk = str(flag("FLAGS_serve_decode_kernel")
                 if decode_kernel is None else decode_kernel)
        if dk not in ("auto", "fused", "gather"):
            raise ValueError(f"decode_kernel must be auto|fused|gather, got {dk!r}")
        # "auto" is the reference flag's default; with no silent fallback in
        # the port it is an alias of "fused"
        dk = "fused" if dk == "auto" else dk
        if dk == "fused" and head_dim > MAX_HEAD_DIM:
            raise ValueError(
                f"decode_kernel={dk!r} runs the fused kernel, which needs "
                f"head_dim <= {MAX_HEAD_DIM}; got head_dim={head_dim}"
            )
        self.decode_kernel = dk
        pp = int(pool_pages if pool_pages is not None
                 else flag("FLAGS_serve_kv_pool_pages"))
        dtype_bytes = cache_dtype.itemsize
        page_bytes = kv_page_bytes(self.page_size, cfg.num_key_value_heads,
                                   head_dim, dtype_bytes, self.kv_quant)
        if pp <= 0:  # auto: every slot can hold a max_len sequence
            # per shard: pages_per_seq / cp pages of every slot plus its
            # scratch page (cp = 1: slots * pages_per_seq + 1)
            pp = self.cp * (self.slots * (self.pages_per_seq // self.cp) + 1)
            if self.kv_quant == "int8":
                # the same bytes as the full-precision pool, more pages
                full = kv_page_bytes(self.page_size, cfg.num_key_value_heads,
                                     head_dim, dtype_bytes)
                pp = (self.slots * self.pages_per_seq * full) // page_bytes + 1
        if self.cp > 1:
            # equal per-shard ranges, each with its own scratch page
            pp = -(-max(pp, 2 * self.cp) // self.cp) * self.cp
        self.pool_pages = pp
        with torch.no_grad():
            # under tp each layer's entry is the ranks' list of arenas, rank
            # r's over its kv heads; page ids are the same on every rank
            self._arenas = [
                self._shard_kv(PagedKVCache(
                    pp, self.page_size, cfg.num_key_value_heads, head_dim,
                    cache_dtype, self.device, quant=self.kv_quant))
                for _ in range(cfg.num_hidden_layers)
            ]
        scale_bytes = (2 * self.page_size * cfg.num_key_value_heads * 4
                       if self.kv_quant == "int8" else 0)
        _prof.record_kv_quant(
            self.kv_quant,
            arena_bytes=cfg.num_hidden_layers * pp * (page_bytes - scale_bytes),
            scale_bytes=cfg.num_hidden_layers * pp * scale_bytes,
        )
        self._pool = PagePool(pp, shards=self.cp)
        use_prefix = bool(flag("FLAGS_serve_prefix_cache")
                          if prefix_cache is None else prefix_cache)
        self._prefix = PrefixCache(self.page_size) if use_prefix else None
        # sessions ride the prefix cache: without it `session_id` is
        # accepted and every turn re-prefills statelessly
        self._sessions = (SessionStore(capacity=self.session_max)
                          if use_prefix else None)
        # ignore sub-threshold matches: an accidental few-token overlap
        # between unrelated prompts must not move a request onto the chunk
        # prefill path (and its different first-token rounding)
        self.min_prefix_match = 8
        self._page_table = np.zeros((self.slots, self.pages_per_seq), np.int32)
        self._slot_pages = [[] for _ in range(self.slots)]
        # the handoff geometry, kept once: submit() holds payloads to it and
        # the export stamps it on the wire
        self._kv_heads = int(cfg.num_key_value_heads)
        self._head_dim = int(head_dim)
        self._kv_dtype_name = wire_dtype_name(cache_dtype)

    def _init_tp(self, model, devices):
        """Tensor-parallel serving (reference: engine.py:380-428): typed
        ShardingErrors at construction, divisibility and the device count
        first (`validate_tp`), then the model's own degree; the 'mp' mesh on
        `devices` (one per rank; None: the visible CUDA devices, each once)
        and the model's parallel layers bound to it.  Returns the mesh, or
        None at tp = 1."""
        from ..distributed import mesh as _mesh_mod
        from ..distributed.sharding import ShardingError, validate_tp
        from ..models.llama import shard_llama_for_tp

        cfg = model.config
        validate_tp(cfg, self.tp, devices)
        if self.tp == 1:
            # parallel layers (a model built with a degree, or under an
            # installed 'mp' mesh) serve as one rank, as the reference's
            # replicated layout does
            shard_llama_for_tp(model, _mesh_mod.Mesh(
                dict.fromkeys(_mesh_mod.AXIS_ORDER, 1), self.device))
            return None
        if int(getattr(cfg, "tensor_parallel_degree", 1)) != self.tp:
            raise ShardingError(
                f"engine tp={self.tp} but the model was built with "
                f"tensor_parallel_degree={getattr(cfg, 'tensor_parallel_degree', 1)}: "
                "construct the model with LlamaConfig(tensor_parallel_degree="
                f"{self.tp}) so its projections are the column/row-parallel "
                "layers the mesh shards"
            )
        mesh = _mesh_mod.serving_mesh(self.tp, devices=devices)
        shard_llama_for_tp(model, mesh)
        return mesh

    def _shard_kv(self, cache):
        """One layer's KV cache as the engine keeps it: the cache itself, or
        under tp the ranks' list of shards (`paging.shard_kv_for_tp`)."""
        return cache if self._mesh is None else shard_kv_for_tp(cache, self._mesh)

    def _flat_arenas(self):
        """Every rank's arena of every layer (the whole-page operations)."""
        return [a for x in self._arenas for a in (x if isinstance(x, list) else [x])]

    @staticmethod
    def _per_rank(entry, fn):
        """fn over a layer's cache entry: of each rank's under tp."""
        return [fn(x) for x in entry] if isinstance(entry, list) else fn(entry)

    @staticmethod
    def _check_not_ported(paged, lora, tp, cp, role):
        if role not in ("colocated", "prefill", "decode"):
            raise ValueError(
                f"role must be colocated|prefill|decode, got {role!r}")
        if not paged:
            # the reference's dense pool: the paged-only features refuse
            if lora is not None:
                raise ValueError("LoRA serving requires the paged engine")
            if role != "colocated":
                raise ValueError(
                    f"role={role!r} requires the paged engine: the "
                    "prefill->decode handoff rides the page arenas"
                )
        if tp > 1 and cp > 1:
            raise _not_ported(
                f"tp={tp} with cp={cp}",
                "item 15b, tensor x context parallelism: K5 per head shard")
        if tp > 1 and role != "colocated":
            raise _not_ported(
                f"tp={tp} with role={role!r}",
                "item 15c, tensor parallelism with disaggregated roles")

    # -- compiled steps ----------------------------------------------------------

    def _init_graphs(self):
        """One StepGraph per step kind, sharing one memory pool; every one
        that samples draws from (and advances) the engine's generator."""
        pool = new_pool(self.device)

        def graph(name, body):
            return StepGraph(name, body, self.device, pool, (self._gen,))

        if self.paged:
            self._prefill_g = graph("prefill", self._prefill_paged_body)
            self._chunk_g = graph("chunk_prefill", self._chunk_prefill_body)
            self._copy_g = graph("copy", self._copy_page_body)
            self._decode_g = graph("decode", self._decode_paged_body)
        else:
            self._prefill_g = graph("prefill", self._prefill_dense_body)
            self._chunk_g = self._copy_g = None
            self._decode_g = graph("decode", self._decode_dense_body)
        self._verify_g = graph("verify", self._verify_body) if self._spec_on else None
        # the handoff import: decode-role engines only, so the other roles'
        # compile_counts() keep their keys
        self._import_g = (graph("import", self._import_page_body)
                          if self.paged and self.role == "decode" else None)

    def step_graphs(self):
        """The engine's executables by compile_counts() key."""
        out = {"prefill": self._prefill_g, "decode": self._decode_g}
        if self.paged:
            out["chunk_prefill"] = self._chunk_g
            out["copy"] = self._copy_g
        if self._import_g is not None:
            out["import"] = self._import_g
        if self._spec_on:
            out["verify"] = self._verify_g
        return out

    def compile_counts(self):
        """{prefill, decode} trace counts, plus chunk_prefill and copy when
        paged, import on a decode-role engine and verify under speculation
        (the reference's keys, engine.py:1366-1392): prefill == buckets
        used, chunk_prefill == buckets warmed, decode, copy, import and
        verify == 1, and no new trace under traffic.  `aot_hits` is 0: the port keeps no executable cache."""
        out = {k: g.trace_count for k, g in self.step_graphs().items()}
        out["aot_hits"] = 0
        return out

    def graph_pool_bytes(self):
        """Device memory reserved while capturing the engine's graphs (0 on
        the CPU)."""
        return sum(g.pool_bytes for g in self.step_graphs().values())

    def _sample(self, logits, temps):
        """Next tokens [N] int32 of float32 logits [N, V] at device
        temperatures temps [N] (the reference's sampler, engine.py:752):
        the greedy argmax and a draw from softmax(logits / temp) are both
        computed and where(temps > 0) picks one, so greedy against sampled
        is data.  The draw is the exponential race argmax(logits / temp -
        log E), E ~ Exp(1) from the engine's generator: no host sync."""
        greedy = logits.argmax(dim=-1)
        e = torch.empty_like(logits).exponential_(generator=self._gen)
        samp = (logits / temps.clamp_min(1e-6)[:, None] - e.log()).argmax(dim=-1)
        return torch.where(temps > 0, samp, greedy).to(torch.int32)

    def _prefill_tail(self, hidden, true_len, temp):
        """(first token [1], logits [1, V] float32) of the row true_len - 1
        (a [1] device tensor), not the bucket end."""
        last = hidden.index_select(1, (true_len - 1).long())[:, 0]
        logits = self.model.logits(last).float()
        return self._sample(logits, temp), logits

    def _lora_view(self, adapters):
        """The arena's view of a step's `adapters` input (arena slots, int32
        data), or None on an engine without LoRA."""
        return None if adapters is None else self._lora.view(adapters)

    @torch.no_grad()
    def _prefill_paged_body(self, toks, table, true_len, temp, adapters=None):
        """Fresh paged prefill of one bucket (reference:
        `_prefill_paged_body`, engine.py:917): toks [1, bucket], its K/V
        scattered into the pages of table [P]; true_len [1] int32, temp [1]
        float32; under LoRA adapters [1] int32, the request's arena slot."""
        views = [self._per_rank(a, lambda x: PagedPrefillView(
                     x, table, true_len, self.max_len, kernel=self.decode_kernel,
                     cp=self.cp))
                 for a in self._arenas]
        hidden = self.model.llama(toks, caches=views,
                                  lora=self._lora_view(adapters))
        return self._prefill_tail(hidden, true_len, temp)

    @torch.no_grad()
    def _chunk_prefill_body(self, toks, table, true_len, start, temp, loc=None,
                            base=None, adapters=None):
        """Chunk prefill of a prefix-cache hit's suffix (reference:
        `_chunk_prefill_body`, engine.py:956): suffix row 0 sits at start
        [1] and the rows attend the shared pages; under cp through the
        row's stacked local tables loc [cp, 1, P/cp] and base [cp, P/cp].
        The shared pages were committed under the request's own adapter
        (the cache keys chains by adapter), so `adapters` [1] applies to
        the suffix rows alone."""
        local = None if loc is None else (loc, base)
        views = [self._per_rank(a, lambda x: PagedPrefillView(
                     x, table, true_len, self.max_len, start=start,
                     kernel=self.decode_kernel, cp=self.cp, local=local))
                 for a in self._arenas]
        hidden = self.model.llama(toks, caches=views,
                                  lora=self._lora_view(adapters))
        return self._prefill_tail(hidden, true_len, temp)

    @torch.no_grad()
    def _prefill_dense_body(self, toks, slot, true_len, temp):
        """The dense pool's prefill (reference: `_prefill_body`,
        engine.py:770): the bucket's K/V rows land in pool row slot [1]."""
        views = [self._per_rank(c, lambda x: SlotView(x, slot))
                 for c in self._caches]
        return self._prefill_tail(self.model.llama(toks, caches=views),
                                  true_len, temp)

    @torch.no_grad()
    def _copy_page_body(self, src, dst):
        """Copy-on-write (reference: `_copy_page_body`, engine.py:999):
        arena page src [1] into dst [1] across every layer's K and V, and
        their scale rows under int8 (a copy without them would dequantize
        the reader's tail wrongly, silently)."""
        src, dst = src.long(), dst.long()
        for a in self._flat_arenas():
            for t in (a.k, a.v, a.k_scale, a.v_scale):
                if t is not None:
                    t.index_copy_(0, dst, t.index_select(0, src))
        return ()

    @torch.no_grad()
    def _import_page_body(self, k_tiles, v_tiles, dst, k_scale_tiles=None,
                          v_scale_tiles=None):
        """The handoff import (reference: `_import_page_body`,
        engine.py:1024-1075): one page of shipped prompt rows into arena
        page dst [1] across every layer.  k_tiles/v_tiles [n_layers,
        page_size, kv_heads, head_dim] (int8 under int8 pages, with their
        float32 scale tiles [n_layers, page_size, kv_heads, 1]); a partial
        last page arrives padded, its padding rows past the slot's pos."""
        dst = dst.long()
        tiles = {"k": k_tiles, "v": v_tiles, "k_scale": k_scale_tiles,
                 "v_scale": v_scale_tiles}
        for i, a in enumerate(self._arenas):
            for name, t in tiles.items():
                if t is not None:
                    getattr(a, name).index_copy_(0, dst, t[i:i + 1])
        return ()

    def _paged_views(self, tables, local):
        return [
            self._per_rank(a, lambda x: PagedDecodeView(
                x, tables, self.max_len, kernel=self.decode_kernel, cp=self.cp,
                local=local))
            for a in self._arenas
        ]

    def _decode_tail(self, views, toks, pos, active, temps, poison, lora=None):
        """The decode step on `views` (reference: `_decode_body`,
        engine.py:730): toks [S, 1], pos [S], active [S] bool, temps [S],
        poison [S] bool (the `serve.decode.nan` drill: a poisoned slot's
        logits become NaN before the finite check; all-False, it changes
        no bit), `lora` the arena view of the slots' adapters or None.
        Inactive slots run at pos 0.  Writes the next tokens into
        toks and the advanced positions (active slots only) into pos, so
        the next step reads them where they are.  Returns (next tokens [S]
        int32, finite [S] bool: every logit finite or the slot inactive,
        logits [S, V] float32)."""
        pos_eff = torch.where(active, pos, torch.zeros_like(pos))
        hidden = self.model.llama(toks, caches=views, pos=pos_eff, lora=lora)
        logits = self.model.logits(hidden[:, -1]).float()
        logits = torch.where(poison[:, None], torch.nan, logits)
        nxt = self._sample(logits, temps)
        finite = torch.isfinite(logits).all(dim=-1) | ~active
        toks.copy_(nxt[:, None])
        pos.copy_(torch.where(active, pos + 1, pos))
        return nxt, finite, logits

    @torch.no_grad()
    def _decode_paged_body(self, toks, pos, active, temps, poison, tables,
                           loc=None, base=None, adapters=None):
        """`_decode_tail` over the paged arenas: tables [S, P] and, under cp,
        their stacked local tables loc [cp, S, P/cp], base [cp, P/cp]; under
        LoRA adapters [S] int32, each slot's arena slot (0 for the base
        model and for inactive slots).  Inactive slots run over an all-zero
        table row (scratch)."""
        local = None if loc is None else (loc, base)
        return self._decode_tail(self._paged_views(tables, local), toks, pos,
                                 active, temps, poison,
                                 lora=self._lora_view(adapters))

    @torch.no_grad()
    def _decode_dense_body(self, toks, pos, active, temps, poison):
        """`_decode_tail` over the dense pool: inactive slots write row 0 of
        their own pool row."""
        return self._decode_tail(self._caches, toks, pos, active, temps, poison)

    @torch.no_grad()
    def _verify_body(self, toks, pos, active, valid, temps, poison, tables,
                     loc=None, base=None, adapters=None):
        """Speculative verify (reference: `_verify_paged_body`,
        engine.py:846): one forward scores k + 1 rows per slot.  toks [S,
        k+1]: column 0 the committed last token (not yet in the pages; this
        window writes it), columns 1..k the drafts; valid [S] counts the
        committed token plus the real drafts (1: a plain decode row).  Row
        i writes its K/V at pos + i and attends j <= pos + i, so greedy[i]
        is the model's token after the window's first i + 1 rows.  Draft i
        is accepted iff it equals greedy[i - 1] and every earlier draft was
        accepted; the slot emits greedy[0..n_acc].  Rejected rows need no
        rollback: the next window rewrites [new_pos, new_pos + k] before
        anything attends them.  Column 0 of a sampled slot (temp > 0, always
        at valid 1) is drawn from the engine's generator.  poison [S] bool
        NaNs a slot's logits, as in `_decode_tail`.  Under LoRA every row of
        a slot's window gathers that slot's `adapters` entry, as a decode
        row does, so the greedy tokens drafts are held against are the
        adapter's own (reference: engine.py:864-866).  Advances pos by n_emit
        in place.  Returns (out [S, k+1] int32, n_emit [S] int32,
        finite [S] bool over the emitted rows, logits [S, k+1, V]
        float32)."""
        local = None if loc is None else (loc, base)
        pos_eff = torch.where(active, pos, torch.zeros_like(pos))
        hidden = self.model.llama(toks, caches=self._paged_views(tables, local),
                                  pos=pos_eff, lora=self._lora_view(adapters))
        logits = self.model.logits(hidden).float()
        logits = torch.where(poison[:, None, None], torch.nan, logits)
        greedy = logits.argmax(dim=-1).to(torch.int32)  # [S, k+1]
        k1 = greedy.shape[1]
        drafts_ok = toks[:, 1:] == greedy[:, :-1]
        considered = (torch.arange(k1 - 1, device=toks.device)[None, :]
                      < (valid - 1)[:, None])
        n_acc = torch.cumprod((drafts_ok & considered).to(torch.int32), dim=1).sum(1)
        n_emit = torch.where(active, n_acc + 1, 0).to(torch.int32)
        out = greedy.clone()
        out[:, 0] = self._sample(logits[:, 0], temps)
        # the non-finite watch covers the emitted rows only: a rejected
        # draft's logits are thrown away
        emitted = torch.arange(k1, device=toks.device)[None, :] < n_emit[:, None]
        finite = (torch.isfinite(logits).all(dim=-1) | ~emitted).all(dim=1) | ~active
        pos.add_(n_emit)
        return out, n_emit, finite, logits

    def _local_tables(self, table):
        """`cp_stacked_tables` of a host page table (np.int32 [rows, P]):
        [cp, rows, P/cp] local tables and [cp, P/cp] page_base, host
        tensors, each shard's entries bound-checked against its page range
        (the kernel indexes the shard's arena slice by the raw entry).  They
        reach the card once per table upload, in a graph's static inputs,
        shared by every layer's one-launch K5; None at cp=1."""
        if self.cp == 1:
            return None
        local = self._host_local_tables(table)
        return tuple(torch.stack(x) for x in zip(*local))

    def _host_local_tables(self, table):
        """`cp_local_tables` of a host page table, bound-checked per shard."""
        local = cp_local_tables(torch.from_numpy(table), self.cp,
                                self._pool.per_shard, self.page_size)
        for loc, _ in local:
            check_table_bounds(loc.numpy(), self._pool.per_shard)
        return local

    def _table_inputs(self, table):
        """A step's table inputs for the host page table `table` ([rows, P]):
        `tables` (its bounds checked), and `loc`/`base` under cp."""
        check_table_bounds(table, self.pool_pages)
        out = {"tables": np.ascontiguousarray(table, np.int32)}
        if self.cp > 1:
            out["loc"], out["base"] = self._local_tables(table)
        return out

    def _run_prefill(self, toks, true_len, temp, table=None, slot=None,
                     start=None, adapter_slot=0):
        """One bucket-padded prefill chunk toks [1, bucket] (np.int32)
        through its executable: into the pages of `table` (np.int32 [P],
        paged), fresh or, with `start` (the matched prefix length), the
        chunk prefill of a prefix-cache hit; or into dense pool row `slot`.
        Under LoRA `adapter_slot` is the request's arena slot.  Returns the
        static (first token [1], logits [1, V]) outputs."""
        bucket = toks.shape[1]
        inp = {"toks": toks, "true_len": np.full(1, true_len, np.int32),
               "temp": np.full(1, temp, np.float32)}
        if not self.paged:
            return self._prefill_g(bucket, slot=np.full(1, slot, np.int32), **inp)
        if self._lora is not None:
            inp["adapters"] = np.full(1, adapter_slot, np.int32)
        if start is None:
            return self._prefill_g(bucket, table=table, **inp)
        inp.update(table=table, start=np.full(1, start, np.int32))
        if self.cp > 1:
            inp["loc"], inp["base"] = self._local_tables(table[None])
        return self._chunk_g(bucket, **inp)

    def _copy_page(self, src, dst):
        self._copy_g(None, src=np.full(1, src, np.int32),
                     dst=np.full(1, dst, np.int32))

    def _idle_step_inputs(self):
        """Inputs of a decode (or verify) step with every slot inactive:
        all-zero tables aim every write at scratch page 0 (the dense pool:
        row 0 of each slot's own pool row)."""
        S = self.slots
        out = {"pos": np.zeros(S, np.int32), "active": np.zeros(S, bool),
               "temps": np.zeros(S, np.float32), "poison": np.zeros(S, bool)}
        if self.paged:
            out.update(self._table_inputs(np.zeros((S, self.pages_per_seq),
                                                   np.int32)))
        if self._lora is not None:  # the base passthrough row
            out["adapters"] = np.zeros(S, np.int32)
        return out

    # -- public API ------------------------------------------------------------

    def submit(self, input_ids, max_new_tokens=32, temperature=0.0,
               eos_token_id=None, keep_logits=False, spec_k=None, on_token=None,
               deadline_s=None, adapter=None, session_id=None, handoff=None,
               reservation=None, trace=None, export_kv=False):
        """Enqueue one request (1-D token ids); returns an EngineRequest at
        once.  `on_token(tok)` streams each emitted token (the scheduler
        then fetches every decode step at once).  Raises ContextOverflow
        when the prompt does not fit max_len, QueueFull when the queue is
        at capacity or the request's page need exceeds the pool (under cp:
        a shard's share of it exceeds the shard), DeadlineUnattainable when
        `deadline_s` cannot beat the current queue-drain estimate, and
        EngineUnavailable while draining or after the restart budget is
        spent (reference: engine.py:1077-1250).  `trace` is the request's
        trace context (trace_id, parent_span_id): under FLAGS_trace its
        engine.* spans hang under that parent.  `spec_k` caps the
        request's draft length below the engine's (0 opts out).  Ids
        outside [0, vocab_size) raise ValueError: on the card an
        out-of-range embedding row is a device-side assert that poisons the
        CUDA context for every later step, where the reference's JAX gather
        clamps.

        `adapter` names a registered LoRA adapter (name or stable id; None
        or 0 = the base model): an unknown one raises AdapterUnknown (the
        typed 404 of serve()) before the request queues, one whose rank
        exceeds the arena's rank_max a ValueError, and so does any adapter
        on an engine without `lora=` (the reference's errors,
        engine.py:1124-1140).  `session_id` names a KV session: the request
        chunk-prefills only the suffix past the session's pinned pages, and
        at its finish (eos or length) the whole committed sequence is bound
        so the next turn resumes from it; without a prefix cache every turn
        re-prefills statelessly.

        Disaggregated serving (reference: engine.py:1078-1232):
        `export_kv=True` (paged engines; else ValueError) fills the
        request's `kv_export` at its finish.  `handoff` carries such a
        payload into a paged decode-role engine (a ValueError elsewhere,
        and with an adapter or a session): it is deserialized, held to the
        arena's geometry, the prompt's length and a first token in the
        vocabulary (HandoffFormatError otherwise) and staged on the host
        before the request queues; the admission imports it instead of
        prefilling.  `reservation` names a `reserve_pages` hold that the
        admission consumes (an unknown or expired one is a no-op).
        `deadline_s` <= 0 raises ValueError."""
        raw = np.asarray(input_ids).reshape(-1)
        if raw.size == 0:
            raise ValueError("empty prompt")
        if raw.dtype.kind not in "iu":  # floats, bools, ints past int64
            raise ValueError(f"input_ids must be integers, got {raw.dtype}")
        vocab = self.model.config.vocab_size
        bad = (raw < 0) | (raw >= vocab)
        if bad.any():
            raise ValueError(
                f"token id {raw[bad][0]} outside the vocabulary [0, {vocab})"
            )
        ids = raw.astype(np.int32)
        if ids.size >= self.max_len:
            raise ContextOverflow(
                ids.size, self.max_len, cp=self.cp,
                pages_per_shard=self.pages_per_seq // self.cp if self.paged else 0,
                page_size=self.page_size if self.paged else 0,
            )
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError("deadline_s must be > 0")
        if spec_k is not None and int(spec_k) < 0:
            raise ValueError("spec_k must be >= 0")
        adapter_obj = None
        if adapter is not None and adapter != 0:
            if self._lora is None:
                raise ValueError(
                    "engine has no LoRA arena (construct with lora=) but "
                    f"request named adapter {adapter!r}"
                )
            # resolved now: an unknown name is terminal (AdapterUnknown, the
            # HTTP 404), a known one is held against the arena's rank cap
            adapter_obj = self._lora.registry.resolve(adapter)
            if adapter_obj.rank > self._lora.rank_max:
                raise ValueError(
                    f"adapter {adapter_obj.name!r} rank {adapter_obj.rank} "
                    f"exceeds the arena rank_max {self._lora.rank_max}"
                )
        if export_kv and not self.paged:
            raise ValueError(
                "export_kv requires the paged engine (the handoff payload is "
                "the committed page rows)")
        if export_kv and self.tp > 1:
            raise _not_ported(
                f"export_kv at tp={self.tp}",
                "item 15c, tensor parallelism with disaggregated roles")
        staged = None
        if handoff is not None:
            # typed refusals before the request queues: a wrong role, a
            # foreign geometry or corrupt rows never reach a compiled step
            if not (self.paged and self.role == "decode"):
                raise ValueError(
                    "handoff import requires a paged engine in the 'decode' "
                    f"role (this engine: paged={self.paged}, role={self.role!r})")
            if adapter_obj is not None:
                raise ValueError(
                    "handoff requests cannot name a LoRA adapter: the prefill "
                    "worker's exported KV embeds no adapter deltas")
            if session_id is not None:
                raise ValueError(
                    "session_id cannot combine with a KV handoff import: "
                    "sessions live on the prefill-owning replica's pages")
            staged = self._stage_handoff(handoff, ids.size)
        if self._dead:
            raise EngineUnavailable(
                "engine is dead (restart budget exhausted); restart the server")
        if self._draining:
            raise EngineUnavailable("engine is draining (shutdown in progress)",
                                    retry_after_s=self.estimate_drain_s())
        if deadline_s is not None:
            est = self.estimate_drain_s()
            if est > float(deadline_s):
                _prof.record_serving_fault("rejected_deadline")
                _flight.record("admission", "rejected_deadline",
                               deadline_s=float(deadline_s),
                               drain_est_s=round(est, 3))
                raise DeadlineUnattainable(
                    f"deadline {deadline_s}s cannot beat the current "
                    f"queue-drain estimate {est:.2f}s",
                    retry_after_s=est,
                )
        # sequence page k comes only from shard k % cp: the fullest shard
        # must hold ceil(need / cp) of its per_shard - 1 usable pages
        need = self._pages_for(ids.size, max_new_tokens) if self.paged else 0
        if self.paged and -(-need // self.cp) > self._pool.per_shard - 1:
            raise QueueFull(
                f"request needs {need} KV pages (prompt {ids.size} + max_new "
                f"{max_new_tokens} at page size {self.page_size}) but the "
                f"pool holds {self._pool.usable_pages}"
                + (f" across cp={self.cp} shards" if self.cp > 1 else ""),
                retry_after_s=self._shed_retry_after(deadline_s),
            )
        req = EngineRequest(next(self._req_ids), ids, max_new_tokens,
                            temperature, eos_token_id, keep_logits, spec_k,
                            on_token, deadline_s=deadline_s, trace=trace,
                            adapter=adapter_obj, session_id=session_id)
        req.export_kv = bool(export_kv)
        req.handoff = staged
        req.reservation = None if reservation is None else str(reservation)
        req._submit_t = time.perf_counter()
        if deadline_s is not None:
            req._deadline_t = req._submit_t + float(deadline_s)
        # counted before the put: the scheduler may pop it at once
        with self._mu:
            self._queued_new_tokens += req.max_new_tokens
        try:
            self._queue.put_nowait(req)
        except queue.Full:
            with self._mu:
                self._queued_new_tokens -= req.max_new_tokens
            _flight.record("admission", "queue_full",
                           queue_depth=self.queue_depth)
            raise QueueFull(
                f"admission queue full ({self.queue_depth} pending)",
                retry_after_s=self._shed_retry_after(deadline_s),
            ) from None
        with self._cv:
            self._cv.notify()
        return req

    def _stage_handoff(self, payload, prompt_len):
        """(rows, first token) of a handoff payload for this engine's
        import: the payload held to the arena's geometry and the prompt,
        its rows laid out as the import's tiles want them, `{name:
        [n_layers, pages * page_size, ...]}` host tensors (pinned on the
        card) padded past the prompt with zero rows, and 1.0 in the padding
        of the int8 scale rows (masked rows still flow through the
        attention sum and must stay finite; reference: engine.py:2484)."""
        layers, L = deserialize_kv_handoff(
            payload, self.kv_quant, self._kv_heads, self._head_dim,
            len(self._arenas), self._kv_dtype_name)
        if L != int(prompt_len):
            raise HandoffFormatError(
                f"handoff prompt_len {L} != submitted prompt length "
                f"{int(prompt_len)}")
        first = payload.get("first_token")
        if first is None:
            raise HandoffFormatError(
                "handoff payload missing first_token (the prefill worker's "
                "sampled token)")
        first = int(first)
        if not 0 <= first < self.model.config.vocab_size:
            # on the card an out-of-vocabulary embedding row poisons the
            # CUDA context (see the prompt's check above)
            raise HandoffFormatError(
                f"handoff first_token {first} outside the vocabulary [0, "
                f"{self.model.config.vocab_size})")
        rows = -(-L // self.page_size) * self.page_size
        pin = self.device.type == "cuda"
        staged = {}
        for name, t in layers[0].items():
            buf = torch.full((len(layers), rows) + tuple(t.shape[1:]),
                             1.0 if name.endswith("_scale") else 0,
                             dtype=t.dtype, pin_memory=pin)
            for i, ly in enumerate(layers):
                buf[i, :L] = ly[name]
            staged[name] = buf
        return staged, first

    def generate(self, input_ids, max_new_tokens=32, temperature=0.0,
                 eos_token_id=None, timeout=None, adapter=None):
        """Submit and wait; drives the scheduler inline when no thread runs.
        Returns prompt + generated ids (np.int32)."""
        req = self.submit(input_ids, max_new_tokens=max_new_tokens,
                          temperature=temperature, eos_token_id=eos_token_id,
                          adapter=adapter)
        if self._thread is None:
            self.run_until_idle()
        return req.wait(timeout)

    def warmup(self):
        """Trace every executable before traffic (reference: engine.py:1266):
        each prefill bucket (and, paged, its chunk prefill), the COW copy,
        a decode-role engine's import, the decode step and, under
        speculation, the verify step, on dummy data.  On the card a trace builds the kernels, warms the matmul
        library and captures the step's CUDA graph.  All-zero tables aim
        every write at scratch page 0; the dense pool's warmup writes slot
        0's rows, which its next real prefill rewrites before any of them
        is attended."""
        P = self.pages_per_seq
        zero_row = np.zeros(P, np.int32)
        for b in self.prefill_buckets:
            toks = np.zeros((1, b), np.int32)
            if self.paged:
                self._run_prefill(toks, b, 0.0, table=zero_row)
                self._run_prefill(toks, b, 0.0, table=zero_row, start=0)
            else:
                self._run_prefill(toks, b, 0.0, slot=0)
        if self.paged:
            self._copy_page(0, 0)  # scratch onto itself
        if self._import_g is not None:
            # zero tiles onto scratch page 0 (reference: engine.py:1296):
            # no live sequence maps it
            tile = (len(self._arenas), self.page_size, self._kv_heads)
            elem = self._arenas[0].k.dtype
            inp = {"k_tiles": torch.zeros(tile + (self._head_dim,), dtype=elem),
                   "v_tiles": torch.zeros(tile + (self._head_dim,), dtype=elem)}
            if self.kv_quant == "int8":
                inp["k_scale_tiles"] = torch.ones(tile + (1,))
                inp["v_scale_tiles"] = torch.ones(tile + (1,))
            self._import_g(None, dst=np.zeros(1, np.int32), **inp)
        idle = self._idle_step_inputs()
        self._decode_g(None, toks=np.zeros((self.slots, 1), np.int32), **idle)
        if self._spec_on:
            self._verify_g(None, toks=np.zeros((self.slots, self.spec_k + 1), np.int32),
                           valid=np.ones(self.slots, np.int32), **idle)
        with self._mu:
            self._dev = None  # the traces overwrote the loop state
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    @property
    def active_slots(self):
        return sum(1 for r in self._slot_req if r is not None)

    @property
    def pending(self):
        return self._queue.qsize() + len(self._requeue)

    def has_work(self):
        """True when anything is queued, being admitted, or decoding."""
        return bool(self._queue.qsize() or self._requeue
                    or self._admitting is not None or self.active_slots)

    def estimate_drain_s(self):
        """Wall seconds until the current backlog drains (reference:
        engine.py:1408): tokens still owed to active slots plus tokens asked
        for by queued work, decoded `slots` at a time at the EWMA decode
        step time, scaled by the EWMA tokens per step.  The step time comes
        from the flushes (dispatch of the first pending step to the end of
        the fetch, over the steps fetched), not from the dispatch time that
        `record_serving_tick` keeps, which reads ~0 with decode in flight.
        0 before any evidence (admit everything)."""
        ew = self._step_ewma_s
        if not ew:
            return 0.0
        with self._mu:
            active = sum(max(0, r.max_new_tokens - len(r.tokens))
                         for r in self._slot_req if r is not None)
            queued = max(0, self._queued_new_tokens)
        if not (active or queued):
            return 0.0
        rate = max(1e-6, self._tok_rate_ewma)
        return math.ceil((active + queued) / (max(1, self.slots) * rate)) * ew

    def _shed_retry_after(self, deadline_s):
        """Retry-After of a QueueFull: the drain estimate, clamped by the
        request's own deadline (a client is never told to retry after its
        deadline has passed)."""
        est = self.estimate_drain_s()
        if deadline_s is not None:
            return min(est, float(deadline_s))
        return est

    def healthz(self):
        """Snapshot for serve()'s /healthz (reference: engine.py:1442):
        status dead (restart budget spent), draining, ready (scheduler
        thread alive) or live, occupancy, queue depth, restarts, the
        queue-drain estimate, the EWMA decode step time, the deadline-miss
        rate and the serving layout; the role and the pages held by live
        reservations (`page_free_frac` is net of them: the router must see
        a pending handoff's pages as gone); with a session store its
        `stats()` under "sessions", with an adapter arena its `stats()` and
        resident adapter names under "lora" (reference:
        engine.py:1442-1525)."""
        t = self._thread
        if self._dead:
            status = "dead"
        elif self._draining:
            status = "draining"
        elif t is not None and t.is_alive():
            status = "ready"
        else:
            status = "live"
        if self.paged:
            page_free = (max(0, self._pool.free_count() - self._reserved_pages)
                         / max(1, self._pool.usable_pages))
        else:  # the reference's dense figure: free slots
            page_free = (self.slots - self.active_slots) / self.slots
        ew = self._step_ewma_s
        out = {
            "status": status,
            "slots": self.slots,
            "active_slots": self.active_slots,
            "occupancy": self.active_slots / self.slots,
            "queue_depth": self.pending,
            "restarts": self.restart_count,
            "drain_estimate_s": round(self.estimate_drain_s(), 3),
            "page_free_frac": round(page_free, 4),
            "prefix_cache_size": len(self._prefix) if self._prefix is not None else 0,
            "decode_ewma_ms": round(ew * 1e3, 3) if ew else 0.0,
            "tokens_per_step": round(self._tok_rate_ewma, 3),
            "deadline_miss_rate": round(self._miss_ewma, 4),
            "kv_quant": self.kv_quant,
            "role": self.role,
            "reserved_pages": int(self._reserved_pages),
            "device": str(self.device),
            "tp": self.tp,
            "cp": self.cp,
            # the reference keeps only the mesh axes larger than 1
            "mesh_shape": (
                {a: n for a, n in self._mesh.shape.items() if n > 1}
                if self._mesh is not None
                else {"cp": self.cp} if self.cp > 1 else {}),
        }
        if self.cp > 1:
            # the fullest shard bounds admission: a sequence page lands only
            # on its own shard, so the pool-wide sum would flatter
            out["page_free_by_shard"] = [self._pool.free_count(sh)
                                         for sh in range(self.cp)]
        if self._sessions is not None:
            out["sessions"] = self._sessions.stats()
        if self._lora is not None:
            lora = dict(self._lora.stats())
            lora["adapters"] = self._lora.resident()
            out["lora"] = lora
        return out

    # -- disaggregated serving: decode-side page reservations ------------------

    _rsv_ids = itertools.count(1)  # reservation ids unique across engines

    def reserve_pages(self, prompt_len, max_new_tokens, ttl_s=None):
        """Hold decode-side headroom for a handoff before its prefill starts
        elsewhere, so that a finished prefill never strands (reference:
        engine.py:1528-1566).  Returns {"reservation": "rsv-<n>", "pages",
        "ttl_s"}; raises QueueFull when the request's worst-case pages
        exceed the unreserved fresh headroom, EngineUnavailable on a dense,
        draining or dead engine.  The hold pins no page and takes no pool
        ref; it lapses after `ttl_s` (FLAGS_serve_reserve_ttl_s when None),
        so a router that dies mid-handoff costs headroom for that long."""
        if not self.paged:
            raise EngineUnavailable("page reservations require the paged engine")
        if self._dead:
            raise EngineUnavailable(
                "engine is dead (restart budget exhausted); restart the server")
        if self._draining:
            raise EngineUnavailable("engine is draining (shutdown in progress)",
                                    retry_after_s=self.estimate_drain_s())
        need = self._pages_for(int(prompt_len), int(max_new_tokens))
        ttl = float(_fcore.flag("FLAGS_serve_reserve_ttl_s")
                    if ttl_s is None else ttl_s)
        with self._mu:
            self._purge_reservations_locked()
            head = min(self._page_fresh_headroom_by_shard_locked(()))
            if need > head:
                raise QueueFull(
                    f"cannot reserve {need} KV pages (prompt {prompt_len} + "
                    f"max_new {max_new_tokens}): only {max(0, head)} unreserved "
                    "pages of headroom",
                    retry_after_s=self.estimate_drain_s())
            rid = f"rsv-{next(self._rsv_ids)}"
            self._reserved[rid] = (need, time.perf_counter() + ttl)
            self._reserved_pages += need
        _flight.record("disagg", "reserve", rid=rid, pages=need)
        return {"reservation": rid, "pages": int(need), "ttl_s": ttl}

    def _purge_reservations_locked(self, now=None):
        """Drop the expired reservations, returning their headroom.  Caller
        holds _mu."""
        if not self._reserved:
            return
        now = time.perf_counter() if now is None else now
        for rid in [r for r, (_, exp) in self._reserved.items() if exp <= now]:
            n, _ = self._reserved.pop(rid)
            self._reserved_pages -= n
            _flight.record("disagg", "reserve_expired", rid=rid, pages=n)

    def _consume_reservation_locked(self, req):
        """Release the request's reservation (its admission is here, or it
        resolved without one).  Idempotent: an unknown or expired id is a
        no-op, and the request competes for headroom unreserved.  Caller
        holds _mu."""
        rid, req.reservation = req.reservation, None
        ent = self._reserved.pop(rid, None) if rid is not None else None
        if ent is not None:
            self._reserved_pages -= ent[0]

    def step(self, gen=None):
        """One scheduling tick: evict cancelled and expired slots, admit
        queued requests into free slots (bucketed prefill), then advance
        every active slot one token.  Returns the tokens emitted.  Do not
        mix with start()."""
        gen = self._generation if gen is None else gen
        self._evict_expired(gen)
        emitted = self._admit(gen)
        emitted += (self._decode_once_spec(gen) if self._spec_on
                    else self._decode_once(gen))
        if _fcore.flag("FLAGS_serve_debug_invariants"):
            self._check_invariants()
        self._last_progress = time.monotonic()
        return emitted

    def run_until_idle(self):
        """Drive step() until queue and slots are empty.  The last step of
        every request flushes (its length bound is within reach), so
        nothing is left pending; a flush here would only catch a leak."""
        total = 0
        while not self._dead and self.has_work():
            total += self.step()
        if self._pending_fetch:
            with self._mu:
                self._flush_pending_locked()
        return total

    def start(self):
        """Run the scheduler on a daemon thread (serve() calls this)."""
        if self._thread is not None:
            return self
        self._stop = False
        t = threading.Thread(target=self._loop, name="cb-engine", daemon=True)
        t.start()
        # published once it runs: an EngineSupervisor poll takes a thread
        # that is not alive, with no stop asked, for a dead scheduler
        self._thread = t
        return self

    def stop(self, timeout=30.0):
        """Stop the scheduler thread (bounded join; a thread that does not
        stop in time is abandoned behind the generation fence), then flush
        the pending decode steps, so that a stop racing an in-flight step
        leaves no dispatched token unemitted (reference: engine.py:1643).
        The prefix cache keeps its pages: a restarted scheduler finds them
        warm."""
        t = self._thread
        if t is not None:
            self._stop = True
            with self._cv:
                self._cv.notify_all()
            t.join(timeout)
            if t.is_alive():
                logger.error("engine scheduler did not stop within %.1fs; "
                             "abandoning the thread", timeout)
                with self._mu:
                    self._generation += 1
            self._thread = None
        with self._mu:
            try:
                self._flush_pending_locked()
            except _StaleEngine:
                pass
            except Exception:
                logger.exception("engine stop: pending-token flush failed")

    def drain(self):
        """Stop admitting (submit raises EngineUnavailable, serve() sheds
        with 503 + Retry-After); in-flight work keeps decoding."""
        self._draining = True
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    # -- fault domain: restart / fail-all -------------------------------------

    def _on_watchdog(self, region, elapsed):
        # the watchdog's action, on its monitor thread: record the trip
        # (host state only, no CUDA call); the supervisor restarts the engine
        self._watchdog_trip = (region, elapsed)

    def _wd_timeout(self):
        return float(_fcore.flag("FLAGS_serve_step_timeout_sec"))

    def _check_gen(self, gen):
        if gen != self._generation:
            raise _StaleEngine(
                f"scheduler generation {gen} superseded by {self._generation}")

    @contextlib.contextmanager
    def _launch(self, gen):
        """The fence around one dispatch: the launch lock, then the
        generation check, held across the static input copies, the replay
        and the copies of its outputs.  A thread of a superseded generation
        raises _StaleEngine here, before it copies or replays anything."""
        with self._launch_mu:
            self._check_gen(gen)
            yield

    def _acquire_launch_lock(self):
        """restart()'s bounded take of the launch lock: 1 s, or as long as a
        capture is in progress (up to _CAPTURE_WAIT_S), since another
        thread's launches would break it.  A lock never released (a
        dispatch wedged in the driver) is given up on: the generation fence
        still stops that thread at its next state touch."""
        if self._launch_mu.acquire(timeout=1.0):
            return True
        t_end = time.monotonic() + _CAPTURE_WAIT_S
        while (any(g.tracing for g in self.step_graphs().values())
               and time.monotonic() < t_end):
            if self._launch_mu.acquire(timeout=1.0):
                return True
        return False

    def _reset_slots_locked(self):
        """Every slot freed on the host (its page mappings released; the
        pool and the prefix cache stay), the device loop state dropped for
        a reload from the host mirrors.  Caller holds _mu (or gave up on
        it); no CUDA call."""
        for s in range(self.slots):
            self._slot_req[s] = None
            self._release_slot_pages_locked(s)
        self._slot_adapter[:] = 0
        self._pos[:] = 0
        self._last_tok[:] = 0
        self._temps[:] = 0.0
        # drafters rebuild at re-admission from prompt + first token
        self._drafters = [None] * self.slots
        self._obs_epoch_close()
        self._dev = None
        self._pending_fetch = []

    def restart(self, reason=""):
        """Bounded warm restart (reference: engine.py:1710; the
        EngineSupervisor calls it): fence out the scheduler thread, resolve
        every in-flight request exactly once -- requeued when it emitted no
        token yet, failed with EngineRestarted when its stream had started
        -- and start a fresh scheduler on the same StepGraphs, pool and
        prefix cache (0 new traces; the pool needs no scrub, garbage rows
        are never attended), and so the sessions; the adapter arena keeps
        its residency, only the bindings of the resolved and requeued
        requests drop (a requeued one binds again at its re-admission).
        It waits for the launch lock first, so that no replay of the old
        life lands after the new life begins; then `_mu`, bounded (a thread
        wedged in a fetch may hold it).  No CUDA call."""
        launched = self._acquire_launch_lock()
        locked = self._mu.acquire(timeout=1.0)
        try:
            self._generation += 1
            old, self._thread = self._thread, None
            was_threaded = old is not None
            requeue, fail = [], []
            adm, self._admitting = self._admitting, None
            live = [adm] + list(self._slot_req)
            for req in live:
                if req is None or req.finished.is_set() or req in requeue + fail:
                    continue
                (requeue if not req.tokens else fail).append(req)
            self._release_adapters_locked(requeue + fail)
            self._reset_slots_locked()
            self._watchdog_trip = None
            self._last_progress = time.monotonic()
            for req in requeue:
                req.state = "queued"
                self._queued_new_tokens += req.max_new_tokens
            self._requeue = requeue + self._requeue
            self.restart_count += 1
        finally:
            if locked:
                self._mu.release()
            if launched:
                self._launch_mu.release()
        for req in fail:
            req.error = EngineRestarted(req.id, reason)
            self._resolve(req, "restarted")
        _inj.record_event("engine", f"restart #{self.restart_count}: {reason}")
        _prof.record_serving_fault("restarts")
        logger.warning("engine restart #%d (%s): %d request(s) requeued, %d "
                       "failed with EngineRestarted", self.restart_count,
                       reason or "?", len(requeue), len(fail))
        self._stop = False
        if was_threaded:
            self.start()
        return self

    def fail_all(self, reason=""):
        """Terminal (reference: engine.py:1794): mark the engine dead
        (submit raises EngineUnavailable) and resolve every pending request
        -- queued, admitting, slotted -- with EngineRestarted, exactly once.
        The EngineSupervisor calls it when the restart budget is spent, so
        clients get errors, never hangs.  `_mu` is taken with a bound (the
        thread stuck in a fetch of a wedged card holds it) and no CUDA call
        is made."""
        self._dead = True
        pending = []
        locked = self._mu.acquire(timeout=1.0)
        try:
            self._generation += 1  # fence out any wedged scheduler
            self._thread = None
            adm, self._admitting = self._admitting, None
            if adm is not None:
                pending.append(adm)
            pending.extend(r for r in self._slot_req if r is not None)
            pending.extend(self._requeue)
            self._requeue = []
            while True:
                try:
                    pending.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            self._queued_new_tokens = 0
            self._release_adapters_locked(pending)
            for req in pending:  # no hold outlives its request
                self._consume_reservation_locked(req)
            self._reset_slots_locked()
        finally:
            if locked:
                self._mu.release()
        for req in pending:
            if not req.finished.is_set():
                req.error = EngineRestarted(req.id, reason or "engine dead")
                self._resolve(req, "restarted")
        _inj.record_event("engine", f"fail_all: {reason} ({len(pending)} requests)")
        logger.error("engine dead (%s): %d pending request(s) failed with "
                     "EngineRestarted", reason or "?", len(pending))
        return len(pending)

    # -- scheduler ---------------------------------------------------------------

    def _loop(self):
        gen = self._generation
        while not self._stop and gen == self._generation:
            self._last_progress = time.monotonic()
            if not self.has_work():
                with self._cv:
                    if not (self._stop or self._queue.qsize() or self._requeue):
                        self._cv.wait(timeout=0.05)
                continue
            try:
                _inj.inject("serve.loop.crash", context="scheduler loop")
                self.step(gen=gen)
            except _StaleEngine:
                return  # a restart superseded this thread
            except _inj.InjectedFault as e:
                # the drill: the scheduler thread dies (not as an unhandled
                # thread exception); the supervisor sees a dead thread
                logger.error("engine scheduler crashed: %s", e)
                return
            except Exception as e:  # fail the in-flight requests, keep serving
                logger.exception("engine step failed")
                with self._mu:
                    if gen != self._generation:
                        return
                    self._pending_fetch.clear()  # their steps are void
                    for s, req in enumerate(self._slot_req):
                        if req is not None:
                            req.error = e
                            self._finish(s, req, "error")

    def _bucket_for(self, n):
        for b in self.prefill_buckets:
            if n <= b:
                return b
        # over-bucket prompt: grow a next-power-of-two bucket
        b = min(1 << (n - 1).bit_length(), self.max_len - 1)
        with self._mu:
            self.prefill_buckets.append(b)
            self.prefill_buckets.sort()
        return b

    def _pages_for(self, prompt_len, max_new):
        """Pages a request occupies over its lifetime, no prefix sharing
        assumed: positions [0, L + max_new'), max_new clamped to the
        context."""
        span = int(prompt_len) + min(int(max_new), self.max_len - int(prompt_len))
        return -(-span // self.page_size)

    def _page_fresh_headroom_by_shard_locked(self, exclude):
        """Pages fresh allocations can get on each pool shard: its free list
        plus every page there that only the prefix cache still holds
        (refcount 1: no slot maps it, and repeated leaf eviction reaches
        it), except the pages in `exclude` (a request's matched prefix
        pages, about to be mapped), less the pages live reservations hold
        (reference: engine.py:1942-1962; a handoff's admission consumes its
        own first, so the hold turns into the pages it promised; they are
        not shard-annotated, so each shard covers them all).
        Session-pinned pages count as reachable, as in the reference's
        `_page_fresh_headroom_locked` (engine.py:1928): the allocator evicts
        the LRU session to reach them, which is the pressure behaviour
        sessions promise.  Caller holds _mu."""
        free = [self._pool.free_count(sh) for sh in range(self.cp)]
        if self._prefix is not None:
            for e in self._prefix.entries():
                if self._pool.refs[e.page] == 1 and e.page not in exclude:
                    free[self._pool.shard_of(e.page)] += 1
        r = -(-self._reserved_pages // self.cp)
        return [f - r for f in free]

    def _alloc_page_locked(self, shard=0):
        """One fresh page from pool shard `shard`, evicting LRU prefix-cache
        entries on that shard under pressure.  Under cp a cached chain
        alternates shards (page k on shard k % cp), so every entry of this
        shard may be the parent of another shard's page: then the LRU leaf
        of any shard goes, which frees a page elsewhere and makes its
        parent a leaf, and the loop goes on.  When every evictable entry is
        session-pinned, the whole LRU session goes (reference:
        engine.py:1975-2000): its pins drop and its chain becomes ordinary
        LRU leaves for the next pass.  Called only after the admission
        headroom check covered the request, and repeated eviction reaches
        every page only the cache holds, so the loop ends with a page.
        Caller holds _mu."""
        while self._pool.free_count(shard) == 0:
            victim = None
            if self._prefix is not None:
                victim = self._prefix.evict_one(
                    self._pool, shard=shard if self.cp > 1 else None)
                if victim is None and self.cp > 1:
                    victim = self._prefix.evict_one(self._pool)
            if victim is not None:
                _prof.record_paging_event("cache_evictions")
                continue
            if self._sessions is not None and self._sessions.evict_lru() is not None:
                _prof.record_paging_event("session_evictions")
                _prof.record_session_stats(self._sessions.stats())
                _flight.record("session", "evicted_for_pages", shard=shard)
                continue
            raise RuntimeError(
                "KV page pool exhausted mid-admission: the headroom check "
                "should have deferred this request (accounting bug)"
            )
        return self._pool.alloc(shard)

    def _release_slot_pages_locked(self, s):
        if not self.paged:
            return
        for p in self._slot_pages[s]:
            self._pool.decref(p)
        self._slot_pages[s] = []
        self._page_table[s, :] = 0

    def _evict_expired(self, gen):
        """Evict cancelled and deadline-expired slots at step granularity
        (reference: engine.py:2032): on the host clock alone; only when a
        victim exists, flush the tokens already dispatched, then recycle
        the slot (no retrace) and resolve the request with its typed
        error."""
        with self._mu:
            self._check_gen(gen)
            now = time.perf_counter()
            if self.paged:
                self._purge_reservations_locked(now)
            victims = []
            for s, req in enumerate(self._slot_req):
                if req is None:
                    continue
                if req.cancelled:
                    victims.append((s, req, "cancelled"))
                elif req.expired(now):
                    victims.append((s, req, "timeout"))
            if not victims:
                return
            self._flush_pending_locked()  # emit what was already dispatched
            for s, req, reason in victims:
                if self._slot_req[s] is not req:
                    continue  # resolved during the flush (eos, length, nan)
                if reason == "cancelled":
                    req.error = RequestCancelled(req.id, len(req.tokens))
                else:
                    req.error = DeadlineExceeded(req.id, len(req.tokens),
                                                 req.max_new_tokens,
                                                 req.deadline_s)
                self._finish(s, req, reason)

    def _pop_request(self):
        """Next admissible request, page-deferred and restart-requeued ones
        first; a dead-on-arrival one (cancelled, or past its deadline)
        resolves without a prefill (reference: engine.py:2064).  Caller
        holds _mu."""
        while True:
            if self._requeue:
                req = self._requeue.pop(0)
            else:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    return None
            self._queued_new_tokens -= req.max_new_tokens
            if req.finished.is_set():
                continue
            if req.cancelled or req.expired():
                self._consume_reservation_locked(req)
            if req.cancelled:
                req.error = RequestCancelled(req.id, 0)
                self._resolve(req, "cancelled")
                continue
            if req.expired():
                req.error = DeadlineExceeded(req.id, 0, req.max_new_tokens,
                                             req.deadline_s)
                self._resolve(req, "timeout")
                continue
            return req

    def _admit(self, gen):
        emitted = 0
        for s in range(self.slots):
            with self._mu:
                self._check_gen(gen)
                if self._slot_req[s] is not None:
                    continue
                req = self._pop_request()
                if req is None:
                    break
                if self.paged:
                    # a handoff's reservation turns into headroom inside
                    # this critical section, just before the check below
                    self._consume_reservation_locked(req)
                if self.paged and not self._pages_admit_locked(req):
                    # page pressure: park at the head of the line (FIFO kept)
                    # until finishing slots release pages
                    self._requeue.insert(0, req)
                    self._queued_new_tokens += req.max_new_tokens
                    break
                if req.adapter is not None:
                    from ..lora.arena import AdapterArenaFull

                    # after the page check, so a parked request never holds
                    # a binding
                    try:
                        req.adapter_slot = self._lora.acquire(req.adapter)
                    except AdapterArenaFull:
                        # every arena slot is bound to in-flight work: park
                        # as page pressure does; a finishing request's
                        # release unblocks it
                        self._requeue.insert(0, req)
                        self._queued_new_tokens += req.max_new_tokens
                        break
                self._admitting = req
                req.state = "prefilling"
            try:
                if req.handoff is not None:
                    self._import_into_paged(s, req, gen)
                elif self.paged:
                    self._prefill_into_paged(s, req, gen)
                else:
                    self._prefill_into_dense(s, req, gen)
                emitted += 1
            except _StaleEngine:
                raise  # the restart owns this request now
            except Exception as e:  # fail THIS request, keep the engine alive
                logger.exception("prefill of request %d failed", req.id)
                req.error = e
                with self._mu:
                    if self._slot_req[s] is req:
                        self._finish(s, req, "error")
                    else:
                        if gen == self._generation:
                            # mapped but never landed (a restart that raced
                            # ahead released the pages and the adapter
                            # binding itself)
                            self._release_slot_pages_locked(s)
                            self._release_adapters_locked((req,))
                        self._resolve(req, "error")
            finally:
                with self._mu:
                    if self._admitting is req:
                        self._admitting = None
        return emitted

    def _pages_admit_locked(self, req):
        """Whether the fresh pages `req` needs are free or evictable now, on
        every pool shard: fresh pages land at sequence indices [coverage -
        need, coverage), index k on shard k % cp.  Pages a cache hit maps
        by incref cost no fresh allocation; the matched pages are about to
        be pinned, so they do not count as evictable either.  The scheduler
        is the only inserter and evictor, so the match holds until the
        prefill.  Caller holds _mu."""
        coverage = self._pages_for(req.prompt.size, req.max_new_tokens)
        need = coverage
        exclude = ()
        # an import maps fresh pages only
        if self._prefix is not None and req.handoff is None:
            m, fulls, tail, _ = self._prefix.lookup(
                req.prompt, adapter=self._req_adapter_id(req))
            if m >= self.min_prefix_match:
                need -= len(fulls)
                exclude = set(fulls) | ({tail} if tail is not None else set())
        by_shard = [0] * self.cp
        for k in range(coverage - need, coverage):
            by_shard[k % self.cp] += 1
        head = self._page_fresh_headroom_by_shard_locked(exclude)
        return all(n <= h for n, h in zip(by_shard, head))

    def _prefill_into_dense(self, s, req, gen):
        """Admission of one request into slot s of the dense pool: a fresh
        prefill of the bucket-padded prompt into pool row s (reference:
        engine.py:2200-2256)."""
        L = int(req.prompt.size)
        with self._mu:
            self._check_gen(gen)
            # the slot rebuild after this landing reads _last_tok: it must
            # hold every step already dispatched
            self._flush_pending_locked()
            # cache rows run out at max_len: the last writable decode row is
            # max_len - 1, giving max_len - L generatable tokens
            req.max_new_tokens = min(req.max_new_tokens, self.max_len - L)
        bucket = self._bucket_for(L)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :L] = req.prompt
        t_pf = self._obs_queued(req)
        with self._prefill_armed(req):
            with self._launch(gen):
                nxt, logits = self._run_prefill(toks, L, req.temperature, slot=s)
            tok = int(nxt[0])  # the landing fetch of the first token
        with self._mu:
            self._check_gen(gen)  # a restart during the dispatch owns req
            self._land_locked(s, req, tok, logits)
        self._obs_prefilled(req, t_pf, s, bucket, 0)

    def _obs_queued(self, req):
        """The prefill's dispatch time; records the request's engine.queue
        span (submission to now) when it is traced."""
        t_pf = time.perf_counter()
        if req.trace:
            _obs.record("engine.queue", req.trace[0], t0=req._submit_t,
                        t1=t_pf, parent_id=req.trace[1], req=req.id)
        return t_pf

    @staticmethod
    def _adapter_name(req):
        """The span attribute `adapter`: the adapter's name string, or None
        for the base model (never the adapter object)."""
        return None if req.adapter is None else req.adapter.name

    def _obs_prefilled(self, req, t_pf, s, bucket, match_len):
        """Records a traced request's engine.prefill span (engine.
        chunk_prefill after a prefix hit): dispatch to landing."""
        if req.trace:
            _obs.record(
                "engine.chunk_prefill" if match_len else "engine.prefill",
                req.trace[0], t0=t_pf, t1=time.perf_counter(),
                parent_id=req.trace[1], req=req.id, bucket=bucket, slot=s,
                prefix_match=match_len or None,
                adapter=self._adapter_name(req))

    @contextlib.contextmanager
    def _prefill_armed(self, req):
        """The watchdogged `serve.prefill` region of a prefill's dispatch
        and first-token fetch (reference: engine.py:2227, :2350), with the
        injectable hang first.  The caller's launch fence comes after the
        hang: a restart during the hang owns the request (and released its
        pages), so the woken thread copies and replays nothing."""
        with self._watchdog.arm("serve.prefill", timeout=self._wd_timeout(),
                                context=f"req {req.id}"):
            _inj.inject_hang("serve.prefill.hang", context=f"req {req.id}")
            yield

    def _land_locked(self, s, req, tok, logits):
        """A prefilled (or imported: `logits` None) request takes slot s and
        emits its first token.  Caller holds _mu."""
        req.ttft_s = time.perf_counter() - req._submit_t
        self._slot_req[s] = req
        self._pos[s] = req.prompt.size
        self._last_tok[s] = tok
        self._temps[s] = req.temperature
        self._slot_adapter[s] = req.adapter_slot or 0
        req.state = "decoding"
        self._obs_epoch_close()
        self._dev = None  # membership changed: rebuild device state
        if self._spec_on and req.temperature == 0.0 and req.spec_k != 0:
            # greedy slots draft from their own history; sampled slots ride
            # the verify step undrafted (greedy equivalence is the only
            # acceptance rule)
            self._drafters[s] = NgramDrafter(self._spec_ngram).reset(
                [int(t) for t in req.prompt] + [tok])
        if req.keep_logits and logits is not None:
            req.logits.append(logits[0].clone())  # the output is static
        self._emit(s, req, tok)

    def _prefill_into_paged(self, s, req, gen):
        """Admission of one request into slot s: prefix-cache lookup, page
        mapping (shared full pages read-only, a copy of a matched partial
        page, fresh pages for the rest), then a fresh prefill of the whole
        prompt or a chunk prefill of the unshared suffix; afterwards the
        prompt's pages are committed to the cache."""
        L = int(req.prompt.size)
        pinned = None  # COW source, kept alive across our own allocations
        with self._mu:
            self._check_gen(gen)
            # the slot rebuild after this landing reads _last_tok: it must
            # hold every step already dispatched
            self._flush_pending_locked()
            req.max_new_tokens = min(req.max_new_tokens, self.max_len - L)
            coverage = self._pages_for(L, req.max_new_tokens)
            match_len, shared_full, tail_page, tail_rows = 0, [], None, 0
            if self._prefix is not None:
                m, fp, tp, tr = self._prefix.lookup(
                    req.prompt, adapter=self._req_adapter_id(req))
                if m >= self.min_prefix_match:
                    match_len, shared_full, tail_page, tail_rows = m, fp, tp, tr
                    if tp is not None:
                        # allocating below may evict the source entry; it
                        # must survive until the copy lands
                        self._pool.incref(tp)
                        pinned = tp
            pages = []
            try:
                for p in shared_full:
                    self._pool.incref(p)
                    pages.append(p)
                # sequence page i goes to shard i % cp, the layout the cp
                # kernel reads (the COW tail page included)
                for i in range(len(shared_full), coverage):
                    pages.append(self._alloc_page_locked(i % self.cp))
            except RuntimeError:
                if match_len == 0:
                    raise
                # tiny pools: the pin itself kept the last evictable page
                # alive.  Fall back to a fresh prefill; the admission check
                # covered the request without any sharing
                for p in pages:
                    self._pool.decref(p)
                if pinned is not None:
                    self._pool.decref(pinned)
                    pinned = None
                match_len, shared_full, tail_page, tail_rows = 0, [], None, 0
                pages = [self._alloc_page_locked(i % self.cp)
                         for i in range(coverage)]
            copy_args = None
            if match_len and tail_rows > 0:
                copy_args = (tail_page, pages[len(shared_full)])
            self._page_table[s, :] = 0
            self._page_table[s, :len(pages)] = pages
            self._slot_pages[s] = pages
            if self._prefix is not None:
                _prof.record_prefix_lookup(match_len > 0, tokens_saved=match_len,
                                           cow_copies=1 if copy_args else 0)
            if req.session_id is not None and self._sessions is not None:
                # every matched prompt token is prefill work the session's
                # pinned chain (or the shared cache) absorbed; the touch
                # keeps an active conversation off the LRU end
                req.session_reused_tokens = match_len
                self._sessions.tokens_saved_total += match_len
                self._sessions.touch(req.session_id)
                _prof.record_session_stats(self._sessions.stats())
            row_table = self._page_table[s].copy()
        suffix = L - match_len
        bucket = self._bucket_for(suffix)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :suffix] = req.prompt[match_len:]
        check_table_bounds(row_table, self.pool_pages)
        t_pf = self._obs_queued(req)
        try:
            with self._prefill_armed(req):
                with self._launch(gen):
                    if copy_args is not None:
                        self._copy_page(*copy_args)
                    nxt, logits = self._run_prefill(
                        toks, suffix, req.temperature, table=row_table,
                        start=match_len if match_len else None,
                        adapter_slot=req.adapter_slot or 0)
                tok = int(nxt[0])  # the landing fetch of the first token
        finally:
            if pinned is not None:
                with self._mu:
                    self._pool.decref(pinned)
        with self._mu:
            self._check_gen(gen)  # a restart during the dispatch owns req
            if self._prefix is not None:
                inserted = self._prefix.commit(
                    req.prompt, pages, self._pool,
                    adapter=self._req_adapter_id(req))
                if inserted:
                    _prof.record_paging_event("cache_commits", inserted)
            self._land_locked(s, req, tok, logits)
        self._obs_prefilled(req, t_pf, s, bucket, match_len)

    def _import_into_paged(self, s, req, gen):
        """Admission of a handoff into slot s (reference:
        `_import_into_paged`, engine.py:2428-2530): fresh pages for the
        request's whole span (never prefix-shared), the staged rows uploaded
        once and landed a page at a time through the import graph, the
        prompt's pages committed to the prefix cache, then the slot seated
        as a prefill landing seats it: pos = L, the shipped first token
        emitted, no adapter, a drafter seeded from prompt + first token
        under speculation.  The upload and the replays run in the
        watchdogged `serve.import` region under the launch fence; a restart
        meanwhile owns the request and released its pages."""
        L = int(req.prompt.size)
        rows, first = req.handoff
        ps = self.page_size
        n_prompt = -(-L // ps)
        with self._mu:
            self._check_gen(gen)
            # the slot rebuild after this landing reads _last_tok
            self._flush_pending_locked()
            req.max_new_tokens = min(req.max_new_tokens, self.max_len - L)
            pages = [self._alloc_page_locked(i % self.cp)
                     for i in range(self._pages_for(L, req.max_new_tokens))]
            self._page_table[s, :] = 0
            self._page_table[s, :len(pages)] = pages
            self._slot_pages[s] = pages
        check_table_bounds(np.asarray(pages), self.pool_pages)
        t_pf = self._obs_queued(req)
        with self._watchdog.arm("serve.import", timeout=self._wd_timeout(),
                                context=f"req {req.id} ({n_prompt} pages)"):
            with self._launch(gen):
                on_dev = {name: t.to(self.device, non_blocking=True)
                          for name, t in rows.items()}
                for i in range(n_prompt):
                    self._import_g(
                        None, dst=np.full(1, pages[i], np.int32),
                        **{f"{name}_tiles": t[:, i * ps:(i + 1) * ps]
                           for name, t in on_dev.items()})
        with self._mu:
            self._check_gen(gen)  # a restart during the import owns req
            if self._prefix is not None:
                inserted = self._prefix.commit(req.prompt, pages, self._pool)
                if inserted:
                    _prof.record_paging_event("cache_commits", inserted)
            req.handoff = None  # the arena holds the rows now
            _prof.record_disagg_event("imports")
            _prof.record_disagg_event("import_pages", n_prompt)
            self._land_locked(s, req, first, None)
        if req.trace:
            _obs.record("engine.import", req.trace[0], t0=t_pf,
                        t1=time.perf_counter(), parent_id=req.trace[1],
                        req=req.id, slot=s, pages=n_prompt)

    def _load_state_locked(self, active_idx):
        """The decode loop state of the current slot membership, from the
        host mirrors: positions, the active mask, temperatures, the page
        tables (and their cp local tables), bound-checked, and under LoRA
        the slots' arena slots.  Loaded into the decode or verify graph's
        static inputs at a membership change; the steps advance them on
        the card after that.  Caller holds _mu."""
        active = np.zeros(self.slots, bool)
        active[active_idx] = True
        # the poison input too: a restart may have cut a poisoned step off
        # before its reset
        state = {"pos": self._pos.copy(), "active": active,
                 "temps": self._temps.copy(),
                 "poison": np.zeros(self.slots, bool)}
        if self.paged:
            state.update(self._table_inputs(self._page_table))
        if self._lora is not None:
            state["adapters"] = self._slot_adapter.copy()
        return state

    def _needs_tokens_locked(self, active_idx, depth):
        """The reference's flush rule (engine.py:2594-2603): fetch now when a
        slot watches for EOS, streams its tokens (`on_token`, and the port's
        `keep_logits`), or reaches its length bound within the `depth`
        steps in flight.  Caller holds _mu."""
        for s in active_idx:
            req = self._slot_req[s]
            if (req.eos_token_id is not None or req.on_token is not None
                    or req.keep_logits
                    or len(req.tokens) + depth >= req.max_new_tokens):
                return True
        return False

    def _poison_locked(self, active_idx):
        """The `serve.decode.nan` drill (reference: engine.py:2563): when
        armed, a one-hot [S] host mask naming the first active slot, for the
        step's `poison` static input; else None.  Caller holds _mu."""
        if not _inj.should_fire("serve.decode.nan",
                                context=f"slot {active_idx[0]}"):
            return None
        mask = np.zeros(self.slots, bool)
        mask[active_idx[0]] = True
        return mask

    def _decode_once(self, gen):
        """One decode step for every active slot: one replay of the decode
        graph, left in flight unless the flush rule fetches it."""
        with self._mu:
            self._check_gen(gen)
            active_idx = [s for s in range(self.slots)
                          if self._slot_req[s] is not None]
            if not active_idx:
                return 0
            t0 = time.perf_counter()
            load = {}
            if self._dev is None:  # membership changed: reload the state
                load = self._load_state_locked(active_idx)
                load["toks"] = self._last_tok.reshape(self.slots, 1).copy()
                self._obs_epoch_open(active_idx)
            keep = any(self._slot_req[s].keep_logits for s in active_idx)
            poison = self._poison_locked(active_idx)
            if poison is not None:
                load["poison"] = poison
        with self._watchdog.arm("serve.decode", timeout=self._wd_timeout(),
                                context=f"{len(active_idx)} active slots"):
            with self._launch(gen):
                nxt, finite, logits = self._decode_g(None, **load)
                # the pending entry copies the static outputs: the next
                # replay overwrites them
                step = torch.stack([nxt, finite.to(torch.int32)])
                kept = logits.clone() if keep else None
                if poison is not None:  # one step only, reset on the card
                    self._decode_g.inputs(None)["poison"].zero_()
        with self._mu:
            self._check_gen(gen)
            self._dev = self._decode_g.inputs(None)
            for s in active_idx:
                self._pos[s] += 1
            self._pending_fetch.append((step, active_idx, t0, kept))
            if poison is not None or self._needs_tokens_locked(
                    active_idx, len(self._pending_fetch)):
                self._flush_pending_locked()
            if self._ep is not None:  # closed if the flush finished a slot
                self._ep["ticks"] += 1
            _prof.record_serving_tick(len(active_idx) / self.slots,
                                      self._queue.qsize(),
                                      time.perf_counter() - t0, t0=t0)
            self._record_paging_tick_locked()
            if self.kv_quant == "int8":
                # per layer: one K/V row pair quantized per active slot, and
                # every mapped page dequantized in the kernel's page walk
                _prof.record_kv_quant_event("quantize", len(active_idx))
                _prof.record_kv_quant_event(
                    "dequantize", sum(len(self._slot_pages[s]) for s in active_idx))
        return len(active_idx)

    def _record_paging_tick_locked(self):
        """The page pool's occupancy after a decode step (paged only).
        Caller holds _mu."""
        if self.paged:
            _prof.record_paging_tick(self._pool.used_count(),
                                     self._pool.usable_pages)

    def _obs_epoch_open(self, active_idx):
        """Open a decode epoch (reference: engine.py:2778) at a reload of
        the loop state: the stretch of constant slot membership that
        starts here.  Only when FLAGS_trace is on and a member is traced;
        the epoch keeps (slot, request id, trace context, adapter name) per
        member, no request.  Caller holds _mu."""
        self._obs_epoch_close()
        if not _obs.enabled():
            return
        members = [(s, self._slot_req[s].id, self._slot_req[s].trace,
                    self._adapter_name(self._slot_req[s]))
                   for s in active_idx]
        if any(m[2] for m in members):
            self._ep = {"t0": time.perf_counter(), "ticks": 0,
                        "members": members, "proposed": 0, "accepted": 0}

    def _obs_epoch_close(self):
        """Close the open decode epoch (reference: engine.py:2796): one
        engine.decode span per traced member over the epoch's steps, and
        under speculation an engine.verify span with the epoch's drafts
        proposed and accepted.  Caller holds _mu."""
        ep, self._ep = self._ep, None
        if not ep or not ep["ticks"]:
            return
        t1 = time.perf_counter()
        for s, rid, tr, adapter in ep["members"]:
            if not tr:
                continue
            _obs.record("engine.decode", tr[0], t0=ep["t0"], t1=t1,
                        parent_id=tr[1], req=rid, slot=s, ticks=ep["ticks"],
                        adapter=adapter)
            if self._spec_on:
                _obs.record("engine.verify", tr[0], t0=ep["t0"], t1=t1,
                            parent_id=tr[1], req=rid, slot=s,
                            ticks=ep["ticks"], proposed=ep["proposed"],
                            accepted=ep["accepted"])

    def _note_step_time(self, per):
        """Blend one decode step's wall time into the EWMA that
        estimate_drain_s reads.  Caller holds _mu."""
        ew = self._step_ewma_s
        self._step_ewma_s = per if ew is None else 0.8 * ew + 0.2 * per

    def _flush_pending_locked(self):
        """Fetch every dispatched decode step not fetched yet, in one
        transfer, and emit its tokens (reference: engine.py:2822).  A slot
        whose logits went non-finite errors alone with NonFiniteLogits.
        Membership is constant across the pending steps (any change
        flushes first), so each entry's slots are exact; a slot that
        finished earlier in this flush skips the rest.  The fetch runs in
        the watchdogged `serve.fetch` region; the generation is checked
        after it (a restart that could not take _mu may have superseded
        this thread meanwhile).  The EWMA step time is the first pending
        step's dispatch to the fetch's end, over the steps fetched.  Caller
        holds _mu."""
        if not self._pending_fetch:
            return
        gen0 = self._generation
        batches, self._pending_fetch = self._pending_fetch, []
        t_f0 = time.perf_counter()
        with self._watchdog.arm("serve.fetch", timeout=self._wd_timeout(),
                                context=f"{len(batches)} buffered steps"):
            fetched = torch.stack([b[0] for b in batches]).cpu().numpy()
        self._check_gen(gen0)
        _prof.record_host_fetch()
        if _obs.enabled():  # one engine.fetch span per traced request
            now = time.perf_counter()
            traced = {}
            for _, idx, _, _ in batches:
                for s in idx:
                    req = self._slot_req[s]
                    if req is not None and req.trace:
                        traced[req.id] = req.trace
            for rid, tr in traced.items():
                _obs.record("engine.fetch", tr[0], t0=t_f0, t1=now,
                            parent_id=tr[1], req=rid, steps=len(batches))
        self._note_step_time((time.perf_counter() - batches[0][2]) / len(batches))
        for (_, idx, _, kept), (nxt_np, fin_np) in zip(batches, fetched):
            for s in idx:
                req = self._slot_req[s]
                if req is None:  # finished earlier in this flush
                    continue
                if not fin_np[s]:
                    self._fail_nonfinite_locked(s, req)
                    continue
                tok = int(nxt_np[s])
                self._last_tok[s] = tok
                if req.keep_logits:
                    req.logits.append(kept[s])
                self._emit(s, req, tok)

    def _fail_nonfinite_locked(self, s, req):
        _prof.record_serving_fault("nonfinite")
        req.error = NonFiniteLogits(
            f"request {req.id}: non-finite logit window at position "
            f"{int(self._pos[s])} (slot {s}); the slot was evicted — "
            "co-batched requests are unaffected")
        self._finish(s, req, "error")

    def _decode_once_spec(self, gen):
        """One speculative round for every active slot (reference:
        `_decode_once_spec`, engine.py:2627): draft on the host, verify k + 1
        rows per slot in one replay of the verify graph, fetch, emit each
        slot's accepted run.  The draft budget min(spec_k, req.spec_k,
        remaining - 1) keeps every committed row inside the slot's mapped
        pages and the emitted run within max_new_tokens; an eos inside the
        run ends the request there and drops the rest of the run.  Returns
        the tokens emitted."""
        K1 = self.spec_k + 1
        with self._mu:
            self._check_gen(gen)
            active_idx = [s for s in range(self.slots)
                          if self._slot_req[s] is not None]
            if not active_idx:
                return 0
            t0 = time.perf_counter()
            load = {}
            if self._dev is None:  # membership changed: reload the state
                load = self._load_state_locked(active_idx)
                self._obs_epoch_open(active_idx)
            toks = np.zeros((self.slots, K1), np.int32)
            valid = np.ones(self.slots, np.int32)
            proposed = 0
            for s in active_idx:
                req = self._slot_req[s]
                toks[s, 0] = self._last_tok[s]
                dr = self._drafters[s]
                if dr is None:
                    continue  # sampled or opted out: a plain decode row
                budget = min(self.spec_k,
                             self.spec_k if req.spec_k is None else req.spec_k,
                             req.max_new_tokens - len(req.tokens) - 1)
                draft = dr.propose(budget) if budget > 0 else []
                toks[s, 1:1 + len(draft)] = draft
                valid[s] = 1 + len(draft)
                proposed += len(draft)
            if self._ep is not None:
                self._ep["proposed"] += proposed
            poison = self._poison_locked(active_idx)
            if poison is not None:
                load["poison"] = poison
        with self._watchdog.arm("serve.decode", timeout=self._wd_timeout(),
                                context=f"{len(active_idx)} active slots "
                                        f"(spec k={self.spec_k})"):
            with self._launch(gen):
                out, n_emit, finite, logits = self._verify_g(
                    None, toks=toks, valid=valid, **load)
                # the next drafts need these tokens: one fetch every step
                step = torch.cat([out, n_emit[:, None],
                                  finite[:, None].to(torch.int32)], dim=1)
                if poison is not None:  # one step only, reset on the card
                    self._verify_g.inputs(None)["poison"].zero_()
        with self._mu:
            self._check_gen(gen)
            self._dev = self._verify_g.inputs(None)
            with self._watchdog.arm("serve.fetch", timeout=self._wd_timeout(),
                                    context=f"verify fetch ({len(active_idx)} "
                                            "slots)"):
                host = step.cpu().numpy()
            # a restart that could not take _mu may have superseded this
            # thread during the fetch
            self._check_gen(gen)
            _prof.record_host_fetch()
            self._note_step_time(time.perf_counter() - t0)
            accepted = emitted = 0
            for s in active_idx:
                req = self._slot_req[s]
                if not host[s, K1 + 1]:
                    self._fail_nonfinite_locked(s, req)
                    continue
                n = int(host[s, K1])
                self._pos[s] += n
                accepted += n - 1
                emitted += n
                dr = self._drafters[s]
                for j in range(n):
                    if self._slot_req[s] is not req:
                        break  # eos inside the accepted run right-trims
                    tok = int(host[s, j])
                    self._last_tok[s] = tok
                    if dr is not None:
                        dr.extend(tok)
                    if req.keep_logits:
                        req.logits.append(logits[s, j].clone())
                    self._emit(s, req, tok)
            if emitted:
                self._tok_rate_ewma = (0.8 * self._tok_rate_ewma
                                       + 0.2 * emitted / len(active_idx))
            if self._ep is not None:  # closed if a slot finished
                self._ep["ticks"] += 1
                self._ep["accepted"] += accepted
            _prof.record_serving_tick(len(active_idx) / self.slots,
                                      self._queue.qsize(),
                                      time.perf_counter() - t0, t0=t0)
            self._record_paging_tick_locked()
            _prof.record_speculation(proposed, accepted, emitted, len(active_idx))
            if self.kv_quant == "int8":
                # the window quantizes k + 1 row pairs per active slot
                _prof.record_kv_quant_event("quantize", len(active_idx) * K1)
                _prof.record_kv_quant_event(
                    "dequantize", sum(len(self._slot_pages[s]) for s in active_idx))
        return emitted

    def _check_invariants(self):
        """FLAGS_serve_debug_invariants after a step (reference:
        engine.py:3075): a free slot is fully recycled (pos and temperature
        zeroed), an occupied slot holds exactly one live request at a
        position within the context, no request holds two slots, the queued
        token count is not negative; then, paged, the page audit; under
        LoRA, no free slot bound to an adapter and the arena's refcounts
        equal to its residency plus the engine slots bound to each slot
        (reference: engine.py:3116-3129).  Raises AssertionError."""
        with self._mu:
            seen = {}
            for s, req in enumerate(self._slot_req):
                if req is None:
                    if self._pos[s] != 0 or self._temps[s] != 0.0:
                        raise AssertionError(
                            f"slot invariant: slot {s} is free but not "
                            f"recycled (pos={int(self._pos[s])}, "
                            f"temp={float(self._temps[s])})")
                    continue
                if req.finished.is_set():
                    raise AssertionError(
                        f"slot invariant: slot {s} holds already-resolved "
                        f"request {req.id} ({req.finish_reason})")
                if id(req) in seen:
                    raise AssertionError(
                        f"slot invariant: request {req.id} occupies slots "
                        f"{seen[id(req)]} and {s}")
                seen[id(req)] = s
                if not 0 < int(self._pos[s]) <= self.max_len:
                    raise AssertionError(
                        f"slot invariant: slot {s} (request {req.id}) at "
                        f"position {int(self._pos[s])} outside (0, "
                        f"{self.max_len}]")
            if self._queued_new_tokens < 0:
                raise AssertionError(
                    "slot invariant: queued-token accounting went negative "
                    f"({self._queued_new_tokens})")
            if self.paged:
                self._check_page_invariants_locked()
            if self._lora is not None:
                bindings = {}
                for s in range(self.slots):
                    a = int(self._slot_adapter[s])
                    if self._slot_req[s] is None:
                        if a:
                            raise AssertionError(
                                f"lora invariant: free slot {s} still bound "
                                f"to arena slot {a}")
                        continue
                    if a:
                        bindings[a] = bindings.get(a, 0) + 1
                self._lora.check_invariants(bindings)

    def _check_page_invariants_locked(self):
        """The page audit of FLAGS_serve_debug_invariants (reference:
        engine.py:3131): every page's refcount equals its holds (slot
        mappings, cache entries, the scratch pin of every shard), the free
        lists are exactly the unpinned ref-0 pages, free slots map nothing,
        an occupied slot's table agrees with its mapping and covers every
        position it has written, a verify window's overrun entries are
        scratch redirects, every cp local table stays inside its shard, and
        sequence page j of a slot sits on shard j % cp, and the session
        pins reconcile with the live cache entries and their refcounts.
        Raises AssertionError.  Caller holds _mu."""
        pool, ps = self._pool, self.page_size
        check_table_bounds(self._page_table, pool.num_pages)
        check_scale_arenas(self._flat_arenas(), pool.num_pages, ps)
        expected = np.zeros(pool.num_pages, np.int64)
        expected[list(pool.scratch_pages)] = 1
        for s in range(self.slots):
            row, mapped = self._page_table[s], self._slot_pages[s]
            if self._slot_req[s] is None:
                if mapped or row.any():
                    raise AssertionError(
                        f"page invariant: free slot {s} still maps pages "
                        f"{mapped} (table row {row.tolist()})")
                continue
            if (len(set(mapped)) != len(mapped)
                    or any(pool.is_scratch(p) for p in mapped)):
                raise AssertionError(
                    f"page invariant: slot {s} mapping {mapped} has "
                    "duplicates or scratch")
            if [int(p) for p in row if p] != list(mapped):
                raise AssertionError(
                    f"page invariant: slot {s} table row {row.tolist()} "
                    f"disagrees with its mapping {mapped}")
            if (int(self._pos[s]) - 1) // ps >= len(mapped):
                raise AssertionError(
                    f"page invariant: slot {s} at pos {int(self._pos[s])} "
                    f"writes past its {len(mapped)} mapped pages")
            if self._spec_on:
                _, over = spec_write_pages(int(self._pos[s]), self.spec_k + 1,
                                           ps, len(mapped))
                bad = [e for e in over if e < row.shape[0] and row[e] != 0]
                if bad:
                    raise AssertionError(
                        f"page invariant: slot {s} verify window entries {bad} "
                        f"lie past its {len(mapped)}-page mapping but are not "
                        "scratch redirects")
            for j, p in enumerate(mapped):
                expected[p] += 1
                if pool.shard_of(p) != j % self.cp:
                    raise AssertionError(
                        f"page invariant: slot {s} sequence page {j} is page "
                        f"{p} on shard {pool.shard_of(p)}, expected shard "
                        f"{j % self.cp} (cp={self.cp})")
        if self._prefix is not None:
            for e in self._prefix.entries():
                if not 0 < e.rows <= ps:
                    raise AssertionError(
                        f"page invariant: cache entry on page {e.page} has "
                        f"row count {e.rows} outside (0, {ps}]")
                expected[e.page] += 1
        if not np.array_equal(expected, pool.refs):
            bad = [(p, int(pool.refs[p]), int(expected[p]))
                   for p in range(pool.num_pages) if pool.refs[p] != expected[p]]
            raise AssertionError(
                f"page invariant: refcount drift (page, actual, expected): {bad}")
        free = sorted(pool._free)
        ref0 = [p for p in range(pool.num_pages)
                if pool.refs[p] == 0 and not pool.is_scratch(p)]
        if free != ref0:
            raise AssertionError(
                f"page invariant: free list {free} != ref-0 pages {ref0}")
        if self.cp > 1:
            # raises ValueError on a local id outside its shard's range
            self._host_local_tables(self._page_table)
        if self._sessions is not None:
            self._sessions.check(self._prefix, pool)

    @staticmethod
    def _req_adapter_id(req):
        """The stable registry id prefix-cache and session chains key on
        (0 = the base model); never the arena slot, which is recycled
        across adapters."""
        return 0 if req.adapter is None else req.adapter.adapter_id

    def _release_adapters_locked(self, reqs):
        """Drop each request's arena binding (residency survives: the
        adapter stays warm for the next request).  Idempotent; caller holds
        _mu."""
        for req in reqs:
            if req is None:
                continue
            slot, req.adapter_slot = req.adapter_slot, None
            if slot:
                self._lora.release(slot)

    def _bind_session_locked(self, s, req):
        """Commit slot s's committed rows to the prefix cache and (re)bind
        the request's session to the chain covering them (reference:
        engine.py:2953).  The committed sequence is (prompt + generated)
        [:pos]: K/V rows [0, pos) hold exactly those tokens, and the last
        emitted token's row is written only by a step after it, so a turn
        that ends at its length bound leaves it out and the next turn's
        chunk prefill computes it at its true position.  Caller holds _mu;
        the slot still maps its pages."""
        pos = int(self._pos[s])
        seq = np.concatenate([req.prompt, np.asarray(req.tokens, np.int32)])[:pos]
        if seq.size == 0:
            return
        ad = self._req_adapter_id(req)
        inserted = self._prefix.commit(seq, self._slot_pages[s], self._pool,
                                       adapter=ad)
        if inserted:
            _prof.record_paging_event("cache_commits", inserted)
        entries, covered = self._prefix.chain(seq, adapter=ad)
        evicted = self._sessions.bind(req.session_id, seq, entries, adapter=ad)
        if evicted:
            _prof.record_paging_event("session_evictions", len(evicted))
        _prof.record_session_stats(self._sessions.stats())
        _flight.record("session", "bind", req=req.id, sid=req.session_id,
                       tokens=int(seq.size), pages=len(entries),
                       covered=int(covered),
                       turns=self._sessions.get(req.session_id)["turns"])

    def _export_rows_locked(self, s, L):
        """Slot s's rows [0, L) of every layer's arena tensors, read through
        its page mapping as stored: {name: [n_layers, rows, kv_heads, ...]}
        host tensors, rows the prompt's pages' worth.  One `index_select`
        per arena tensor gathers the prompt's pages into one device buffer
        per element type (K and V, and the int8 scales), and each buffer
        reaches the host in one copy (pinned on the card), on the engine's
        stream after the steps already dispatched.  Caller holds _mu."""
        ps = self.page_size
        n = -(-L // ps)
        idx = torch.tensor(self._slot_pages[s][:n], dtype=torch.long,
                           device=self.device)
        groups = [("k", "v")]
        if self.kv_quant == "int8":
            groups.append(("k_scale", "v_scale"))
        pin = self.device.type == "cuda"
        host = {}
        with torch.no_grad():
            for names in groups:
                ref = getattr(self._arenas[0], names[0])
                dev = torch.empty((len(names), len(self._arenas), n) + ref.shape[1:],
                                  dtype=ref.dtype, device=self.device)
                for j, name in enumerate(names):
                    for i, a in enumerate(self._arenas):
                        torch.index_select(getattr(a, name), 0, idx, out=dev[j, i])
                buf = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=pin)
                buf.copy_(dev, non_blocking=pin)
                for j, name in enumerate(names):
                    host[name] = buf[j].view((len(self._arenas), n * ps)
                                             + ref.shape[2:])
            if pin:
                torch.cuda.current_stream(self.device).synchronize()
        return host

    def _export_slot_locked(self, s, req):
        """Slot s's committed prompt rows, serialized into `req.kv_export`
        with the first token (reference: `_export_slot_locked`,
        engine.py:2989-3033): exactly the rows a colocated engine holds
        after this prompt's prefill (the first token's row is written by
        the step after it), so an export at the finish of a one-token
        prefill is the whole handoff.  Counts `exports` and
        `handoff_bytes`.  Caller holds _mu."""
        L = int(req.prompt.size)
        host = self._export_rows_locked(s, L)
        layers = [{name: t[i, :L] for name, t in host.items()}
                  for i in range(len(self._arenas))]
        payload = serialize_kv_handoff(layers, L, self.kv_quant,
                                       self._kv_dtype_name)
        payload["first_token"] = int(req.tokens[0]) if req.tokens else None
        req.kv_export = payload
        _prof.record_disagg_event("exports")
        _prof.record_disagg_event("handoff_bytes", payload["payload_bytes"])
        _flight.record("disagg", "export", req=req.id, pages=-(-L // self.page_size),
                       bytes=payload["payload_bytes"])

    def _emit(self, s, req, tok):
        req.tokens.append(tok)
        if req.on_token is not None:
            try:
                req.on_token(tok)
            except Exception:
                pass  # a broken consumer must not take the engine down
        if req.eos_token_id is not None and tok == req.eos_token_id:
            self._finish(s, req, "eos")
        elif len(req.tokens) >= req.max_new_tokens:
            self._finish(s, req, "length")

    def _finish(self, s, req, reason):
        """Recycle slot s at once (no scrub: its next prefill rewrites what
        it attends) and resolve the request.  A request that ended on eos
        or length exports its prompt rows first when it asked to, then a
        session's turn binds its session, both while the slot still maps
        its pages (reference: engine.py:2895-2925); the adapter binding
        drops (residency stays).  Caller holds _mu."""
        if (self.paged and req.export_kv and req.kv_export is None
                and reason in ("eos", "length")):
            try:
                self._export_slot_locked(s, req)
            except Exception:
                # the handoff's consumer sees kv_export None (POST /prefill
                # answers 503 HandoffExportFailed); the pages still go back
                logger.exception("disagg: page export failed for request %d",
                                 req.id)
        if (self._sessions is not None and req.session_id is not None
                and reason in ("eos", "length")):
            try:
                self._bind_session_locked(s, req)
            except Exception:
                # a failed bind leaves the next turn stateless (a re-prefill);
                # it must not take the finish down with it
                logger.exception("session: bind failed for request %d "
                                 "(session %r)", req.id, req.session_id)
        self._slot_req[s] = None
        self._pos[s] = 0
        self._last_tok[s] = 0
        self._temps[s] = 0.0
        self._drafters[s] = None
        self._release_slot_pages_locked(s)
        self._slot_adapter[s] = 0
        self._release_adapters_locked((req,))
        self._obs_epoch_close()
        self._dev = None
        self._resolve(req, reason)

    def _resolve(self, req, reason):
        """Terminal transition, exactly once (reference: engine.py:3036): a
        request that already resolved (a restart raced an eviction, a stop
        raced a finish) is left untouched."""
        if req.finished.is_set():
            return
        req.finish_reason = reason
        req.state = reason
        req._finish_t = time.perf_counter()
        if reason in ("eos", "length"):
            _prof.record_serving_request(req.ttft_s or 0.0, len(req.tokens))
        elif reason == "timeout":
            _prof.record_serving_fault("deadline_miss")
        if reason in ("eos", "length", "timeout"):
            # the miss rate over organic outcomes only: restarts and
            # cancellations are no deadline signal
            with self._mu:
                self._miss_ewma = ((1.0 - _MISS_EWMA_ALPHA) * self._miss_ewma
                                   + _MISS_EWMA_ALPHA * (reason == "timeout"))
                rate = self._miss_ewma
            _prof.record_deadline_miss_rate(rate)
        elif reason == "cancelled":
            _prof.record_serving_fault("cancelled")
        elif reason == "restarted":
            _prof.record_serving_fault("restarted_requests")
        req.finished.set()
