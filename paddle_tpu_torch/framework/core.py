"""Flags, dtypes and the default device of the PyTorch/CUDA port.

Counterpart of `paddle_tpu/framework/core.py`, cut to what the serving
and training paths read.  The flag names and defaults are the reference's, so a
deployment's `FLAGS_serve_*` environment means the same thing to both
packages.
"""

from __future__ import annotations

import os
import threading

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
# AMP (dispatch-level casting under `amp.auto_cast`)
# ---------------------------------------------------------------------------


class AmpState:
    """One `amp.auto_cast` context: the AMP dtype and the op names it casts
    (the reference's AmpState).  A white op's float inputs of another float
    dtype go to `dtype`; a black op's bf16 and fp16 inputs go to float32
    (reference `ops/dispatch.py` `amp_cast_inputs`)."""

    def __init__(self, dtype, white, black):
        self.dtype = dtype
        self.white = frozenset(white)
        self.black = frozenset(black)

    def cast(self, op, t):
        """`t` as op `op` takes it under this state."""
        if not isinstance(t, torch.Tensor) or not t.is_floating_point():
            return t
        if op in self.white and t.dtype != self.dtype:
            return t.to(self.dtype)
        if op in self.black and t.dtype in (torch.bfloat16, torch.float16):
            return t.float()
        return t


_amp_local = threading.local()


def active_amp():
    """The innermost `amp.auto_cast` state of this thread, or None."""
    return getattr(_amp_local, "state", None)


def set_active_amp(state):
    """Make `state` (an AmpState or None) active; returns the previous one."""
    old = active_amp()
    _amp_local.state = state
    return old


def amp_cast(op, t):
    """`t` cast for op `op` under the active auto_cast (unchanged without
    one): the call-site cast of the port's own ops (`nn.functional`)."""
    state = active_amp()
    return t if state is None else state.cast(op, t)


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


def set_flags(flags):
    """Set registered flags from a {name: value} dict (the reference's
    `paddle.set_flags`); an unknown name raises KeyError."""
    for name in flags:
        if name not in _flags:
            raise KeyError(f"unknown flag {name!r}")
    _flags.update(flags)


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
    "FLAGS_serve_prefix_cache", True,
    "paged KV: share committed prompt pages across requests (prefix cache "
    "with copy-on-write tails; a hit prefills only the unshared suffix)",
)
define_flag(
    "FLAGS_serve_decode_kernel", "auto",
    "paged engine: attention kernel of the decode step.  'auto' and 'fused' "
    "run the paged_decode_fused kernel (its plain version on CPU tensors), "
    "'gather' the materialised-gather oracle",
)
define_flag(
    "FLAGS_serve_spec_k", 0,
    "paged engine: speculative decoding draft length k (0 = off).  Greedy "
    "slots draft up to k tokens by prompt lookup and one verify step "
    "scores k+1 positions; requests may lower it with submit(spec_k=)",
)
define_flag(
    "FLAGS_serve_spec_ngram", 3,
    "speculative decoding: longest n-gram the prompt-lookup drafter matches "
    "against the slot's history (it backs off n..1 and proposes nothing on "
    "a miss); read once at engine construction",
)
define_flag(
    "FLAGS_serve_kv_quant", "none",
    "paged KV storage precision: 'none' (the model dtype) or 'int8' (int8 "
    "rows with a float32 scale per row and kv head, read by the "
    "paged_decode_fused_q8 kernel)",
)
define_flag("FLAGS_serve_tp", 1, "tensor-parallel degree.  Not ported; > 1 raises")
define_flag(
    "FLAGS_serve_cp", 1,
    "paged engine: context-parallel degree.  The page arena splits into cp "
    "shards, sequence page k lives on shard k % cp, and every paged "
    "attention runs one paged_decode_partials launch per shard and merges "
    "their softmax partials (on one card: the shards are page ranges of "
    "one arena)",
)
define_flag(
    "FLAGS_serve_session_max", 256,
    "session KV: resident sessions per paged engine with a prefix cache "
    "(read at construction when `session_max=None`); binding one more "
    "session evicts the least recently used one whole",
)
define_flag(
    "FLAGS_serve_role", "colocated",
    "disaggregated serving: the replica's role, read at engine construction "
    "when `role=None`.  'colocated' serves whole requests; 'prefill' also "
    "exports a request's committed prompt rows at its finish "
    "(`export_kv=True`, POST /prefill); 'decode' also imports such a "
    "handoff instead of prefilling (`handoff=`, one more compiled step).  "
    "Paged engines only, and not with cp > 1",
)
define_flag(
    "FLAGS_serve_reserve_ttl_s", 30.0,
    "disaggregated serving: seconds a decode-side page reservation "
    "(`reserve_pages`, POST /reserve) holds its headroom when `ttl_s=None`; "
    "an expired one is purged on the next scheduler tick or reservation",
)
define_flag(
    "FLAGS_serve_lora_capacity", 8,
    "multi-tenant LoRA serving: resident-adapter slots of an AdapterArena "
    "built with `capacity=None` (the pinned base slot comes on top)",
)
define_flag(
    "FLAGS_serve_lora_rank_max", 8,
    "multi-tenant LoRA serving: the padded rank of an AdapterArena built "
    "with `rank_max=None`; an adapter of a higher rank is refused at submit",
)
define_flag(
    "FLAGS_serve_debug_invariants", False,
    "engine: after every scheduler step assert the slot invariants (a free "
    "slot fully recycled, one live request per slot, positions <= max_len) "
    "and audit the page pool, page tables, prefix cache and cp layout "
    "(raises AssertionError on drift)",
)
define_flag(
    "FLAGS_serve_step_timeout_sec", 0.0,
    "serving watchdog deadline (s) for the engine's armed regions (prefill "
    "dispatch, decode dispatch, token fetch); a region overrunning it trips "
    "the EngineSupervisor into a bounded warm engine restart.  0 disables.",
)
define_flag(
    "FLAGS_serve_max_restarts", 3,
    "EngineSupervisor restart budget: after this many engine restarts the "
    "supervisor declares the engine dead and fails all pending requests",
)
define_flag(
    "FLAGS_serve_restart_backoff", 0.5,
    "initial delay (s) before an engine restart, doubled per consecutive "
    "restart",
)
define_flag(
    "FLAGS_serve_drain_grace", 10.0,
    "SIGTERM drain budget (s) for serve(): stop admitting, finish in-flight "
    "up to this long, then stop cleanly.  PADDLE_STOP_GRACE overrides it.",
)
define_flag(
    "FLAGS_fault_inject", "",
    "comma-separated fault points to arm: name[:count|*] "
    "(e.g. 'serve.prefill.hang:1,serve.decode.nan')",
)
define_flag(
    "FLAGS_fault_hang_sec", 3600.0,
    "how long an armed *.hang fault point blocks (default: long enough that "
    "the watchdog, not the sleep, ends the hang)",
)
define_flag(
    "FLAGS_trace",
    os.environ.get("PADDLE_TRACE", "") not in ("", "0", "false"),
    "host-side request tracing (paddle_tpu_torch.obs): record per-stage "
    "spans (serve.handle, engine.queue/prefill/chunk_prefill/decode/verify/"
    "fetch) into a bounded in-memory buffer, served on GET /trace/<id> and "
    "exportable as Chrome-trace JSON.  Host bookkeeping only: no new trace "
    "of a step, no device sync; off by default",
)
define_flag(
    "FLAGS_obs_buffer_events", 4096,
    "capacity of the obs span buffer and of the flight recorder's event "
    "ring (paddle_tpu_torch.obs); the oldest entries are evicted first",
)
define_flag(
    "FLAGS_router_idem_ttl", 300.0,
    "serve() and the router: seconds a completed response stays cached "
    "against its X-Idempotency-Key.  Within the TTL a resubmitted key "
    "replays the stored response instead of generating again; an in-flight "
    "resubmit joins the live request",
)
# the serving fleet (serving/router.py, serving/autoscaler.py): the
# reference's names and defaults (paddle_tpu/framework/core.py:598-747)
define_flag(
    "FLAGS_router_probe_interval", 0.25,
    "serving router: seconds between /healthz probes of each replica",
)
define_flag(
    "FLAGS_router_probe_timeout", 2.0,
    "serving router: per-probe HTTP timeout (s); a timed-out probe counts "
    "as a replica failure toward its circuit breaker",
)
define_flag(
    "FLAGS_router_max_retries", 3,
    "serving router: extra attempts of a zero-token request after a "
    "connect failure, a 503 or a retriable 504 (0 disables failover)",
)
define_flag(
    "FLAGS_router_retry_backoff", 0.05,
    "serving router: initial retry delay (s), doubled per attempt with "
    "+/-50% jitter and clamped by the remaining deadline",
)
define_flag(
    "FLAGS_router_breaker_threshold", 3,
    "serving router: consecutive replica failures that open its breaker",
)
define_flag(
    "FLAGS_router_breaker_cooldown", 1.0,
    "serving router: seconds an open breaker waits before one half-open "
    "trial request",
)
define_flag(
    "FLAGS_router_max_inflight", 64,
    "serving router: requests in flight through the router beyond this are "
    "shed with 503 RouterOverloaded and Retry-After (brownout)",
)
define_flag(
    "FLAGS_router_hedge_s", 0.0,
    "serving router: a zero-token request unanswered after this many "
    "seconds is duplicated onto a second replica, the first complete "
    "response wins.  0 disables hedging",
)
define_flag(
    "FLAGS_router_journal_segment_records", 1024,
    "control-plane journal: records per segment file before a new one",
)
define_flag(
    "FLAGS_router_takeover_timeout", 2.0,
    "router standby: seconds the primary's heartbeat seq may stand still, "
    "on the standby's own clock, before the standby takes over",
)
define_flag(
    "FLAGS_router_retry_after_jitter", 0.25,
    "serving router: +/- fractional jitter on the Retry-After of its sheds, "
    "so clients shed together do not retry together.  0 disables it",
)
define_flag(
    "FLAGS_autoscale_min_replicas", 1,
    "serving autoscaler: a scale-down never leaves fewer ready replicas",
)
define_flag(
    "FLAGS_autoscale_max_replicas", 4,
    "serving autoscaler: a scale-up never grows the fleet past this",
)
define_flag(
    "FLAGS_autoscale_interval", 0.5,
    "serving autoscaler: seconds between control ticks",
)
define_flag(
    "FLAGS_autoscale_up_ticks", 2,
    "serving autoscaler: consecutive pressured ticks before a scale-up",
)
define_flag(
    "FLAGS_autoscale_down_ticks", 6,
    "serving autoscaler: consecutive idle ticks before a scale-down",
)
define_flag(
    "FLAGS_autoscale_up_cooldown", 2.0,
    "serving autoscaler: seconds after any action before a scale-up",
)
define_flag(
    "FLAGS_autoscale_down_cooldown", 10.0,
    "serving autoscaler: seconds after any action before a scale-down",
)
define_flag(
    "FLAGS_autoscale_up_drain_s", 0.5,
    "serving autoscaler: the fleet's best drain estimate above this many "
    "seconds is pressure",
)
define_flag(
    "FLAGS_autoscale_up_queue_depth", 4.0,
    "serving autoscaler: mean queued requests per ready replica above this "
    "is pressure",
)
define_flag(
    "FLAGS_autoscale_up_miss_rate", 0.05,
    "serving autoscaler: any replica's deadline-miss rate above this is "
    "pressure",
)
define_flag(
    "FLAGS_autoscale_min_page_free", 0.05,
    "serving autoscaler: any replica's free page fraction below this is "
    "pressure",
)
define_flag(
    "FLAGS_autoscale_down_drain_s", 0.05,
    "serving autoscaler: a tick is idle only when every ready replica's "
    "drain estimate is at most this and no replica holds work",
)
define_flag(
    "FLAGS_autoscale_tp_max", 1,
    "serving autoscaler: cap on the tensor-parallel degree of a spawned "
    "replica.  The port serves tp 1; a spawn that would pick more raises",
)
define_flag(
    "FLAGS_autoscale_down_idle_tokens_s", 0.0,
    "serving autoscaler: a scale-down also needs this much idle decode "
    "capacity (tokens/s over idle ready replicas).  0: emptiness alone",
)
define_flag(
    "FLAGS_max_inflight_steps", 2,
    "bound on the training steps `hapi.Model.fit` keeps in flight on the "
    "card before the host waits on the oldest one's CUDA event "
    "(backpressure without a value transfer); 1 = a strict per-step fetch, "
    "the same numerics",
)
define_flag(
    "FLAGS_checkpoint_save_retries", 3,
    "bounded retries around a failed checkpoint save before raising "
    "(distributed.checkpoint.save_checkpoint)",
)
define_flag(
    "FLAGS_checkpoint_retry_backoff", 0.5,
    "initial checkpoint retry backoff (s), doubled per attempt",
)
