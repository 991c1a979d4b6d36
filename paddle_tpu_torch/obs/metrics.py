"""Prometheus text exposition over every counter family of the port
(counterpart of `paddle_tpu/obs/metrics.py`).

``render(labels={...})`` returns the classic ``text/plain; version=0.0.4``
format: ``# HELP`` / ``# TYPE`` once per metric name, then one sample per
label set.  It reads ``profiler.metrics_snapshot()`` (one snapshot under
one lock that never leaves a zero out, so the exported NAMES are stable
before any traffic), the kernels' dispatch and fallback counts, the
StepGraph trace count and the obs buffers' own counters.  ``serve()``
mounts it on ``GET /metrics`` with ``{replica="host:port"}`` on every
sample.

The names, label sets and zero-filled label sets are the reference's
(``METRIC_NAMES`` lists them), with these meanings on the port:

- ``paddle_flash_pallas_calls_total{kernel=}``: the reference's seven
  kernel names, zero-filled; a count per compiled shape, as the
  reference's ``_log_pallas_call`` counts (one per launch site in a
  StepGraph trace, or per launch outside a graph; never per replay).  The
  launches themselves, replays included, are
  ``profiler.kernel_launch_counts()``.
- ``paddle_flash_fallbacks_total{reason=}``: attention calls that took
  the plain path (``ops.flash_attention.fallback_counts``) over the
  reference's nine reasons, zero-filled.
- ``paddle_sanitizer_*_total``: the port has no sanitizer yet.
  ``traces`` counts StepGraph traces (``compile_counts()`` summed over
  every graph of the process) and ``host_syncs`` the decode and verify
  token fetches (``profiler.record_host_fetch``); the other five are
  exported at 0.
- ``paddle_mesh_devices``: the CUDA devices the serving engine uses.

- ``paddle_lora_*``: the adapter arena's loads, evictions, residency hits
  and misses and its resident/capacity gauges, live on an engine built with
  ``lora=``.  ``paddle_session_*``: the session store's gauges and
  counters, live on a paged engine with a prefix cache;
  ``paddle_session_pin_hits_total`` and ``paddle_session_repins_total``
  count the router's session pins that held and that broke.

- ``paddle_disagg_*``: ``exports`` and ``handoff_bytes`` (raw row bytes,
  before base64) count a prefill worker's exports, ``imports`` and
  ``import_pages`` a decode worker's imports; ``pair_picks``,
  ``handoff_retries``, ``reserve_fails`` and ``no_decode_capacity`` are the
  router's (``serving.router``).

- ``paddle_router_*``: the serving router's counters and
  ``paddle_router_replica_state`` per replica; ``paddle_autoscaler_*``: the
  autoscaler's control loop (``serving.autoscaler``).  ``serve_router()``
  mounts the render with ``{replica="host:port", role="router"}``.
"""

from __future__ import annotations

from .. import profiler as _prof
from ..ops import flash_attention as _fa
from . import flight as _flight
from . import trace as _trace

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# serving fault kinds always exported (zero-filled) so the label set is
# stable for dashboards that join across replicas
_FAULT_KINDS = _prof.SERVING_FAULT_KINDS

# the reference's fallback reasons (flash_attention.py:1831-1841), every
# one zero-filled: the retired ones' permanent zeros prove the gaps stay
# closed, and the paged ones can never move on the port (its paged
# kernels take every shape the engine gives them)
_FALLBACK_REASONS = (
    "attn_mask not key-padding",
    "q/k shapes differ",
    "head_dim > 256",
    "paged head_dim > 256",
    "paged page_size not 8-aligned",
    "paged heads not divisible by mp",
    "paged tables/pool not divisible by cp",
    "seq not a 128-multiple",
    "attn_mask given",
)

# the sanitizer counters of the reference (analysis/sanitizer.py:45)
_SANITIZER_KEYS = ("traces", "eager_misses", "host_syncs", "unexpected_traces",
                   "unexpected_eager", "unexpected_syncs", "allowed_events")

_ROUTER_NAMES = (
    ("requests", "paddle_router_requests_total"),
    ("retries", "paddle_router_retries_total"),
    ("failovers", "paddle_router_failovers_total"),
    ("breaker_trips", "paddle_router_breaker_trips_total"),
    ("breaker_half_open", "paddle_router_breaker_half_open_total"),
    ("breaker_closes", "paddle_router_breaker_closes_total"),
    ("hedges", "paddle_router_hedges_total"),
    ("hedge_wins", "paddle_router_hedge_wins_total"),
    ("brownout_sheds", "paddle_router_brownout_sheds_total"),
    ("deadline_sheds", "paddle_router_deadline_sheds_total"),
    ("no_replica", "paddle_router_no_replica_total"),
    ("idem_hits", "paddle_router_idem_hits_total"),
    ("idem_joins", "paddle_router_idem_joins_total"),
    ("journal_appends", "paddle_router_journal_appends_total"),
    ("journal_compactions", "paddle_router_journal_compactions_total"),
    ("journal_torn_records", "paddle_router_journal_torn_records_total"),
    ("takeovers", "paddle_router_takeovers_total"),
    ("crashes", "paddle_router_crashes_total"),
    ("session_pin_hits", "paddle_session_pin_hits_total"),
    ("session_repins", "paddle_session_repins_total"),
)
_AUTOSCALE_NAMES = tuple(
    (k, f"paddle_autoscaler_{k}_total")
    for k in ("ticks", "scale_ups", "scale_downs", "holds", "spawn_failures",
              "reaps"))
_DISAGG_NAMES = tuple(
    (k, f"paddle_disagg_{k}_total")
    for k in ("exports", "imports", "import_pages", "handoff_bytes",
              "pair_picks", "handoff_retries", "reserve_fails",
              "no_decode_capacity"))


def _escape(v):
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v):
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return format(float(v), ".10g")


class _Exposition:
    """Accumulates samples; emits HELP/TYPE once per metric name."""

    def __init__(self, base_labels=None):
        self.base = dict(base_labels or {})
        self.lines = []
        self.names = []

    def add(self, name, value, help_text, mtype="counter", labels=None):
        if name not in self.names:
            self.names.append(name)
            self.lines.append(f"# HELP {name} {help_text}")
            self.lines.append(f"# TYPE {name} {mtype}")
        merged = dict(self.base)
        merged.update(labels or {})
        if merged:
            inner = ",".join(f'{k}="{_escape(v)}"'
                             for k, v in sorted(merged.items()))
            self.lines.append(f"{name}{{{inner}}} {_fmt_value(value)}")
        else:
            self.lines.append(f"{name} {_fmt_value(value)}")

    def text(self):
        return "\n".join(self.lines) + "\n"


def _exposition(labels=None):
    # at call time: the inference package imports the fault domain, which
    # imports obs
    from ..inference import graphs as _graphs

    exp = _Exposition(labels)
    snap = _prof.metrics_snapshot()

    g = snap["step"]
    exp.add("paddle_train_steps_total", g["steps"],
            "training steps recorded by record_step")
    exp.add("paddle_train_dispatch_seconds_total", g["dispatch_s"],
            "host seconds spent dispatching training steps")
    exp.add("paddle_train_host_blocked_seconds_total", g["host_blocked_s"],
            "host seconds blocked on the device (backpressure + sync)")
    exp.add("paddle_train_wall_seconds_total", g["wall_s"],
            "wall seconds across recorded training steps")
    exp.add("paddle_train_inflight_max", g["inflight_max"],
            "peak in-flight steps in the async ring", "gauge")

    g = snap["serving"]
    exp.add("paddle_serving_requests_total", g["requests"],
            "finished generation requests")
    exp.add("paddle_serving_tokens_total", g["tokens"],
            "generated tokens across finished requests")
    exp.add("paddle_serving_ticks_total", g["ticks"],
            "engine decode scheduler ticks")
    exp.add("paddle_serving_busy_seconds_total", g["busy_s"],
            "summed decode-step wall seconds (the tokens/s busy window)")
    ttfts = sorted(g["ttfts_s"])
    for q in (0.5, 0.95):
        exp.add("paddle_serving_ttft_seconds", _prof._pctl(ttfts, q),
                "time to first token quantiles over the retained window",
                "gauge", {"quantile": str(q)})
    ticks = g["ticks"] or 1
    exp.add("paddle_serving_occupancy_mean", g["occupancy_sum"] / ticks,
            "mean fraction of KV slots active per tick", "gauge")
    exp.add("paddle_serving_occupancy_peak", g["occupancy_peak"],
            "peak fraction of KV slots active", "gauge")
    exp.add("paddle_serving_queue_depth_max", g["queue_depth_max"],
            "peak admission-queue depth", "gauge")
    faults = dict(g["faults"])
    for kind in _FAULT_KINDS:
        faults.setdefault(kind, 0)
    for kind in sorted(faults):
        exp.add("paddle_serving_faults_total", faults[kind],
                "serving fault-domain events by kind", "counter",
                {"kind": kind})
    exp.add("paddle_serving_deadline_miss_rate", g["deadline_miss_rate"],
            "deadline-miss-rate EWMA over terminal resolutions (a rate; "
            "the monotonic total is paddle_serving_faults_total"
            '{kind="deadline_miss"})', "gauge")

    g = snap["paging"]
    exp.add("paddle_paging_prefix_hits_total", g["prefix_hits"],
            "admission-time prefix-cache hits")
    exp.add("paddle_paging_prefix_misses_total", g["prefix_misses"],
            "admission-time prefix-cache misses")
    exp.add("paddle_paging_prefill_tokens_saved_total",
            g["prefill_tokens_saved"],
            "prompt tokens whose prefill was skipped via cached prefixes")
    exp.add("paddle_paging_cow_copies_total", g["cow_copies"],
            "copy-on-write page copies for new prefix readers")
    exp.add("paddle_paging_cache_evictions_total", g["cache_evictions"],
            "prefix-cache page evictions")
    exp.add("paddle_paging_cache_commits_total", g["cache_commits"],
            "prompt page sets committed to the prefix cache")
    exp.add("paddle_paging_pages_used_peak", g["pages_used_peak"],
            "peak pages in use in the paged-KV pool", "gauge")
    exp.add("paddle_paging_pages_total", g["pages_total"],
            "total pages in the paged-KV pool", "gauge")

    g = snap["speculation"]
    exp.add("paddle_spec_steps_total", g["steps"],
            "speculative verify steps dispatched")
    exp.add("paddle_spec_proposed_tokens_total", g["proposed"],
            "draft tokens proposed by the prompt-lookup drafter")
    exp.add("paddle_spec_accepted_tokens_total", g["accepted"],
            "draft tokens accepted by the batched verify step")
    exp.add("paddle_spec_emitted_tokens_total", g["emitted"],
            "tokens emitted by verify steps (accepted + 1 per slot-step)")
    exp.add("paddle_spec_acceptance_rate",
            (g["accepted"] / g["proposed"]) if g["proposed"] else 0.0,
            "accepted / proposed draft tokens", "gauge")
    exp.add("paddle_spec_tokens_per_step",
            (g["emitted"] / g["slot_steps"]) if g["slot_steps"] else 0.0,
            "mean emitted tokens per slot-step (1.0 = no speculation win)",
            "gauge")

    g = snap["lora"]
    exp.add("paddle_lora_loads_total", g["loads"],
            "LoRA adapter uploads into arena slots")
    exp.add("paddle_lora_evictions_total", g["evictions"],
            "LRU evictions of idle resident LoRA adapters")
    exp.add("paddle_lora_residency_hits_total", g["residency_hits"],
            "adapter acquires that found the adapter already resident")
    exp.add("paddle_lora_residency_misses_total", g["residency_misses"],
            "adapter acquires that had to upload (or park on a full arena)")
    exp.add("paddle_lora_resident", g["resident"],
            "LoRA adapters currently resident in the arena", "gauge")
    exp.add("paddle_lora_capacity", g["capacity"],
            "LoRA arena adapter slots (excludes the pinned base slot)",
            "gauge")

    g = snap["mesh"]
    exp.add("paddle_mesh_devices", g["devices"],
            "CUDA devices the serving engine uses", "gauge")
    exp.add("paddle_mesh_tp_degree", g["tp"],
            "tensor-parallel degree of the serving mesh ('mp' axis size)",
            "gauge")
    exp.add("paddle_mesh_allreduce_per_step", g["allreduce_per_step"],
            "cross-shard merges per decode step (one softmax-partials "
            "combine per layer under cp; 0 at tp=1, cp=1)", "gauge")
    exp.add("paddle_cp_degree", g["cp"],
            "context-parallel degree of the serving mesh ('cp' axis size; "
            "pages shard round-robin across it)", "gauge")
    cp_compiles = sum(v for k, v in snap["flash_pallas"].items()
                      if k.startswith("paged_decode_fused_cp"))
    exp.add("paddle_cp_decode_compiles_total", cp_compiles,
            "context-parallel fused paged-decode kernel compilations "
            "(shard-local partials + softmax allreduce combine)")

    g = snap["kv_quant"]
    exp.add("paddle_kv_quant_mode", 1,
            "paged-KV arena storage precision (1 = current mode)", "gauge",
            {"mode": g["mode"]})
    exp.add("paddle_kv_quant_arena_bytes", g["arena_bytes"],
            "K/V value-arena HBM bytes across all layers", "gauge")
    exp.add("paddle_kv_quant_scale_bytes", g["scale_bytes"],
            "per-row dequant scale-arena HBM bytes (0 unless quantized)",
            "gauge")
    for op in ("quantize", "dequantize"):
        exp.add("paddle_kv_quant_page_ops_total", g[op],
                "KV quant-path work: rows quantized on write / mapped pages "
                "dequantized in-kernel", "counter", {"op": op})

    g = snap["sessions"]
    exp.add("paddle_session_resident", g["sessions_resident"],
            "resident KV sessions (pinned committed-page chains)", "gauge")
    exp.add("paddle_session_pages_pinned", g["session_pages_pinned"],
            "prefix-cache pages pinned by resident sessions", "gauge")
    exp.add("paddle_session_binds_total", g["session_binds_total"],
            "session (re)binds at turn finish")
    exp.add("paddle_session_evictions_total", g["session_evictions_total"],
            "whole-session LRU evictions under page pressure")
    exp.add("paddle_session_prefill_tokens_saved_total",
            g["session_prefill_tokens_saved_total"],
            "prompt tokens whose prefill was skipped via session KV reuse")

    g = snap["router"]
    for key, name in _ROUTER_NAMES:
        exp.add(name, g.get(key, 0), f"router events: {key}")
    for rid, state in sorted(g["replica_states"].items()):
        exp.add("paddle_router_replica_state", 1,
                "last observed state per replica (1 = current state)",
                "gauge", {"replica": rid, "state": state})

    g = snap["autoscale"]
    for key, name in _AUTOSCALE_NAMES:
        exp.add(name, g.get(key, 0), f"autoscaler control-loop events: {key}")
    exp.add("paddle_autoscaler_replicas", g["replicas"],
            "fleet size under the autoscaler's control", "gauge")
    exp.add("paddle_autoscaler_replicas_peak", g["replicas_peak"],
            "peak fleet size under the autoscaler's control", "gauge")

    g = snap["disagg"]
    for key, name in _DISAGG_NAMES:
        exp.add(name, g.get(key, 0),
                f"disaggregated prefill/decode serving events: {key}")

    # zero-filled label sets: a fallback regression shows as a counter
    # MOVING on a dashboard, not as a series appearing
    fallbacks = dict(snap["flash_fallbacks"])
    for reason in _FALLBACK_REASONS:
        fallbacks.setdefault(reason, 0)
    for reason in sorted(fallbacks):
        exp.add("paddle_flash_fallbacks_total", fallbacks[reason],
                "flash-attention kernel->plain-path fallbacks by reason",
                "counter", {"reason": reason})
    pallas = dict(snap["flash_pallas"])
    for kern in _fa.PALLAS_KERNELS:
        pallas.setdefault(kern, 0)
    for kern in sorted(pallas):
        exp.add("paddle_flash_pallas_calls_total", pallas[kern],
                "flash-attention kernel dispatches by kernel (one per "
                "compiled shape)", "counter", {"kernel": kern})

    sanitizer = dict.fromkeys(_SANITIZER_KEYS, 0)
    sanitizer["traces"] = _graphs.trace_total
    sanitizer["host_syncs"] = snap["serving"]["host_fetches"]
    for key in sorted(sanitizer):
        exp.add(f"paddle_sanitizer_{key}_total", sanitizer[key],
                "runtime trace/sync sanitizer counters")

    ts = _trace.stats()
    exp.add("paddle_obs_spans_recorded_total", ts["spans_recorded"],
            "spans recorded into the trace buffer")
    exp.add("paddle_obs_spans_dropped_total", ts["spans_dropped"],
            "spans evicted from the bounded trace buffer")
    exp.add("paddle_obs_spans_buffered", ts["spans_buffered"],
            "spans currently buffered", "gauge")
    fs = _flight.stats()
    exp.add("paddle_flight_events_total", fs["events_total"],
            "events recorded into the flight-recorder ring")
    exp.add("paddle_flight_dumps_total", fs["dumps_total"],
            "flight-recorder JSONL dumps written")
    return exp


def render(labels=None):
    """Every counter family as Prometheus text.  `labels` (e.g.
    ``{"replica": "127.0.0.1:8866"}``) go on every sample.  Host reads
    only: safe to scrape a live engine."""
    return _exposition(labels).text()


# every metric name render() exports, in its order: the stable surface a
# scrape is held to (the tests hold it against the reference's render)
METRIC_NAMES = (
    "paddle_train_steps_total", "paddle_train_dispatch_seconds_total",
    "paddle_train_host_blocked_seconds_total",
    "paddle_train_wall_seconds_total", "paddle_train_inflight_max",
    "paddle_serving_requests_total", "paddle_serving_tokens_total",
    "paddle_serving_ticks_total", "paddle_serving_busy_seconds_total",
    "paddle_serving_ttft_seconds", "paddle_serving_occupancy_mean",
    "paddle_serving_occupancy_peak", "paddle_serving_queue_depth_max",
    "paddle_serving_faults_total", "paddle_serving_deadline_miss_rate",
    "paddle_paging_prefix_hits_total", "paddle_paging_prefix_misses_total",
    "paddle_paging_prefill_tokens_saved_total",
    "paddle_paging_cow_copies_total", "paddle_paging_cache_evictions_total",
    "paddle_paging_cache_commits_total", "paddle_paging_pages_used_peak",
    "paddle_paging_pages_total", "paddle_spec_steps_total",
    "paddle_spec_proposed_tokens_total", "paddle_spec_accepted_tokens_total",
    "paddle_spec_emitted_tokens_total", "paddle_spec_acceptance_rate",
    "paddle_spec_tokens_per_step", "paddle_lora_loads_total",
    "paddle_lora_evictions_total", "paddle_lora_residency_hits_total",
    "paddle_lora_residency_misses_total", "paddle_lora_resident",
    "paddle_lora_capacity", "paddle_mesh_devices", "paddle_mesh_tp_degree",
    "paddle_mesh_allreduce_per_step", "paddle_cp_degree",
    "paddle_cp_decode_compiles_total", "paddle_kv_quant_mode",
    "paddle_kv_quant_arena_bytes", "paddle_kv_quant_scale_bytes",
    "paddle_kv_quant_page_ops_total", "paddle_session_resident",
    "paddle_session_pages_pinned", "paddle_session_binds_total",
    "paddle_session_evictions_total",
    "paddle_session_prefill_tokens_saved_total",
    "paddle_router_requests_total", "paddle_router_retries_total",
    "paddle_router_failovers_total", "paddle_router_breaker_trips_total",
    "paddle_router_breaker_half_open_total",
    "paddle_router_breaker_closes_total", "paddle_router_hedges_total",
    "paddle_router_hedge_wins_total", "paddle_router_brownout_sheds_total",
    "paddle_router_deadline_sheds_total", "paddle_router_no_replica_total",
    "paddle_router_idem_hits_total", "paddle_router_idem_joins_total",
    "paddle_router_journal_appends_total",
    "paddle_router_journal_compactions_total",
    "paddle_router_journal_torn_records_total",
    "paddle_router_takeovers_total", "paddle_router_crashes_total",
    "paddle_session_pin_hits_total", "paddle_session_repins_total",
    "paddle_autoscaler_ticks_total", "paddle_autoscaler_scale_ups_total",
    "paddle_autoscaler_scale_downs_total", "paddle_autoscaler_holds_total",
    "paddle_autoscaler_spawn_failures_total", "paddle_autoscaler_reaps_total",
    "paddle_autoscaler_replicas", "paddle_autoscaler_replicas_peak",
    "paddle_disagg_exports_total", "paddle_disagg_imports_total",
    "paddle_disagg_import_pages_total", "paddle_disagg_handoff_bytes_total",
    "paddle_disagg_pair_picks_total", "paddle_disagg_handoff_retries_total",
    "paddle_disagg_reserve_fails_total",
    "paddle_disagg_no_decode_capacity_total", "paddle_flash_fallbacks_total",
    "paddle_flash_pallas_calls_total", "paddle_sanitizer_allowed_events_total",
    "paddle_sanitizer_eager_misses_total", "paddle_sanitizer_host_syncs_total",
    "paddle_sanitizer_traces_total", "paddle_sanitizer_unexpected_eager_total",
    "paddle_sanitizer_unexpected_syncs_total",
    "paddle_sanitizer_unexpected_traces_total",
    "paddle_obs_spans_recorded_total", "paddle_obs_spans_dropped_total",
    "paddle_obs_spans_buffered", "paddle_flight_events_total",
    "paddle_flight_dumps_total",
)
