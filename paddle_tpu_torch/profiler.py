"""Serving gauges and kernel launch counts of the port (counterpart of the
serving, paging and KV-quant parts of `paddle_tpu/profiler.py`).

The engine records one entry per finished request and one per decode step;
`serving_summary()` aggregates them with the reference's key names, with
the fault domain's counters (`record_serving_fault`: restarts, deadline
evictions, admission refusals, cancellations, non-finite logits) under
"faults" and the deadline-miss rate.
`paging_summary()` holds the prefix cache's lookups, hits, prompt tokens
saved, copy-on-write copies, commits and evictions;
`kv_quant_summary()` the arena's storage precision and bytes;
`speculation_summary()` the verify steps' drafts proposed, accepted and
tokens emitted; `mesh_summary()` the serving engine's parallel layout;
`router_summary()` the serving router's counters (`ROUTER_KEYS`, the
session pins) and the last observed state of each replica.
`kernel_launch_counts()` reads every hand-written kernel's launches
(`flash_fwd`, `paged_decode_fused`, `paged_decode_fused_q8`, `flash_bwd`,
`dense_decode`, `paged_decode_fused_cp`, `paged_decode_fused_cp_q8`, and
the optimizer's `adam_fused` and `unscale_fused`);
`summary()` holds them all.

The reference's other families carry its keys too, for `/metrics` and the
flight recorder's dump header: `step` (`record_step`, the training
loop's host-time split), `lora`, `autoscale`, `disagg` and `sessions`.
The training loop, the adapter arena, the engine's KV handoffs and its
session store feed theirs, the serving router its `disagg` keys and the
autoscaler `autoscale`.  `record_paging_tick` feeds the
page-pool gauges (`pages_used_peak`, `pages_total`); the flash counters
(`record_flash_fallback`, `record_flash_pallas_call`) are the kernels'
own per-trace counts, see `ops.flash_attention.pallas_calls`.

`metrics_snapshot()` is one raw snapshot of every family under one lock
that, unlike the `*_summary()` helpers, never leaves a zero out (the
exported metric names are stable before any traffic); `reset()` zeroes
every family in one critical section (the new families have no reset
of their own).  Kernel launch counts are not a family here:
`reset_kernel_launch_counts()` zeroes them.
"""

from __future__ import annotations

import threading
import time

from .ops import flash_attention as _fa
from .ops import optim as _optim

_TTFT_KEEP = 10000  # bound the percentile buffer; serving runs are long

_lock = threading.Lock()
_gauges = {}
_paging = {}
_kv_quant = {}
_spec = {}
_mesh = {}
_router = {}
_step = {}
_lora = {}
_autoscale = {}
_disagg = {}
_sessions = {}


def _reset_locked():
    _gauges.update(
        requests=0, tokens=0, ttfts_s=[], busy_s=0.0, ticks=0,
        occupancy_sum=0.0, occupancy_peak=0.0, queue_depth_sum=0,
        queue_depth_max=0, window_t0=None, window_t1=None, host_fetches=0,
        faults={}, deadline_miss_rate=0.0,
    )


_reset_locked()


def reset_serving():
    with _lock:
        _reset_locked()


def record_serving_request(ttft_s, tokens):
    """One finished request: time to first token and tokens emitted."""
    with _lock:
        _gauges["requests"] += 1
        _gauges["tokens"] += int(tokens)
        _gauges["ttfts_s"].append(float(ttft_s))
        if len(_gauges["ttfts_s"]) > _TTFT_KEEP:
            del _gauges["ttfts_s"][:-_TTFT_KEEP]


def record_serving_tick(occupancy, queue_depth, busy_s, t0=None):
    """One decode step: fraction of slots active, queued requests, and the
    step's time from dispatch to after any flush (the reference's meaning:
    a step left in flight costs its dispatch only).  `t0`, the step's
    dispatch time on `time.perf_counter`'s clock, extends the decode window
    (the first step's dispatch to the last step's record), over which
    decode tokens/s is taken."""
    with _lock:
        g = _gauges
        if t0 is not None:
            if g["window_t0"] is None:
                g["window_t0"] = float(t0)
            g["window_t1"] = time.perf_counter()
        g["ticks"] += 1
        g["occupancy_sum"] += float(occupancy)
        g["occupancy_peak"] = max(g["occupancy_peak"], float(occupancy))
        g["queue_depth_sum"] += int(queue_depth)
        g["queue_depth_max"] = max(g["queue_depth_max"], int(queue_depth))
        g["busy_s"] += float(busy_s)


# serving fault-domain counter kinds (the reference's, profiler.py:160):
# engine restarts, requests failed by a restart, deadline evictions (the
# timeouts) and admission rejections, cancellations, non-finite logits
SERVING_FAULT_KINDS = (
    "restarts", "restarted_requests", "deadline_miss", "rejected_deadline",
    "cancelled", "nonfinite",
)


def record_serving_fault(kind, n=1):
    """Count one serving fault-domain event (SERVING_FAULT_KINDS; an
    unknown kind is counted too)."""
    with _lock:
        f = _gauges["faults"]
        f[kind] = f.get(kind, 0) + int(n)


def record_deadline_miss_rate(rate):
    """Publish the engine's deadline-miss-rate EWMA over terminal
    resolutions (the engine owns the blend)."""
    with _lock:
        _gauges["deadline_miss_rate"] = float(rate)


def record_host_fetch(n=1):
    """One device-to-host fetch of decode or verify tokens."""
    with _lock:
        _gauges["host_fetches"] += int(n)


def _pctl(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def serving_summary():
    """requests, tokens, tokens/s over the summed step times, decode steps
    and their summed times, the decode window's wall seconds, host fetches
    of decode tokens, TTFT p50/p95 (ms), mean and peak slot occupancy,
    queue depth avg/max, the deadline-miss rate and, once one happened,
    the fault-domain counters under "faults" (restarts,
    restarted_requests, deadline_miss: the timeouts, rejected_deadline,
    cancelled, nonfinite)."""
    with _lock:
        g = dict(_gauges)
        g["faults"] = dict(g["faults"])
        ttfts = sorted(g["ttfts_s"])
    window = (0.0 if g["window_t0"] is None
              else g["window_t1"] - g["window_t0"])
    out = {"requests": g["requests"], "tokens": g["tokens"],
           "decode_steps": g["ticks"], "decode_busy_s": g["busy_s"],
           "decode_window_s": window, "host_fetches": g["host_fetches"],
           "deadline_miss_rate": g["deadline_miss_rate"]}
    if g["faults"]:
        out["faults"] = dict(g["faults"])
    if g["busy_s"] > 0:
        out["tokens_per_s"] = g["tokens"] / g["busy_s"]
    if ttfts:
        out["ttft_p50_ms"] = _pctl(ttfts, 0.50) * 1e3
        out["ttft_p95_ms"] = _pctl(ttfts, 0.95) * 1e3
    if g["ticks"]:
        out["occupancy_mean"] = g["occupancy_sum"] / g["ticks"]
        out["occupancy_peak"] = g["occupancy_peak"]
        out["queue_depth_avg"] = g["queue_depth_sum"] / g["ticks"]
        out["queue_depth_max"] = g["queue_depth_max"]
    return out


def _reset_paging_locked():
    # a kind such as session_evictions appears once counted, and stays at
    # 0 after a reset, as in the reference's family (profiler.py:350, :368)
    for k in _paging:
        _paging[k] = 0
    _paging.update(
        prefix_hits=0, prefix_misses=0, prefill_tokens_saved=0, cow_copies=0,
        cache_evictions=0, cache_commits=0, ticks=0, pages_used_sum=0,
        pages_used_peak=0, pages_total=0,
    )


_reset_paging_locked()


def reset_paging():
    with _lock:
        _reset_paging_locked()


def record_prefix_lookup(hit, tokens_saved=0, cow_copies=0):
    """One admission-time prefix-cache lookup: whether a cached prefix was
    reused, how many prompt tokens skipped prefill, and how many shared
    pages were copied for the new reader."""
    with _lock:
        if hit:
            _paging["prefix_hits"] += 1
            _paging["prefill_tokens_saved"] += int(tokens_saved)
            _paging["cow_copies"] += int(cow_copies)
        else:
            _paging["prefix_misses"] += 1


def record_paging_event(kind, n=1):
    """Count an allocator event: 'cache_evictions', 'cache_commits' or
    'session_evictions' (another kind is counted too)."""
    with _lock:
        _paging[kind] = _paging.get(kind, 0) + int(n)


def record_paging_tick(pages_used, pages_total):
    """One decode step's page-pool occupancy: pages in use (held by slots
    or the prefix cache) out of the usable pages."""
    with _lock:
        g = _paging
        g["ticks"] += 1
        g["pages_used_sum"] += int(pages_used)
        g["pages_total"] = int(pages_total)
        g["pages_used_peak"] = max(g["pages_used_peak"], int(pages_used))


def paging_summary():
    """Prefix lookups, hits, hit rate, prefill tokens saved, COW copies,
    cache evictions and commits; keys appear once their events have."""
    with _lock:
        g = dict(_paging)
    out = {}
    lookups = g["prefix_hits"] + g["prefix_misses"]
    if lookups:
        out.update(prefix_lookups=lookups, prefix_hits=g["prefix_hits"],
                   prefix_hit_rate=g["prefix_hits"] / lookups,
                   prefill_tokens_saved=g["prefill_tokens_saved"],
                   cow_copies=g["cow_copies"])
    for k in ("cache_evictions", "cache_commits"):
        if g[k]:
            out[k] = g[k]
    return out


def _reset_kv_quant_locked():
    _kv_quant.update(mode="none", arena_bytes=0, scale_bytes=0, quantize=0,
                     dequantize=0)


_reset_kv_quant_locked()


def reset_kv_quant():
    with _lock:
        _reset_kv_quant_locked()


def record_kv_quant(mode, arena_bytes, scale_bytes):
    """The paged arena's storage precision and device bytes, all layers
    (engine construction; set, not summed)."""
    with _lock:
        _kv_quant.update(mode=str(mode), arena_bytes=int(arena_bytes),
                         scale_bytes=int(scale_bytes))


def record_kv_quant_event(kind, n=1):
    """Count int8 work: 'quantize' (K/V row pairs written through the
    quantizing scatters) or 'dequantize' (mapped pages a decode step's
    kernel dequantized), per layer."""
    with _lock:
        _kv_quant[kind] += int(n)


def kv_quant_summary():
    """The KV-quant descriptors and counters; {} while no int8 arena has
    been recorded."""
    with _lock:
        g = dict(_kv_quant)
    return {} if g["mode"] == "none" else g


def _reset_speculation_locked():
    _spec.update(steps=0, proposed=0, accepted=0, emitted=0, slot_steps=0)


_reset_speculation_locked()


def reset_speculation():
    with _lock:
        _reset_speculation_locked()


def record_speculation(proposed, accepted, emitted, slots):
    """One speculative verify step: drafts proposed and accepted across the
    batch, tokens emitted, and how many active slots took part."""
    with _lock:
        _spec["steps"] += 1
        _spec["proposed"] += int(proposed)
        _spec["accepted"] += int(accepted)
        _spec["emitted"] += int(emitted)
        _spec["slot_steps"] += int(slots)


def speculation_summary():
    """Verify steps, drafts proposed and accepted, tokens emitted,
    acceptance_rate (accepted / proposed) and tokens_per_step (emitted per
    slot-step; 1.0 is the plain engine).  {} before any verify step."""
    with _lock:
        g = dict(_spec)
    if not g["steps"]:
        return {}
    out = {k: g[k] for k in ("steps", "proposed", "accepted", "emitted")}
    if g["proposed"]:
        out["acceptance_rate"] = g["accepted"] / g["proposed"]
    if g["slot_steps"]:
        out["tokens_per_step"] = g["emitted"] / g["slot_steps"]
    return out


def _reset_mesh_locked():
    _mesh.update(devices=0, tp=1, cp=1, allreduce_per_step=0)


_reset_mesh_locked()


def reset_mesh():
    with _lock:
        _reset_mesh_locked()


def record_mesh_topology(devices, tp, allreduce_per_step, cp=1):
    """The serving engine's layout (construction; set, not summed): cards
    used, tensor- and context-parallel degrees, and the cross-shard merges
    per decode step (one softmax-partials combine per layer under cp, the
    reference's all-reduces; on one card they run as torch ops)."""
    with _lock:
        _mesh.update(devices=int(devices), tp=int(tp), cp=int(cp),
                     allreduce_per_step=int(allreduce_per_step))


def mesh_summary():
    """The recorded layout; {} until an engine has recorded one."""
    with _lock:
        g = dict(_mesh)
    return g if g["devices"] else {}


# the reference's router counters (profiler.py:682-702), in its order
ROUTER_KEYS = ("requests", "retries", "failovers", "breaker_trips",
               "breaker_half_open", "breaker_closes", "hedges", "hedge_wins",
               "brownout_sheds", "deadline_sheds", "no_replica", "idem_hits",
               "idem_joins", "journal_appends", "journal_compactions",
               "journal_torn_records", "takeovers", "crashes")


def _reset_router_locked():
    # zero every key, the ones counted beside ROUTER_KEYS too (the
    # reference's reset keeps them at 0)
    for k in list(_router):
        _router[k] = {} if k == "replica_states" else 0
    if not _router:
        _router.update(dict.fromkeys(ROUTER_KEYS, 0), replica_states={})


_reset_router_locked()


def reset_router():
    with _lock:
        _reset_router_locked()


def record_router_event(kind, n=1):
    """Count one front-door event: one of `ROUTER_KEYS` (the router's
    requests, retries, failovers, breaker transitions, hedges, sheds,
    idempotent replays and joins, journal appends, compactions and torn
    records, takeovers and crashes), or the router's session pins
    ('session_pin_hits', 'session_repins'); another kind is counted too."""
    with _lock:
        _router[kind] = _router.get(kind, 0) + int(n)


def record_router_replica_state(replica_id, state):
    """The last observed state of one replica (ready, draining, ...)."""
    with _lock:
        _router["replica_states"][str(replica_id)] = str(state)


def router_summary():
    """The router counters and the replica states by id."""
    with _lock:
        g = dict(_router)
        g["replica_states"] = dict(g["replica_states"])
        return g


# -- the reference's other families: their keys, for /metrics and the
# flight header; recorded once their ROADMAP items land -----------------


def _reset_step_locked():
    _step.update(steps=0, dispatch_s=0.0, host_blocked_s=0.0, wall_s=0.0,
                 inflight_sum=0, inflight_max=0)


def record_step(dispatch_s=0.0, host_blocked_s=0.0, inflight=0, wall_s=0.0):
    """One training step's host-time split (dispatching, blocked on the
    card), its wall time and the in-flight depth of the step ring."""
    with _lock:
        g = _step
        g["steps"] += 1
        g["dispatch_s"] += float(dispatch_s)
        g["host_blocked_s"] += float(host_blocked_s)
        g["wall_s"] += float(wall_s)
        g["inflight_sum"] += int(inflight)
        g["inflight_max"] = max(g["inflight_max"], int(inflight))


def _reset_lora_locked():
    _lora.clear()
    _lora.update(loads=0, evictions=0, residency_hits=0, residency_misses=0,
                 resident=0, capacity=0)


def record_lora_event(kind, n=1):
    """Count one adapter-arena event: 'loads', 'evictions',
    'residency_hits' or 'residency_misses' (another kind is counted too)."""
    with _lock:
        _lora[kind] = _lora.get(kind, 0) + int(n)


def record_lora_residency(resident, capacity):
    """The adapters resident in the arena and its slots (set)."""
    with _lock:
        _lora.update(resident=int(resident), capacity=int(capacity))


def reset_lora():
    """Zero the LoRA counters and gauges (reference: profiler.py:651)."""
    with _lock:
        _reset_lora_locked()


def lora_summary():
    """Loads, evictions, resident, capacity and the residency hit rate;
    {} before any acquire."""
    with _lock:
        g = dict(_lora)
    lookups = g["residency_hits"] + g["residency_misses"]
    if not lookups and not g["loads"]:
        return {}
    out = {k: g[k] for k in ("loads", "evictions", "resident", "capacity")}
    if lookups:
        out["residency_lookups"] = lookups
        out["residency_hit_rate"] = g["residency_hits"] / lookups
    return out


def _reset_autoscale_locked():
    _autoscale.clear()
    _autoscale.update(ticks=0, scale_ups=0, scale_downs=0, holds=0,
                      spawn_failures=0, reaps=0, replicas=0, replicas_peak=0)


def reset_autoscale():
    """Zero the autoscaler's counters and gauges."""
    with _lock:
        _reset_autoscale_locked()


def record_autoscale_event(kind, n=1):
    """Count one autoscaler event: 'ticks', 'scale_ups', 'scale_downs',
    'holds', 'spawn_failures' or 'reaps' (another kind is counted too)."""
    with _lock:
        _autoscale[kind] = _autoscale.get(kind, 0) + int(n)


def record_autoscale_replicas(n):
    """The fleet size under the autoscaler (set) and its peak."""
    with _lock:
        _autoscale["replicas"] = int(n)
        _autoscale["replicas_peak"] = max(_autoscale["replicas_peak"], int(n))


def autoscale_summary():
    """The autoscaler's counters; {} until the control loop has acted."""
    with _lock:
        g = dict(_autoscale)
    return g if g["ticks"] or g["scale_ups"] or g["scale_downs"] else {}


def _reset_disagg_locked():
    _disagg.clear()
    _disagg.update(exports=0, imports=0, import_pages=0, handoff_bytes=0,
                   pair_picks=0, handoff_retries=0, reserve_fails=0,
                   no_decode_capacity=0)


def reset_disagg():
    """Zero the handoff counters."""
    with _lock:
        _reset_disagg_locked()


def record_disagg_event(kind, n=1):
    """Count one disaggregated-serving event (reference: profiler.py:
    817-835): the engine's 'exports', 'handoff_bytes' (raw row bytes of
    each export), 'imports' and 'import_pages'; the router's 'pair_picks',
    'handoff_retries', 'reserve_fails' and 'no_decode_capacity' (another
    kind is counted too)."""
    with _lock:
        _disagg[kind] = _disagg.get(kind, 0) + int(n)


def disagg_summary():
    """The handoff counters; {} before any handoff traffic."""
    with _lock:
        g = dict(_disagg)
    return g if any(g.values()) else {}


_SESSION_KEYS = ("sessions_resident", "session_tenants", "session_pages_pinned",
                 "session_prefill_tokens_saved_total", "session_evictions_total",
                 "session_binds_total")


def _reset_sessions_locked():
    _sessions.update(dict.fromkeys(_SESSION_KEYS, 0))


def record_session_stats(stats):
    """Fold one session store's stats() dict into the session gauges (its
    keys of `_SESSION_KEYS`, set)."""
    with _lock:
        for k in _SESSION_KEYS:
            if k in stats:
                _sessions[k] = int(stats[k])


def session_summary():
    """The session gauges; {} until a session store has pushed one."""
    with _lock:
        g = dict(_sessions)
    return g if any(g.values()) else {}


for _reset_fn in (_reset_step_locked, _reset_lora_locked,
                  _reset_autoscale_locked, _reset_disagg_locked,
                  _reset_sessions_locked):
    _reset_fn()


# -- the kernels' dispatch counts (per trace) and fallbacks ----------------


def record_flash_fallback(reason):
    """One attention call that took the plain path instead of a kernel,
    by reason (`ops.flash_attention.fallback_counts`)."""
    with _lock:
        fc = _fa.fallback_counts
        fc[reason] = fc.get(reason, 0) + 1


def flash_fallback_summary():
    """{reason: count} of the fallbacks since the last reset (non-zero
    reasons only)."""
    with _lock:
        return {k: v for k, v in _fa.fallback_counts.items() if v}


def reset_flash_fallbacks():
    with _lock:
        _fa.reset_fallback_counts()


def record_flash_pallas_call(kernel):
    """One kernel dispatch by the reference's kernel name, counted per
    compiled shape (`ops.flash_attention.pallas_calls`)."""
    with _lock:
        pc = _fa.pallas_calls
        pc[kernel] = pc.get(kernel, 0) + 1


def flash_pallas_summary():
    """{kernel: count} of the dispatches since the last reset (non-zero
    kernels only)."""
    with _lock:
        return {k: v for k, v in _fa.pallas_calls.items() if v}


def reset_flash_pallas():
    with _lock:
        _fa.reset_pallas_calls()


def reset():
    """Zero every counter family (serving, paging, KV quant, speculation,
    mesh, router, step, LoRA, autoscale, disagg, sessions, the flash
    dispatch and fallback counts) in one critical section; the older
    families' reset_*() helpers stay for callers that keep the others."""
    with _lock:
        _reset_locked()
        _reset_paging_locked()
        _reset_kv_quant_locked()
        _reset_speculation_locked()
        _reset_mesh_locked()
        _reset_router_locked()
        _reset_step_locked()
        _reset_lora_locked()
        _reset_autoscale_locked()
        _reset_disagg_locked()
        _reset_sessions_locked()
        _fa.reset_fallback_counts()
        _fa.reset_pallas_calls()


def metrics_snapshot():
    """One raw snapshot of every family under one lock, for the /metrics
    renderer (`obs.metrics`); unlike the *_summary() helpers it never
    leaves a zero out.  `flash_fallbacks` and `flash_pallas` hold the
    non-zero counts (the renderer zero-fills the known label sets)."""
    with _lock:
        serving = dict(_gauges)
        serving["ttfts_s"] = list(serving["ttfts_s"])
        serving["faults"] = dict(serving["faults"])
        router = dict(_router)
        router["replica_states"] = dict(router["replica_states"])
        return {
            "step": dict(_step), "serving": serving, "paging": dict(_paging),
            "speculation": dict(_spec), "lora": dict(_lora), "router": router,
            "autoscale": dict(_autoscale), "disagg": dict(_disagg),
            "mesh": dict(_mesh), "kv_quant": dict(_kv_quant),
            "sessions": dict(_sessions),
            "flash_fallbacks": {k: v for k, v in _fa.fallback_counts.items() if v},
            "flash_pallas": {k: v for k, v in _fa.pallas_calls.items() if v},
        }


def kernel_launch_counts():
    """Launches of each hand-written kernel since the last reset."""
    return {**_fa.launch_counts, **_optim.launch_counts}


def reset_kernel_launch_counts():
    _fa.reset_launch_counts()
    _optim.reset_launch_counts()


def summary():
    """The serving, paging, KV-quant, speculation, mesh and router summaries
    and the kernel launch counts in one dict."""
    return {"serving": serving_summary(), "paging": paging_summary(),
            "kv_quant": kv_quant_summary(),
            "speculation": speculation_summary(), "mesh": mesh_summary(),
            "router": router_summary(),
            "kernel_launches": kernel_launch_counts()}
