"""Serving gauges and kernel launch counts of the port (counterpart of the
serving, paging and KV-quant parts of `paddle_tpu/profiler.py`).

The engine records one entry per finished request and one per decode step;
`serving_summary()` aggregates them with the reference's key names.
`paging_summary()` holds the prefix cache's lookups, hits, prompt tokens
saved, copy-on-write copies, commits and evictions;
`kv_quant_summary()` the arena's storage precision and bytes;
`speculation_summary()` the verify steps' drafts proposed, accepted and
tokens emitted; `mesh_summary()` the serving engine's parallel layout.
`kernel_launch_counts()` reads every hand-written kernel's launches
(`flash_fwd`, `paged_decode_fused`, `paged_decode_fused_q8`, `flash_bwd`,
`dense_decode`, `paged_decode_fused_cp`, `paged_decode_fused_cp_q8`);
`summary()` holds them all.
"""

from __future__ import annotations

import threading
import time

from .ops import flash_attention as _fa

_TTFT_KEEP = 10000  # bound the percentile buffer; serving runs are long

_lock = threading.Lock()
_gauges = {}
_paging = {}
_kv_quant = {}
_spec = {}
_mesh = {}


def _reset_locked():
    _gauges.update(
        requests=0, tokens=0, ttfts_s=[], busy_s=0.0, ticks=0,
        occupancy_sum=0.0, occupancy_peak=0.0, queue_depth_sum=0,
        queue_depth_max=0, window_t0=None, window_t1=None, host_fetches=0,
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
    queue depth avg/max."""
    with _lock:
        g = dict(_gauges)
        ttfts = sorted(g["ttfts_s"])
    window = (0.0 if g["window_t0"] is None
              else g["window_t1"] - g["window_t0"])
    out = {"requests": g["requests"], "tokens": g["tokens"],
           "decode_steps": g["ticks"], "decode_busy_s": g["busy_s"],
           "decode_window_s": window, "host_fetches": g["host_fetches"]}
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
    _paging.update(
        prefix_hits=0, prefix_misses=0, prefill_tokens_saved=0, cow_copies=0,
        cache_evictions=0, cache_commits=0,
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
    """Count an allocator event: 'cache_evictions' or 'cache_commits'."""
    with _lock:
        _paging[kind] += int(n)


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


def kernel_launch_counts():
    """Launches of each hand-written kernel since the last reset."""
    return dict(_fa.launch_counts)


def reset_kernel_launch_counts():
    _fa.reset_launch_counts()


def summary():
    """The serving, paging, KV-quant, speculation and mesh summaries and the
    kernel launch counts in one dict."""
    return {"serving": serving_summary(), "paging": paging_summary(),
            "kv_quant": kv_quant_summary(),
            "speculation": speculation_summary(), "mesh": mesh_summary(),
            "kernel_launches": kernel_launch_counts()}
