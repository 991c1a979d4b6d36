"""Serving gauges and kernel launch counts of the port (counterpart of the
serving part of `paddle_tpu/profiler.py`).

The engine records one entry per finished request and one per decode step;
`serving_summary()` aggregates them with the reference's key names.
`kernel_launch_counts()` reads every hand-written kernel's launches
(`flash_fwd`, `paged_decode_fused`, `flash_bwd`); `summary()` holds both.
"""

from __future__ import annotations

import threading

from .ops import flash_attention as _fa

_TTFT_KEEP = 10000  # bound the percentile buffer; serving runs are long

_lock = threading.Lock()
_gauges = {}


def _reset_locked():
    _gauges.update(
        requests=0, tokens=0, ttfts_s=[], busy_s=0.0, ticks=0,
        occupancy_sum=0.0, occupancy_peak=0.0, queue_depth_sum=0,
        queue_depth_max=0,
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


def record_serving_tick(occupancy, queue_depth, busy_s):
    """One decode step: fraction of slots active, queued requests, and the
    step's wall time (summed into the busy window for tokens/s)."""
    with _lock:
        g = _gauges
        g["ticks"] += 1
        g["occupancy_sum"] += float(occupancy)
        g["occupancy_peak"] = max(g["occupancy_peak"], float(occupancy))
        g["queue_depth_sum"] += int(queue_depth)
        g["queue_depth_max"] = max(g["queue_depth_max"], int(queue_depth))
        g["busy_s"] += float(busy_s)


def _pctl(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(round(q * (len(sorted_vals) - 1))))
    return sorted_vals[i]


def serving_summary():
    """requests, tokens, tokens/s over the decode busy window, decode steps
    and their summed wall time, TTFT p50/p95 (ms), mean and peak slot
    occupancy, queue depth avg/max."""
    with _lock:
        g = dict(_gauges)
        ttfts = sorted(g["ttfts_s"])
    out = {"requests": g["requests"], "tokens": g["tokens"],
           "decode_steps": g["ticks"], "decode_busy_s": g["busy_s"]}
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


def kernel_launch_counts():
    """Launches of each hand-written kernel since the last reset."""
    return dict(_fa.launch_counts)


def reset_kernel_launch_counts():
    _fa.reset_launch_counts()


def summary():
    """The serving summary and the kernel launch counts in one dict."""
    return {"serving": serving_summary(), "kernel_launches": kernel_launch_counts()}
