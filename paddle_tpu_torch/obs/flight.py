"""Crash flight recorder: a bounded ring of recent structured events
(counterpart of `paddle_tpu/obs/flight.py`).

Every notable runtime event (fault-point firings, watchdog trips, engine
restarts, admission refusals, request-terminal span completions) lands in
one fixed-size in-memory ring of ``FLAGS_obs_buffer_events`` entries.  The
ring costs a lock and a dict append per event and is always on; it only
touches disk when a fault path asks for a post-mortem with
``dump(reason)``, which writes the whole ring as JSONL to:

    $PADDLE_OBS_DIR                    when set (tests, operators), else
    $PADDLE_CKPT_DIR + "_flightrec"    beside the checkpoints, else
    <tmpdir>/paddle_flightrec

Dumps are written by watchdog trips (``fault/watchdog.py``),
``EngineSupervisor`` restarts and budget exhaustion
(``fault/supervisor.py``) and the serving drain (``inference.serve``).
The format is one JSON object per line: a header (``kind`` "header",
``reason``, pid, ``armed``: the last watchdog arm per region, and the
profiler's descriptors at the time) followed by the ring, oldest first.

Events hold strings and numbers only, never a request, an engine, a
tensor or a watchdog region: the ring outlives all of them.  Nothing here
makes a CUDA call, so the watchdog's monitor thread may dump.  ``record``
and ``dump`` never raise: they run on fault paths that must go on.
"""

from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import threading
import time

from .. import profiler as _prof
from ..framework import core as _core

_DEFAULT_CAPACITY = 4096

_mu = threading.Lock()
_events = collections.deque(maxlen=_DEFAULT_CAPACITY)
_capacity = _DEFAULT_CAPACITY
_total = 0
_dumps = 0
_last_dump = None
# region -> {"t", "context"}: the LAST watchdog arm per region.  Decode and
# fetch arm every scheduler step, so as ring events they would evict
# everything else; a per-region gauge keeps "what was armed when it died"
# in every dump header at O(regions) cost
_armed = {}

# span names mirrored into the ring when they complete (trace.record calls
# note_span for every span; only request-terminal ones ride the ring)
_SPAN_KINDS = ("router.admit", "serve.handle", "replica.forward",
               "fit.window", "router.takeover")


def _ensure_capacity_locked():
    global _events, _capacity
    cap = max(16, int(_core.flag("FLAGS_obs_buffer_events")))
    if cap != _capacity:
        _events = collections.deque(_events, maxlen=cap)
        _capacity = cap


def record(kind, detail="", **fields):
    """Append one structured event to the ring (always on, never raises).
    Fields that are None are left out."""
    global _total
    try:
        ev = {"t": time.time(), "kind": str(kind), "detail": str(detail)}
        for k, v in fields.items():
            if v is not None:
                ev[str(k)] = v
        with _mu:
            _ensure_capacity_locked()
            _events.append(ev)
            _total += 1
    except Exception:
        pass


def note_span(span_rec):
    """Mirror a request-terminal span completion into the ring (called by
    ``trace.record``)."""
    if span_rec.get("name") not in _SPAN_KINDS:
        return
    record("span", span_rec["name"], trace_id=span_rec.get("trace_id"),
           span_id=span_rec.get("span_id"), status=span_rec.get("status"),
           dur_ms=round(span_rec.get("dur_s", 0.0) * 1e3, 3))


def note_arm(region, context=None):
    """Remember the latest watchdog arm of a region (dumped in the
    header), a gauge rather than a ring event."""
    try:
        with _mu:
            _armed[str(region)] = {"t": time.time(),
                                   "context": str(context or "")}
    except Exception:
        pass


def events(n=None):
    """A copy of the ring, oldest first (the last `n` when given)."""
    with _mu:
        out = list(_events)
    return out[-n:] if n else out


def stats():
    """events_total, dumps_total (monotonic across reset()) and
    events_buffered."""
    with _mu:
        return {"events_total": _total, "dumps_total": _dumps,
                "events_buffered": len(_events)}


def last_dump_path():
    with _mu:
        return _last_dump


def dump_dir():
    d = os.environ.get("PADDLE_OBS_DIR")
    if d:
        return d
    ckpt = os.environ.get("PADDLE_CKPT_DIR")
    if ckpt:
        return ckpt.rstrip("/\\") + "_flightrec"
    return os.path.join(tempfile.gettempdir(), "paddle_flightrec")


def _header_sections():
    """The profiler's descriptors at dump time, each section present only
    once its family has something to say (the reference's header)."""
    out = {}
    for key, fn in (("speculation", _prof.speculation_summary),
                    ("lora", _prof.lora_summary),
                    ("mesh", _prof.mesh_summary),
                    ("sessions", _prof.session_summary),
                    ("autoscale", _prof.autoscale_summary),
                    ("kv_quant", _prof.kv_quant_summary),
                    ("disagg", _prof.disagg_summary)):
        section = fn()
        if section:
            out[key] = section
    # kernel dispatch at death: "was the hot path on the kernels or on a
    # fallback" is the first question of a slow-down post-mortem
    out["flash"] = {"pallas": _prof.flash_pallas_summary(),
                    "fallbacks": _prof.flash_fallback_summary()}
    return out


def dump(reason, path=None):
    """Write the ring as JSONL; returns the path, or None on any failure.
    Runs on fault paths: it never raises and blocks on nothing but the
    local disk."""
    global _dumps, _last_dump
    try:
        with _mu:
            ring = list(_events)
            armed = {k: dict(v) for k, v in _armed.items()}
            _dumps += 1
            seq = _dumps
        if path is None:
            d = dump_dir()
            os.makedirs(d, exist_ok=True)
            safe = re.sub(r"[^A-Za-z0-9._-]+", "-", str(reason))[:64] or "dump"
            path = os.path.join(d, f"flight-{os.getpid()}-{seq:03d}-{safe}.jsonl")
        header = {"kind": "header", "reason": str(reason), "t": time.time(),
                  "pid": os.getpid(), "events": len(ring), "armed": armed}
        try:
            header.update(_header_sections())
        except Exception:
            pass
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in ring:
                f.write(json.dumps(ev, default=str) + "\n")
        with _mu:
            _last_dump = path
        return path
    except Exception:
        return None


def reset():
    """Clear the ring and the armed gauge (tests); the dump count stays
    monotonic."""
    global _last_dump
    with _mu:
        _events.clear()
        _armed.clear()
        _last_dump = None
