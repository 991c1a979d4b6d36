"""Request tracing: mint, propagate, record, export (counterpart of
`paddle_tpu/obs/trace.py`).

A trace context is the pair ``(trace_id, parent_span_id)``.  The first
hop that sees a request mints a ``trace_id``; every stage records a
*completed* span (name, two ``perf_counter`` stamps, status, small attrs)
into one bounded module-level buffer guarded by one lock.  Recording is a
dict append on the host: it never touches a tensor and never syncs the
card.  Attributes are strings and numbers only, never a request, an
engine or a tensor, so a buffered span keeps nothing else alive.

Span recording is a no-op unless ``FLAGS_trace`` is set.  Minting is
always on: error bodies carry a ``trace_id`` with recording off, so a
failure can be joined to its span tree once tracing is enabled.  Ids are
16 hex characters from ``os.urandom`` (or an explicit ``random.Random``),
never from a torch generator: the serving sampler's generator must not
move because a request was traced.

Hop headers, beside ``X-Deadline-Ms``:

    X-Trace-Id:    16-hex trace id, the same for every hop of one request
    X-Parent-Span: span id of the caller's enclosing span

The buffer is read as flat spans (``spans``), a per-request tree
(``tree``, served on ``GET /trace/<id>``), or Chrome-trace / Perfetto JSON
(``chrome_trace``).
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time

from ..framework import core as _core
from . import flight as _flight

HDR_TRACE = "X-Trace-Id"
HDR_PARENT = "X-Parent-Span"

_DEFAULT_CAPACITY = 4096

# one lock for every mutation of the span buffer and its counters; nothing
# is called while holding it
_mu = threading.Lock()
_spans = collections.deque(maxlen=_DEFAULT_CAPACITY)
_capacity = _DEFAULT_CAPACITY
_recorded = 0
_dropped = 0

# perf_counter -> wall-clock anchor, taken once: spans carry monotonic
# stamps at the call sites but export epoch-based timestamps, so traces of
# separate processes line up on one timeline
_T0_WALL = time.time()
_T0_PERF = time.perf_counter()


def enabled():
    """Span recording on?  (``FLAGS_trace``; minting ids is always on.)"""
    return bool(_core.flag("FLAGS_trace"))


def _hex_id(rng):
    if rng is None:
        return os.urandom(8).hex()
    return f"{rng.getrandbits(64):016x}"


def new_trace_id(rng=None):
    """16 hex characters from ``os.urandom``, or from ``rng`` (a
    ``random.Random``) when given."""
    return _hex_id(rng)


def new_span_id(rng=None):
    return _hex_id(rng)


def ctx_from_headers(headers):
    """An incoming hop's trace context from its HTTP headers:
    ``(trace_id, parent_span_id)``, or None when the caller sent no
    ``X-Trace-Id`` (the receiver then mints a root context)."""
    if headers is None:
        return None
    tid = headers.get(HDR_TRACE)
    if not tid:
        return None
    return (str(tid), str(headers.get(HDR_PARENT) or ""))


def _ensure_capacity_locked():
    global _spans, _capacity
    cap = max(16, int(_core.flag("FLAGS_obs_buffer_events")))
    if cap != _capacity:
        _spans = collections.deque(_spans, maxlen=cap)
        _capacity = cap


def record(name, trace_id, *, t0, t1, span_id=None, parent_id=None,
           status="ok", **attrs):
    """Record one completed span from two ``perf_counter`` stamps.

    Returns the span id (minted when not given), so a caller can pre-mint
    one with ``new_span_id()``, hand it to children and record the parent
    last.  A no-op (returning ``span_id`` or "") unless ``FLAGS_trace`` is
    on.  Attributes that are None are left out.
    """
    if not trace_id or not enabled():
        return span_id or ""
    sid = span_id or new_span_id()
    rec = {
        "name": str(name),
        "trace_id": str(trace_id),
        "span_id": sid,
        "parent_id": str(parent_id or ""),
        "ts": _T0_WALL + (t0 - _T0_PERF),
        "dur_s": max(0.0, t1 - t0),
        "status": str(status),
        "pid": os.getpid(),
        "thread": threading.current_thread().name,
    }
    clean = {k: v for k, v in attrs.items() if v is not None}
    if clean:
        rec["attrs"] = clean
    global _recorded, _dropped
    with _mu:
        _ensure_capacity_locked()
        if len(_spans) == _spans.maxlen:
            _dropped += 1
        _spans.append(rec)
        _recorded += 1
    # the request-terminal kinds go to the flight ring too, after _mu is
    # released (one lock at a time: no order between the two)
    _flight.note_span(rec)
    return sid


class _OpenSpan:
    """The handle ``span()`` yields: set attrs or status before exit."""

    __slots__ = ("span_id", "status", "attrs")

    def __init__(self, span_id):
        self.span_id = span_id
        self.status = "ok"
        self.attrs = {}


@contextlib.contextmanager
def span(name, trace_id, parent_id=None, span_id=None, **attrs):
    """Record one span around a block.  The id is minted at entry so the
    block can hand it to children (``s.span_id``); an exception marks the
    span ``error`` and propagates."""
    s = _OpenSpan(span_id or new_span_id())
    s.attrs.update(attrs)
    t0 = time.perf_counter()
    try:
        yield s
    except BaseException:
        s.status = "error"
        raise
    finally:
        record(name, trace_id, t0=t0, t1=time.perf_counter(),
               span_id=s.span_id, parent_id=parent_id, status=s.status,
               **s.attrs)


def spans(trace_id=None):
    """A flat copy of the buffered spans, of one trace when given."""
    with _mu:
        out = list(_spans)
    if trace_id:
        out = [s for s in out if s["trace_id"] == trace_id]
    return out


def trace_ids():
    """Distinct buffered trace ids, the most recent last."""
    return list(dict.fromkeys(s["trace_id"] for s in spans()))


def tree(trace_id):
    """The span tree of one trace, for ``GET /trace/<id>``: a list of root
    nodes (spans whose parent is not buffered: remote, or the client's),
    each a span dict with ``children`` sorted by start time."""
    flat = sorted(spans(trace_id), key=lambda s: (s["ts"], s["span_id"]))
    nodes = {s["span_id"]: dict(s, children=[]) for s in flat}
    roots = []
    for s in flat:
        node = nodes[s["span_id"]]
        parent = nodes.get(s["parent_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return roots


def chrome_trace(trace_id=None):
    """Chrome-trace / Perfetto JSON (``chrome://tracing``,
    ui.perfetto.dev)."""
    events = []
    for s in spans(trace_id):
        args = dict(s.get("attrs", {}))
        args.update(trace_id=s["trace_id"], span_id=s["span_id"],
                    parent_id=s["parent_id"], status=s["status"])
        events.append({
            "name": s["name"], "cat": "paddle_tpu_torch", "ph": "X",
            "ts": s["ts"] * 1e6, "dur": s["dur_s"] * 1e6,
            "pid": s["pid"], "tid": s["thread"], "args": args,
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def stats():
    """The buffer's counters for /metrics: recorded, dropped, buffered."""
    with _mu:
        return {"spans_recorded": _recorded, "spans_dropped": _dropped,
                "spans_buffered": len(_spans)}


def reset():
    global _recorded, _dropped
    with _mu:
        _spans.clear()
        _recorded = 0
        _dropped = 0
