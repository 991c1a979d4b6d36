"""Observability spine of the port (counterpart of `paddle_tpu/obs`):
request tracing, the Prometheus `/metrics` exposition and the flight
recorder.

Three host-side-only pieces that share one design rule: nothing in here
may touch a tensor, run inside a captured step, or force a device sync.
Every hook sits in the host code around a step's dispatch and its token
fetch, never in a `StepGraph` body (which runs only when the step is
traced), so tracing adds no trace of a step and no host fetch.

- ``obs.trace``   trace contexts minted at the first hop and carried as
  ``X-Trace-Id`` / ``X-Parent-Span`` beside ``X-Deadline-Ms``, with
  per-stage spans recorded into a bounded lock-safe buffer; exported as a
  span tree (``GET /trace/<id>``) or Chrome-trace / Perfetto JSON.
- ``obs.metrics`` a Prometheus text renderer over every profiler counter
  family, the kernels' per-trace dispatch and fallback counts, and the obs
  buffers themselves, served from ``GET /metrics`` by ``serve()``.
- ``obs.flight``  a fixed-size ring of recent structured events (fault
  firings, watchdog trips, restarts, admission refusals, terminal span
  completions) dumped as JSONL by watchdog trips, supervisor restarts and
  the drain.

Gated by ``FLAGS_trace`` (span recording on or off; metrics and the
flight ring are always live) and sized by ``FLAGS_obs_buffer_events``.
"""

from . import flight, metrics, trace  # noqa: F401
from .trace import (  # noqa: F401
    HDR_PARENT,
    HDR_TRACE,
    chrome_trace,
    ctx_from_headers,
    enabled,
    new_span_id,
    new_trace_id,
    record,
    span,
    spans,
    tree,
)
