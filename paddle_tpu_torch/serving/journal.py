"""The idempotency cache of `serve()` (counterpart of `IdempotencyCache` in
`paddle_tpu/serving/journal.py:385-523`, without the durable journal: the
port has no router to rehydrate a successor from).

A `/generate` carrying `X-Idempotency-Key` completes into this cache
before its response bytes go out, so a connection reset after the
generation finished leaves the response replayable: the client's retry
gets the same bytes, not a second generation.
"""

from __future__ import annotations

import threading
import time

from .. import profiler as _prof
from ..framework import core as _core


class IdempotencyCache:
    """TTL'd completed-response cache and in-flight join, keyed by the
    client's idempotency key.

    ``begin(key)`` returns one of three verdicts:

      ("new", None)     -- first sight: the caller executes the request and
                           must finish with ``complete`` or ``abandon``
      ("join", entry)   -- the key is live right now: ``wait(entry)`` blocks
                           until the live request completes and returns its
                           exact response (one generation, equal answers)
      ("done", resp)    -- a completed response inside the TTL: replay it

    Only terminal outcomes are kept: 200s and non-retriable typed errors.
    A retriable error (a 503 shed) wakes joiners with the response but
    drops the entry, so a later retry executes again: caching a shed would
    turn one overload into a permanent failure.  All state lives under one
    lock; entries change only under it."""

    class _Entry:
        __slots__ = ("event", "response", "done", "t_done")

        def __init__(self):
            self.event = threading.Event()
            self.response = None  # (status, body, headers)
            self.done = False
            self.t_done = 0.0

    def __init__(self, ttl_s=None):
        self.ttl_s = float(
            ttl_s if ttl_s is not None else _core.flag("FLAGS_router_idem_ttl")
        )
        self._mu = threading.Lock()
        self._entries = {}

    def begin(self, key, now=None):
        now = time.time() if now is None else now
        with self._mu:
            self._purge_locked(now)
            entry = self._entries.get(key)
            if entry is None:
                self._entries[key] = self._Entry()
                out = ("new", None)
            elif not entry.done:
                out = ("join", entry)
            else:
                out = ("done", entry.response)
        if out[0] == "join":
            _prof.record_router_event("idem_joins")
        elif out[0] == "done":
            _prof.record_router_event("idem_hits")
        return out

    def wait(self, entry, timeout=600.0):
        """Block on a joined entry; returns its (status, body, headers)
        response, or None when the live request abandoned or the wait timed
        out (the caller answers a retriable error)."""
        if not entry.event.wait(timeout):
            return None
        with self._mu:
            return entry.response

    def complete(self, key, status, body, headers=None, now=None):
        """The terminal outcome of a key: wake joiners with the exact
        response; keep it only when replaying it later is correct.  Returns
        True when the response was kept."""
        now = time.time() if now is None else now
        retain = status == 200 or (
            isinstance(body, dict) and body.get("retriable") is False
        )
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._Entry()
                self._entries[key] = entry
            entry.response = (status, body, dict(headers or {}))
            entry.done = True
            entry.t_done = now
            if not retain:
                self._entries.pop(key, None)
            entry.event.set()
        return retain

    def abandon(self, key):
        """The live request died without a terminal response (a raising
        handler): drop the entry and wake joiners with no response, so their
        keyed retries execute again."""
        with self._mu:
            entry = self._entries.pop(key, None)
            if entry is not None:
                entry.event.set()

    def _purge_locked(self, now):
        dead = [k for k, e in self._entries.items()
                if e.done and now - e.t_done > self.ttl_s]
        for k in dead:
            del self._entries[k]
