"""Hang watchdog: deadline-tracked blocking regions, with a stack dump on
expiry (counterpart of `paddle_tpu/fault/watchdog.py`, its serving use).

`Watchdog.arm(region, timeout, context)` (a context manager) registers a
deadline with one monitor thread; a region that overruns dumps every
Python thread's stack and the recent fault events to stderr, then acts:

``raise``  (default) mark the region; :class:`WatchdogTimeout` is raised
           from the arming thread when the blocked call returns.
callable   invoked as ``action(region, timeout)``: the serving engine
           records the trip and its `EngineSupervisor` restarts it.

The reference's default ``exit`` action (exit 75 after an ABORT marker
for the launch controller) comes with the heartbeat files (ROADMAP Queue
1, item 17).

The monitor thread makes no CUDA call, before, during or after a trip: it
reads the host clock, formats Python stacks and calls the action, which
must not touch the device either.  A CUDA call there would join a stream
capture running on the scheduler thread (and invalidate it), or block
behind the very stream that is wedged.

A timeout <= 0 disables a region: it costs no lock.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import sys
import threading
import time
import traceback

logger = logging.getLogger("paddle_tpu_torch")

EVENT_DUMP_N = 32  # fault events included in a timeout dump


class WatchdogTimeout(TimeoutError):
    """A watchdog-armed region exceeded its deadline."""

    def __init__(self, region, timeout):
        self.region = region
        self.timeout = timeout
        super().__init__(
            f"watchdog: region {region!r} exceeded {timeout:.1f}s; thread "
            "stacks were dumped to stderr"
        )


def dump_stacks(file=None, note=""):
    """Write every Python thread's stack and the recent fault events to
    `file` (stderr)."""
    from . import injection as _inj

    file = file or sys.stderr
    lines = [f"[watchdog] {note}" if note else "[watchdog] thread dump"]
    names = {t.ident: t.name for t in threading.enumerate()}
    for tid, frame in sys._current_frames().items():
        lines.append(f"--- thread {names.get(tid, '?')} (id {tid}) ---")
        lines.extend(l.rstrip() for l in traceback.format_stack(frame))
    events = _inj.recent_events(EVENT_DUMP_N)
    lines.append(f"--- last {len(events)} fault events ---")
    for ev in events:
        lines.append(f"  {ev['t']:.3f} [{ev['kind']}] {ev['detail']}")
    try:
        print("\n".join(lines), file=file, flush=True)
    except OSError:
        pass


class _Region:
    __slots__ = ("id", "region", "deadline", "timeout", "context", "watchdog",
                 "fired")

    def __init__(self, id, region, deadline, timeout, context, watchdog):
        self.id = id
        self.region = region
        self.deadline = deadline
        self.timeout = timeout
        self.context = context
        self.watchdog = watchdog
        self.fired = False


_regions = {}  # id -> _Region
_cv = threading.Condition()
_ids = itertools.count(1)
_monitor = None


def _ensure_monitor():
    global _monitor
    if _monitor is not None and _monitor.is_alive():
        return
    _monitor = threading.Thread(target=_monitor_loop, name="fault-watchdog",
                                daemon=True)
    _monitor.start()


def _monitor_loop():
    # no local of this frame outlives one pass: a region kept here would
    # keep its watchdog's action, and so the engine behind it, alive
    while True:
        _fire_all(_wait_for_expired())


def _wait_for_expired():
    """Block until some armed region is past its deadline; mark those
    fired and return them."""
    with _cv:
        while True:
            live = [r for r in _regions.values() if not r.fired]
            now = time.monotonic()
            if not live:
                _cv.wait(timeout=60)
                continue
            nearest = min(r.deadline for r in live)
            if nearest > now:
                _cv.wait(timeout=nearest - now)
                continue
            expired = [r for r in live if r.deadline <= now]
            for r in expired:
                r.fired = True
            return expired


def _fire_all(expired):
    for r in expired:  # outside the lock: an action may be slow
        _fire(r)


def _fire(r):
    from . import injection as _inj

    note = (f"region {r.region!r} exceeded {r.timeout:.1f}s"
            + (f" (context: {r.context})" if r.context else "")
            + " -- dumping all thread stacks")
    logger.error("watchdog fired: %s", note)
    dump_stacks(note=note)
    _inj.record_event("watchdog", f"fired: {r.region} after {r.timeout:.1f}s")
    action = r.watchdog.action
    if callable(action):
        action(r.region, r.timeout)
    # "raise": arm() raises WatchdogTimeout when the region exits


class Watchdog:
    """Deadline tracker for blocking regions; `action` is "raise" or a
    callable."""

    def __init__(self, action="raise"):
        if not (callable(action) or action == "raise"):
            raise ValueError(f"watchdog action must be 'raise' or a callable, "
                             f"got {action!r}")
        self.action = action

    @contextlib.contextmanager
    def arm(self, region, timeout, context=None):
        """Guard a blocking region for `timeout` seconds; with a timeout <=
        0 this is a plain passthrough, so hot paths arm unconditionally."""
        t = float(timeout)
        if t <= 0:
            yield
            return
        _ensure_monitor()
        r = _Region(next(_ids), region, time.monotonic() + t, t, context, self)
        with _cv:
            _regions[r.id] = r
            _cv.notify()
        try:
            yield
        finally:
            with _cv:
                _regions.pop(r.id, None)
            if r.fired and self.action == "raise":
                raise WatchdogTimeout(region, t)
