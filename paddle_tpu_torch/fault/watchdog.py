"""Hang watchdog: deadline-tracked blocking regions, with a stack dump on
expiry (counterpart of `paddle_tpu/fault/watchdog.py`).

`Watchdog.arm(region, timeout, context)` (a context manager) registers a
deadline with one monitor thread; a region that overruns dumps every
Python thread's stack and the recent fault events to stderr, then acts:

``raise``  mark the region; :class:`WatchdogTimeout` is raised from the
           arming thread when the blocked call returns (the class's
           default).
``exit``   drop this rank's ABORT marker (`heartbeat.write_abort`) and
           `os._exit(75)`: the blocked call may never return, so the
           process dies with the restart-requested code.  The module's
           `default` watchdog acts so; `arm(region)` arms it, with
           FLAGS_collective_timeout_sec as the deadline (0 disables it).
           The training loop arms `fit.train_batch`, the data loader
           `dataloader.next`, checkpoints `checkpoint.save` / `.load`.
callable   invoked as ``action(region, timeout)``: the serving engine
           records the trip and its `EngineSupervisor` restarts it.

The monitor thread makes no CUDA call, before, during or after a trip: it
reads the host clock, formats Python stacks and calls the action, which
must not touch the device either.  A CUDA call there would join a stream
capture running on the scheduler thread (and invalidate it), or block
behind the very stream that is wedged.

Before its action, a trip writes the flight recorder's ring to a JSONL
dump (`obs.flight.dump(f"watchdog-{region}")`); every arm notes the
region in the recorder's armed-region gauge.  Both hold strings and
numbers only, never a region or its action.

A monitor pass (the regions that expired together, fired in turn) ends
observably: `wait_for_monitor()` returns once no pass is running, and by
then the monitor thread holds nothing of the regions it fired.

A timeout <= 0 disables a region: it costs no lock.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import sys
import threading
import time
import traceback

from ..framework import core as _core
from ..obs import flight as _flight

logger = logging.getLogger("paddle_tpu_torch")

_core.define_flag(
    "FLAGS_collective_timeout_sec", 0.0,
    "deadline (s) of the default watchdog's regions: checkpoint save/load, "
    "data loader next, the fit step.  0 disables it.",
)

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
_firing = 0  # regions of the monitor pass in progress, under _cv


def _ensure_monitor():
    global _monitor
    if _monitor is not None and _monitor.is_alive():
        return
    _monitor = threading.Thread(target=_monitor_loop, name="fault-watchdog",
                                daemon=True)
    _monitor.start()


def _monitor_loop():
    # no local of this frame outlives one pass: a region kept here would
    # keep its watchdog's action, and so the engine behind it, alive.  The
    # pass ends (wait_for_monitor wakes) only after _fire_all returned,
    # when its frame, the expired list and the last region are gone
    global _firing
    while True:
        _fire_all(_wait_for_expired())
        with _cv:
            _firing = 0
            _cv.notify_all()


def wait_for_monitor(timeout=5.0):
    """Block until no monitor pass is firing regions, for at most `timeout`
    seconds; returns whether none is.  A region popped from the table
    before the monitor marked it fired never fires, so once its `arm()`
    has exited this tells whether it tripped: the trip's action has run
    and the monitor holds nothing of the region.  Holds no region and no
    action itself."""
    t_end = time.monotonic() + float(timeout)
    with _cv:
        while _firing:
            left = t_end - time.monotonic()
            if left <= 0:
                return False
            _cv.wait(left)
    return True


def _wait_for_expired():
    """Block until some armed region is past its deadline; mark those
    fired, count them as the pass in progress and return them.  No region
    is held while waiting: a region that exits meanwhile is freed with its
    arm()."""
    global _firing
    with _cv:
        while True:
            now = time.monotonic()
            nearest = min((r.deadline for r in _regions.values() if not r.fired),
                          default=None)
            if nearest is None or nearest > now:
                _cv.wait(timeout=60 if nearest is None else nearest - now)
                continue
            expired = [r for r in _regions.values()
                       if not r.fired and r.deadline <= now]
            for r in expired:
                r.fired = True
            _firing = len(expired)
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
    # the trip is the moment state is about to be lost: the ring goes to
    # disk before the action runs (the dump reads strings and numbers only)
    _flight.dump(f"watchdog-{r.region}")
    action = r.watchdog.action
    if callable(action):
        try:
            action(r.region, r.timeout)
        except Exception:  # the monitor serves every other region too
            logger.exception("watchdog action for region %r failed", r.region)
    elif action == "exit":  # the blocked call may never return
        from . import heartbeat as _hb
        from .supervisor import RESTART_EXIT_CODE

        _hb.write_abort(f"watchdog: {r.region} exceeded {r.timeout:.1f}s")
        os._exit(RESTART_EXIT_CODE)
    # "raise": arm() raises WatchdogTimeout when the region exits


class Watchdog:
    """Deadline tracker for blocking regions; `action` is "raise", "exit"
    or a callable; `timeout` the deadline of an `arm()` that names none
    (None: FLAGS_collective_timeout_sec)."""

    def __init__(self, action="raise", timeout=None):
        if not (callable(action) or action in ("raise", "exit")):
            raise ValueError(f"watchdog action must be 'raise', 'exit' or a "
                             f"callable, got {action!r}")
        self.action = action
        self.timeout = timeout

    def _resolve_timeout(self, timeout):
        if timeout is not None:
            return float(timeout)
        if self.timeout is not None:
            return float(self.timeout)
        return float(_core.flag("FLAGS_collective_timeout_sec"))

    @contextlib.contextmanager
    def arm(self, region, timeout=None, context=None):
        """Guard a blocking region for `timeout` seconds; with a timeout <=
        0 this is a plain passthrough, so hot paths arm unconditionally."""
        t = self._resolve_timeout(timeout)
        if t <= 0:
            yield
            return
        # the last arm per region, a gauge rather than a ring event: decode
        # and fetch arm every step and would flood the ring
        _flight.note_arm(region, context)
        _ensure_monitor()
        r = _Region(next(_ids), region, time.monotonic() + t, t, context, self)
        with _cv:
            _regions[r.id] = r
            _cv.notify_all()  # the monitor, not a wait_for_monitor caller
        try:
            yield
        finally:
            with _cv:
                _regions.pop(r.id, None)
            if r.fired and self.action == "raise":
                raise WatchdogTimeout(region, t)


default = Watchdog(action="exit")


def arm(region, timeout=None, context=None):
    """Arm the `default` watchdog (action "exit") around a blocking region;
    a passthrough when FLAGS_collective_timeout_sec is 0 and no `timeout`
    is given."""
    return default.arm(region, timeout=timeout, context=context)
