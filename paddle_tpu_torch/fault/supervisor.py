"""Supervision of a serving engine (counterpart of `EngineSupervisor` in
`paddle_tpu/fault/supervisor.py`; the training `Supervisor` and
`run_supervised` are not ported yet, see ROADMAP)."""

from __future__ import annotations

import logging
import threading
import time

from ..framework import core as _core
from . import injection as _inj

logger = logging.getLogger("paddle_tpu_torch")


class EngineSupervisor:
    """Watchdogged supervision of a `ContinuousBatchingEngine`.

    A poll thread reads three signals and performs a bounded
    restart-with-backoff of the engine when one trips:

    - **watchdog trip**: the engine arms its blocking regions (prefill
      dispatch, decode dispatch, token fetch) with its own `Watchdog`,
      whose action records the overrun (`FLAGS_serve_step_timeout_sec`);
    - **dead scheduler thread**: the thread ended without `stop()`;
    - **stalled progress**: the engine has work but its progress stamp
      stopped moving for `_stall_deadline()` seconds (a wedge between
      armed regions).

    `engine.restart()` is warm: the same captured steps and KV pool (0 new
    traces), every in-flight request resolved exactly once (re-queued if it
    emitted nothing, else failed with `EngineRestarted`).  Past
    `max_restarts` the supervisor declares the engine dead and
    `engine.fail_all()` resolves everything pending with typed errors.
    The poll thread reads host state only: no CUDA call."""

    def __init__(self, engine, poll_interval=0.1, max_restarts=None,
                 backoff=None, backoff_max=30.0, stall_timeout=None):
        self.engine = engine
        self.poll_interval = float(poll_interval)
        self.max_restarts = int(max_restarts if max_restarts is not None
                                else _core.flag("FLAGS_serve_max_restarts"))
        self.backoff = float(backoff if backoff is not None
                             else _core.flag("FLAGS_serve_restart_backoff"))
        self.backoff_max = float(backoff_max)
        # stall detection defaults to 4x the watchdog deadline (0 disables):
        # the watchdog covers armed regions, this covers the gaps between
        self.stall_timeout = stall_timeout
        self.restarts = 0
        self.dead = False
        # the budget moves under this lock: the poll thread and a direct
        # caller must not both spend one restart
        self._state_mu = threading.Lock()
        self._stop = threading.Event()
        self._thread = None

    def _stall_deadline(self):
        if self.stall_timeout is not None:
            return float(self.stall_timeout)
        t = float(_core.flag("FLAGS_serve_step_timeout_sec"))
        return 4 * t if t > 0 else 0.0

    def start(self):
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(target=self._run,
                                        name="engine-supervisor", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    def check(self):
        """One health probe: a reason string when the engine needs a
        restart, else None."""
        eng = self.engine
        trip = eng._watchdog_trip
        if trip is not None:
            region, elapsed = trip
            return f"watchdog: region {region!r} exceeded {elapsed:.1f}s"
        t = eng._thread
        if t is not None and not t.is_alive() and not eng._stop:
            return "scheduler thread died"
        stall = self._stall_deadline()
        if (stall > 0 and t is not None and eng.has_work()
                and time.monotonic() - eng._last_progress > stall):
            return f"no scheduler progress for {stall:.1f}s with work pending"
        return None

    def _run(self):
        while not self._stop.is_set() and not self.dead:
            reason = self.check()
            if reason is not None:
                self.restart(reason)
            self._stop.wait(self.poll_interval)

    def restart(self, reason):
        """Bounded restart with backoff; past the budget, declare the
        engine dead and fail everything pending with typed errors.
        Returns whether the engine was restarted."""
        with self._state_mu:
            if self.restarts >= self.max_restarts:
                exhausted, spent = True, self.restarts
            else:
                exhausted = False
                delay = min(self.backoff * (2 ** self.restarts), self.backoff_max)
                self.restarts += 1
                spent = self.restarts
        if exhausted:
            logger.error("engine supervisor: restart budget (%d) exhausted "
                         "(%s); declaring the engine dead", self.max_restarts,
                         reason)
            _inj.record_event(
                "engine", f"restart budget exhausted after {spent} ({reason})")
            with self._state_mu:
                self.dead = True
            self.engine.fail_all(f"restart budget exhausted ({reason})")
            return False
        logger.error("engine supervisor: %s; engine restart %d/%d in %.2fs",
                     reason, spent, self.max_restarts, delay)
        if delay > 0:
            time.sleep(delay)
        self.engine.restart(reason)
        return True
