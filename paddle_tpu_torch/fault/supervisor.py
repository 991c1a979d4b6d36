"""Supervised loops (counterpart of `paddle_tpu/fault/supervisor.py`).

`Supervisor` wraps a training loop (`hapi.Model.fit` runs under one;
standalone loops build their own, or call `run_supervised`).  It gives
three guarantees:

1. **Non-finite watchdog**: `after_step(loss)` counts CONSECUTIVE
   non-finite losses (an `amp.GradScaler`'s skipped steps count too, via
   `attach_scaler`) and raises :class:`NonFiniteLossError` with a
   diagnostic once `max_bad_steps` is reached.  A loss on the card is not
   read there: it waits in a bounded ring, and `drain()` fetches the whole
   ring in one stacked copy (fit hands over the values it fetched for its
   logs, so a window costs one fetch in all).
2. **Preemption**: SIGTERM (or SIGUSR1) sets a flag; at the next step
   boundary the supervisor writes a best-effort checkpoint (`save_fn`),
   drops this rank's ABORT marker and exits with
   :data:`RESTART_EXIT_CODE` (75, EX_TEMPFAIL), the launcher's "relaunch
   me" code.
3. **Crash checkpoint**: `guard()` around a step body turns an unhandled
   exception into a best-effort checkpoint and an ABORT marker, then
   re-raises.

`save_fn` is any zero-argument callable (typically ``lambda:
checkpoint.save_checkpoint(state, root, sup.step)``); its failures are
logged and swallowed, so a best-effort save never masks the fault.

`EngineSupervisor` is the serving counterpart: a poll thread that
restarts a wedged or crashed `ContinuousBatchingEngine`.
"""

from __future__ import annotations

import contextlib
import logging
import math
import signal as _signal
import threading
import time

import torch

from ..framework import core as _core
from ..obs import flight as _flight
from . import heartbeat as _hb
from . import injection as _inj

logger = logging.getLogger("paddle_tpu_torch")

# EX_TEMPFAIL: "temporary failure, retry" -- a launcher relaunches (bounded
# by its restart budget) instead of counting a hard crash
RESTART_EXIT_CODE = 75


class NonFiniteLossError(FloatingPointError):
    """Training diverged: too many consecutive non-finite steps."""


class RestartRequested(SystemExit):
    """Raised to exit the trainer with the restart-requested code."""

    def __init__(self, reason=""):
        self.reason = reason
        super().__init__(RESTART_EXIT_CODE)


def _is_finite(loss):
    if loss is None:
        return True
    return math.isfinite(float(loss))


class Supervisor:
    """Step-loop guard: non-finite watchdog, SIGTERM -> checkpoint + exit 75.

    save_fn: zero-argument best-effort checkpoint hook, called on
        preemption and on a crash inside `guard()`; its exceptions are
        logged, never raised.
    max_bad_steps: consecutive non-finite steps tolerated before
        NonFiniteLossError; 0 disables the watchdog.
    handle_signals: install SIGTERM and SIGUSR1 handlers (main thread
        only; skipped elsewhere).  `uninstall()` (or leaving a ``with``
        block) puts the previous handlers back.
    """

    def __init__(self, save_fn=None, max_bad_steps=3, handle_signals=True):
        self.save_fn = save_fn
        self.max_bad_steps = max_bad_steps
        self.step = 0
        self.bad_steps = 0  # consecutive
        self.total_bad_steps = 0
        # losses on the card awaiting their finiteness check: (loss, the
        # scaler's skip flag of that step) pairs, drained at fit's windows;
        # pending_limit bounds the detection latency of a loop that never
        # drains
        self._pending = []
        self.pending_limit = 128
        self.preempted = False
        self._signum = None
        self._scaler = None
        self._prev_handlers = {}
        # under a launched job this rank's heartbeat starts here; a
        # standalone run gets None and the heartbeat hooks do nothing
        self.heartbeat = _hb.maybe_start()
        if handle_signals:
            self._install()

    # -- signals -------------------------------------------------------------
    def _install(self):
        for sig in (_signal.SIGTERM, _signal.SIGUSR1):
            try:
                self._prev_handlers[sig] = _signal.signal(sig, self._on_signal)
            except ValueError:
                # not the main thread: the loop can still poll .preempted,
                # set by request_stop() from whoever owns the signal
                self._prev_handlers.clear()
                return

    def _on_signal(self, signum, frame):
        self.request_stop(signum)

    def request_stop(self, signum=None):
        """Mark the job preempted; honoured at the next step boundary."""
        self.preempted = True
        self._signum = signum
        logger.warning("supervisor: stop requested (signal %s); will checkpoint "
                       "and exit %d at the next step boundary", signum,
                       RESTART_EXIT_CODE)

    def uninstall(self):
        for sig, h in self._prev_handlers.items():
            try:
                _signal.signal(sig, h)
            except ValueError:
                pass
        self._prev_handlers.clear()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        try:
            if exc_type is None:
                self.drain()  # no deferred loss leaves unchecked
        finally:
            self.uninstall()
        return False

    # -- scaler --------------------------------------------------------------
    def attach_scaler(self, scaler):
        """Count the scaler's skipped steps (an inf or nan in the gradients)
        as bad steps, reusing the flag that already guards the optimizer."""
        self._scaler = scaler
        return scaler

    def _scaler_flag(self):
        """The attached scaler's skip flag of the last updated cycle: its
        int32 device tensor when it keeps one (read at the drain), else a
        bool; False without a scaler."""
        s = self._scaler
        if s is None:
            return False
        flag = getattr(s, "_last_found", None)
        if isinstance(flag, torch.Tensor):
            return flag
        return bool(getattr(s, "last_found_inf", False))

    # -- step accounting -----------------------------------------------------
    def after_step(self, loss=None):
        """Record one finished step.  Raises NonFiniteLossError after
        `max_bad_steps` CONSECUTIVE non-finite steps, then honours a pending
        preemption (checkpoint + RestartRequested).

        `loss` a host float (checked now) or a tensor: a tensor waits in the
        ring without a fetch and is checked at the next `drain()`, or once
        `pending_limit` tensors wait.  Returns False for a step found bad
        now, True otherwise."""
        _inj.inject("supervisor.step")
        self.step += 1
        if self.heartbeat is not None:
            # a progress signal: the beat carries the step
            self.heartbeat.beat(step=self.step)
        _hb.check_peer_abort()  # a dead peer: exit 75 before the next step
        if isinstance(loss, torch.Tensor):
            self._pending.append((loss.detach(), self._scaler_flag()))
            if len(self._pending) >= self.pending_limit:
                self.drain()
            self.maybe_exit()
            return True
        flag = self._scaler_flag()
        bad = self._account(not _is_finite(loss) or bool(flag), loss)
        self.maybe_exit()
        return not bad

    def _account(self, bad, loss_repr):
        if bad:
            self.bad_steps += 1
            self.total_bad_steps += 1
            logger.warning("supervisor: non-finite step %d (%d consecutive, "
                           "budget %d)", self.step, self.bad_steps,
                           self.max_bad_steps)
            if self.max_bad_steps and self.bad_steps >= self.max_bad_steps:
                raise NonFiniteLossError(
                    f"training diverged: {self.bad_steps} consecutive "
                    f"non-finite steps (step {self.step}, last loss "
                    f"{loss_repr!r}, {self.total_bad_steps} bad steps total). "
                    "Lower the learning rate, check the data pipeline, or "
                    "raise max_bad_steps if spikes are expected.")
        else:
            self.bad_steps = 0
        return bad

    def drain(self, values=None):
        """Check every deferred loss, oldest first.  One fetch for the whole
        ring: the losses are stacked on their device and copied together.
        `values`: the same window's losses, already fetched by the caller
        (fit's logs), so the window costs no second copy.  Scaler flags
        kept on the card come back in one more stacked copy.  Raises
        NonFiniteLossError as `after_step` would; entries after the raising
        one are dropped (the job is aborting).  Returns whether all were
        finite."""
        if not self._pending:
            return True
        pending, self._pending = self._pending, []
        if values is None:
            values = torch.stack([p.reshape(()).float() for p, _ in pending]).cpu()
        else:
            # the ring may have drained itself (pending_limit) inside the
            # caller's window: its entries are the window's last ones
            values = values[len(values) - len(pending):]
        flags = [f for _, f in pending]
        dev = [i for i, f in enumerate(flags) if isinstance(f, torch.Tensor)]
        if dev:
            fetched = torch.stack([flags[i].reshape(()) != 0 for i in dev]).cpu()
            for i, f in zip(dev, fetched.tolist()):
                flags[i] = f
        ok = True
        for flagged, v in zip(flags, values):
            v = float(v)
            ok &= not self._account(bool(flagged) or not math.isfinite(v), v)
        return ok

    # -- preemption and crash checkpoint -------------------------------------
    def _best_effort_save(self, why):
        if self.save_fn is None:
            return False
        try:
            self.save_fn()
            logger.warning("supervisor: checkpoint written (%s)", why)
            return True
        except Exception as e:  # must not mask the original fault
            logger.error("supervisor: best-effort checkpoint failed: %s", e)
            return False

    def maybe_exit(self):
        """After a preemption request: checkpoint (best effort), drop the
        ABORT marker, raise RestartRequested (exit code 75)."""
        if not self.preempted:
            return
        self._best_effort_save(f"preemption signal {self._signum}")
        _hb.write_abort(f"preempted (signal {self._signum})")
        self.uninstall()
        raise RestartRequested(f"signal {self._signum}")

    @contextlib.contextmanager
    def guard(self):
        """Wrap a step body: an unhandled exception checkpoints (best
        effort) and drops the ABORT marker before propagating."""
        try:
            yield self
        except (RestartRequested, KeyboardInterrupt):
            raise
        except Exception as e:
            self._best_effort_save("crash")
            _hb.write_abort(f"crash: {type(e).__name__}: {e}")
            raise


def run_supervised(step_fn, steps, save_fn=None, max_bad_steps=3, start_step=0):
    """Drive `step_fn(step) -> loss` for steps `start_step`..`steps - 1`
    under a Supervisor (non-finite watchdog, preemption -> checkpoint +
    exit 75, crash -> best-effort checkpoint + raise).  Returns the
    losses."""
    losses = []
    with Supervisor(save_fn=save_fn, max_bad_steps=max_bad_steps) as sup:
        sup.step = start_step
        for i in range(start_step, steps):
            with sup.guard():
                loss = step_fn(i)
            losses.append(loss)
            sup.after_step(loss)
    return losses


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
    Each restart first writes the flight recorder's ring to a dump
    (`engine-restart-{n}`), and so does the exhausted budget
    (`engine-restart-budget-exhausted`).  The poll thread reads host state
    only: no CUDA call."""

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
            _flight.dump("engine-restart-budget-exhausted")
            with self._state_mu:
                self.dead = True
            self.engine.fail_all(f"restart budget exhausted ({reason})")
            return False
        logger.error("engine supervisor: %s; engine restart %d/%d in %.2fs",
                     reason, spent, self.max_restarts, delay)
        # before the restart clears the engine's state: the timeline up to
        # the trip is what the post-mortem needs
        _flight.dump(f"engine-restart-{spent}")
        if delay > 0:
            time.sleep(delay)
        self.engine.restart(reason)
        return True
