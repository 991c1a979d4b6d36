"""Named fault points, armed via FLAGS_fault_inject (counterpart of
`paddle_tpu/fault/injection.py`, the same grammar, points and events).

Spec grammar (comma separated)::

    FLAGS_fault_inject="serve.prefill.hang:1,serve.decode.nan"

``name``      fire once (the first time the point is reached)
``name:N``    fire on the first N hits, then pass through
``name:*``    fire on every hit

A firing point raises :class:`InjectedFault`, a distinct exception type,
so recovery code can tell a chaos fault from a real error when it wants
to, while code written against ``Exception`` treats it as the failure it
stands in for.  `should_fire` is the non-raising form (the engine's NaN
poison), `inject_hang` the blocking one (a wedged dispatch).

Disarmed points cost one dict lookup on an empty dict, so hot paths call
them unconditionally.  Every module-level state here is host-side Python:
nothing touches the device.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from ..framework import core as _core
from ..obs import flight as _flight

logger = logging.getLogger("paddle_tpu_torch")

ALWAYS = -1  # sentinel count for 'name:*'

_lock = threading.Lock()
_registry = {}  # name -> doc (every point ever declared or reached)
_armed = {}  # name -> remaining fire count (ALWAYS = unlimited)
_hits = {}  # name -> times an ARMED point was reached
_parsed_spec = None  # last spec parsed into _armed (re-parse on change)

# ring buffer of recent fault-layer events (injections, hangs, watchdog
# trips, engine restarts), dumped by the watchdog beside the thread stacks
_events = collections.deque(maxlen=64)


def record_event(kind, detail=""):
    """Append to the fault-event ring buffer (thread-safe: deque append),
    and mirror the event into the obs flight recorder's ring, so its dumps
    carry the fault timeline."""
    _events.append({"t": time.monotonic(), "kind": kind, "detail": str(detail)})
    _flight.record(kind, detail)


def recent_events(n=None):
    """The last `n` (default: all retained) fault-layer events, oldest
    first."""
    evs = list(_events)
    return evs if n is None else evs[-n:]


class InjectedFault(RuntimeError):
    """Raised by an armed fault point standing in for a real failure."""

    def __init__(self, point, context=None):
        self.point = point
        self.context = context
        msg = f"injected fault at point {point!r}"
        if context:
            msg += f" ({context})"
        super().__init__(msg)


def register(name, doc=""):
    """Declare a fault point (documentation, and typo detection for
    arm())."""
    _registry.setdefault(name, doc)
    return name


def fault_points():
    """All known fault points: {name: doc}."""
    return dict(_registry)


def _parse_spec(spec):
    armed = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, count = entry.partition(":")
        if not count:
            n = 1
        elif count == "*":
            n = ALWAYS
        else:
            try:
                n = int(count)
            except ValueError:
                raise ValueError(
                    f"FLAGS_fault_inject entry {entry!r}: count must be an "
                    "integer or '*'"
                ) from None
        armed[name] = n
    return armed


def _sync_from_flag():
    """Re-parse FLAGS_fault_inject if it changed since the last sync, so
    `set_flags`, the environment and arm() share one state."""
    global _parsed_spec
    spec = _core.flag("FLAGS_fault_inject")
    if spec == _parsed_spec:
        return
    with _lock:
        if spec == _parsed_spec:
            return
        _armed.clear()
        _hits.clear()
        _armed.update(_parse_spec(spec))
        _parsed_spec = spec
        if _armed:
            logger.warning("fault injection armed: %s", dict(_armed))


def arm(spec):
    """Arm fault points (the flag's grammar); re-arming one spec resets its
    counts."""
    global _parsed_spec
    _core.set_flags({"FLAGS_fault_inject": spec})
    _parsed_spec = None
    _sync_from_flag()


def disarm():
    """Disarm every fault point and clear the hit counters."""
    arm("")


def hits(name):
    """Times an armed `name` point was reached (fired or already spent)."""
    return _hits.get(name, 0)


def _consume(name):
    """True when `name` is armed with shots left (consumes one shot)."""
    _sync_from_flag()
    if not _armed:
        _registry.setdefault(name, "")
        return False
    with _lock:
        remaining = _armed.get(name)
        _registry.setdefault(name, "")
        if remaining is None:
            return False
        _hits[name] = _hits.get(name, 0) + 1
        if remaining == 0:
            return False
        if remaining > 0:
            _armed[name] = remaining - 1
    return True


def inject(name, context=None):
    """Fault point: raise InjectedFault if `name` is armed with shots
    left."""
    if not _consume(name):
        return
    logger.warning("fault point %r firing (context=%s)", name, context)
    record_event("inject", f"{name} ({context})" if context else name)
    raise InjectedFault(name, context)


def should_fire(name, context=None):
    """Non-raising fault point: True when `name` is armed with shots left
    (consumes one shot and records the event)."""
    if not _consume(name):
        return False
    logger.warning("fault point %r firing inline (context=%s)", name, context)
    record_event("inject", f"{name} ({context})" if context else name)
    return True


def inject_hang(name, context=None, hang_sec=None):
    """Hang fault point: an armed `name` BLOCKS for FLAGS_fault_hang_sec
    (or `hang_sec`) instead of raising, standing in for a wedged dispatch
    that only the watchdog can detect."""
    if not _consume(name):
        return
    if hang_sec is None:
        hang_sec = float(_core.flag("FLAGS_fault_hang_sec"))
    logger.warning("fault point %r hanging for %.1fs (context=%s)", name,
                   hang_sec, context)
    detail = f"{name} for {hang_sec:.1f}s"
    record_event("hang", f"{detail} ({context})" if context else detail)
    time.sleep(hang_sec)


register("serve.prefill.hang",
         "HANGS the serving engine's prefill dispatch (watchdog -> engine "
         "restart drill)")
register("serve.decode.nan",
         "poisons ONE active slot's decode logits with NaN for one step (a "
         "static input of the decode graph)")
register("serve.loop.crash",
         "crashes the engine scheduler thread (EngineSupervisor restart "
         "drill)")
register("disagg.prefill.crash",
         "drops a prefill worker's POST /prefill after its export, with no "
         "byte of response (the router sees a zero-token retriable failure)")
register("launch.spawn", "fires when the launch controller spawns a trainer")
register("router.replica.hang", "HANGS the router's dispatch to one replica (wedged connection drill; bounded by the HTTP timeout)")
register("router.replica.flap", "fails the router's /healthz probe of a replica (flapping-replica / breaker drill)")
register("router.replica.kill", "SIGKILLs a router-managed replica process at probe time (kill -9 chaos drill)")
register("autoscale.spawn", "fires when the autoscaler spawns a replica (failed-scale-up drill: the loop must absorb the failure and retry after the cooldown)")
register("router.crash", "kills the serving ROUTER at probe time (front-door kill -9 drill: heartbeat goes stale, the warm standby replays the journal, re-probes the fleet, and resumes serving exactly-once)")
register("disagg.handoff.drop", "drops the serialized handoff payload between the prefill and decode hops (router-side; the request retries the whole pipeline exactly-once, the decode-side reservation expires by TTL)")
register("dataloader.next", "fires before the data loader produces each batch")
register("dataloader.hang", "HANGS the data loader's next() (watchdog drill)")
register("supervisor.step", "fires inside Supervisor.after_step")
register("checkpoint.save", "fires inside each checkpoint save attempt, before "
         "the payload is written")
register("checkpoint.commit", "fires after the payload is written, before the "
         "COMMIT marker: leaves a torn checkpoint")
register("checkpoint.load", "fires before a checkpoint is restored")
