"""The serving fault domain of the port (counterpart of the serving parts
of `paddle_tpu/fault`): named fault points (`injection`), the hang
watchdog (`watchdog`) and the serving engine's supervisor
(`EngineSupervisor`).  The training `Supervisor`, `run_supervised` and
the heartbeat files are not ported yet (ROADMAP Queue 1, items 13 and
17)."""

from __future__ import annotations

from . import injection, watchdog  # noqa: F401
from .injection import (  # noqa: F401
    InjectedFault,
    arm,
    disarm,
    fault_points,
    hits,
    inject,
    inject_hang,
    recent_events,
    record_event,
    register,
    should_fire,
)
from .supervisor import EngineSupervisor  # noqa: F401
from .watchdog import Watchdog, WatchdogTimeout, dump_stacks  # noqa: F401
