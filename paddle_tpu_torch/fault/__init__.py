"""The fault domain of the port (counterpart of `paddle_tpu/fault`).

- `injection`: named fault points armed through ``FLAGS_fault_inject``
  (serving, data loader, supervisor step, checkpoint save/commit/load),
  so chaos tests and real runs take the same code path;
- `watchdog`: deadline-tracked blocking regions with a stack dump on
  expiry; the module's `default` watchdog (`arm(region)`, deadline
  ``FLAGS_collective_timeout_sec``) exits 75 after an ABORT marker;
- `heartbeat`: per-rank heartbeat files and ABORT markers under
  ``$PADDLE_HEARTBEAT_DIR``;
- `Supervisor` and `run_supervised`: the training step guard (consecutive
  non-finite losses, the scaler's skip signal, SIGTERM -> best-effort
  checkpoint + exit 75, a crash -> best-effort checkpoint + re-raise);
- `EngineSupervisor`: bounded warm restarts of a serving engine.

Exit-code contract with a launcher: a trainer exiting with
``RESTART_EXIT_CODE`` (75, EX_TEMPFAIL) asks to be relaunched and pointed
at its checkpoints through ``PADDLE_CKPT_DIR``.  The launch controller
that polls the heartbeat files and gang-restarts the ranks comes with
`distributed/` (ROADMAP Queue 1, item 17).
"""

from __future__ import annotations

from . import heartbeat, injection, watchdog  # noqa: F401
from .heartbeat import HeartbeatWriter, PeerAbort  # noqa: F401
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
from .supervisor import (  # noqa: F401
    RESTART_EXIT_CODE,
    EngineSupervisor,
    NonFiniteLossError,
    RestartRequested,
    Supervisor,
    run_supervised,
)
from .watchdog import Watchdog, WatchdogTimeout, dump_stacks  # noqa: F401
