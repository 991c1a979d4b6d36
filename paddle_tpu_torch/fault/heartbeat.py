"""Per-rank heartbeat files and ABORT markers (counterpart of
`paddle_tpu/fault/heartbeat.py`, the same files, names and payloads): the
liveness contract between trainers and a launch controller.

Every trainer writes ``hb_<rank>.json`` into ``$PADDLE_HEARTBEAT_DIR`` by
write-to-tmp and atomic rename, carrying a monotonically increasing
``seq``, the writer's wall and monotonic time, the last training ``step``
and a ``status``.  A controller never compares clocks across processes:
it watches ``seq`` and declares a rank sick when it stops advancing for
its heartbeat timeout on the controller's own clock.

A dying rank also drops ``abort_<rank>.json`` (reason and time).
Surviving ranks poll for a peer's ABORT marker at step boundaries
(`check_peer_abort`, which `fault.Supervisor.after_step` calls) and exit
with the restart-requested code (75) instead of entering a collective
that will never complete.  The controller that polls these files and
gang-restarts the ranks comes with `distributed/` (ROADMAP Queue 1, item
17); until then a standalone run exports no directory and every hook here
is a no-op.  Nothing here touches the card.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time

logger = logging.getLogger("paddle_tpu_torch")

# env contract exported by the launch controller
ENV_DIR = "PADDLE_HEARTBEAT_DIR"
ENV_INTERVAL = "PADDLE_HEARTBEAT_INTERVAL"
ENV_RANK = "PADDLE_TRAINER_ID"

STATUS_RUNNING = "RUNNING"
STATUS_ABORT = "ABORT"

_HB_RE = re.compile(r"^hb_(\d+)\.json$")
_ABORT_RE = re.compile(r"^abort_(\d+)\.json$")


class PeerAbort(SystemExit):
    """A peer rank dropped an ABORT marker: exit 75 instead of hanging in
    the next collective; the controller's gang restart takes over."""

    def __init__(self, rank, reason=""):
        self.rank = rank
        self.reason = reason
        from .supervisor import RESTART_EXIT_CODE

        super().__init__(RESTART_EXIT_CODE)


def hb_path(root, rank):
    return os.path.join(root, f"hb_{int(rank)}.json")


def abort_path(root, rank):
    return os.path.join(root, f"abort_{int(rank)}.json")


def _atomic_write(path, payload):
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
        f.flush()
    os.replace(tmp, path)


def read_json(path):
    """Parse a heartbeat/abort file; None when missing or torn (a reader
    racing the atomic rename only ever sees the previous complete file,
    but a crashed writer's leftover .tmp or an empty fs is normal)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def scan_heartbeats(root):
    """{rank: payload} for every parseable heartbeat file under root."""
    out = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _HB_RE.match(name)
        if not m:
            continue
        payload = read_json(os.path.join(root, name))
        if payload is not None:
            out[int(m.group(1))] = payload
    return out


def scan_aborts(root):
    """{rank: payload} of ABORT markers under root."""
    out = {}
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for name in names:
        m = _ABORT_RE.match(name)
        if not m:
            continue
        out[int(m.group(1))] = read_json(os.path.join(root, name)) or {}
    return out


def clear(root):
    """Remove heartbeat/abort files (the controller calls this before every
    gang (re)launch so a fresh life never reads a dead life's state)."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        if _HB_RE.match(name) or _ABORT_RE.match(name) or ".tmp." in name:
            try:
                os.remove(os.path.join(root, name))
            except OSError:
                pass


class HeartbeatWriter:
    """Writes this rank's heartbeat file; ``interval > 0`` starts a daemon
    thread beating on a period, ``interval == 0`` means manual ``beat()``
    calls only (a loop that beats from its step boundary makes the
    heartbeat a PROGRESS signal, not just process liveness)."""

    def __init__(self, root, rank, interval=0.0, start=True):
        self.root = str(root)
        self.rank = int(rank)
        self.interval = float(interval)
        self.seq = 0
        self.step = None
        self.status = STATUS_RUNNING
        # beat()/set_step() are called from BOTH the interval thread and the
        # training loop; the lock makes each payload a consistent
        # (seq, step, status) snapshot and seq strictly monotonic
        self._mu = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        os.makedirs(self.root, exist_ok=True)
        if start:
            self.beat()
            if self.interval > 0:
                self._thread = threading.Thread(
                    target=self._run, name=f"heartbeat-rank{self.rank}", daemon=True
                )
                self._thread.start()

    def _run(self):
        while not self._stop.wait(self.interval):
            try:
                self.beat()
            except OSError as e:  # a full/unmounted fs must not kill training
                logger.warning("heartbeat write failed: %s", e)

    def set_step(self, step):
        with self._mu:
            self.step = int(step)

    def beat(self, step=None):
        with self._mu:
            if step is not None:
                self.step = int(step)
            self.seq += 1
            payload = {
                "seq": self.seq,
                "mono": time.monotonic(),
                "time": time.time(),
                "step": self.step,
                "status": self.status,
                "pid": os.getpid(),
            }
            # write inside the lock: concurrent beats must not land their
            # files out of order (a regressing seq looks like a stall)
            _atomic_write(hb_path(self.root, self.rank), payload)
        from . import injection as _inj

        _inj.record_event("heartbeat", f"rank {self.rank} seq {self.seq} step {self.step}")
        return payload

    def abort(self, reason=""):
        """Drop the ABORT marker + a final ABORT-status heartbeat (best
        effort: called from dying paths, must never raise)."""
        self.status = STATUS_ABORT
        try:
            _atomic_write(
                abort_path(self.root, self.rank),
                {"rank": self.rank, "reason": str(reason)[:512], "time": time.time()},
            )
            self.beat()
        except OSError as e:
            logger.error("abort marker write failed: %s", e)

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)
            self._thread = None


_active = None
_active_lock = threading.Lock()


def current():
    """The process's active HeartbeatWriter (or None)."""
    return _active


def maybe_start(rank=None, root=None, interval=None):
    """Start (once) the heartbeat writer from the launch controller's env
    contract; returns the active writer, or None when no heartbeat dir is
    exported (standalone runs)."""
    global _active
    root = root if root is not None else os.environ.get(ENV_DIR, "")
    if not root:
        return None
    with _active_lock:
        if _active is not None:
            return _active
        if rank is None:
            rank = int(os.environ.get(ENV_RANK, "0") or "0")
        if interval is None:
            interval = float(os.environ.get(ENV_INTERVAL, "1.0") or "1.0")
        _active = HeartbeatWriter(root, rank, interval=interval)
        logger.info(
            "heartbeat started: rank %d -> %s (interval %.2fs)", rank, root, interval
        )
        return _active


def reset():
    """Stop and forget the active writer (tests)."""
    global _active
    with _active_lock:
        if _active is not None:
            _active.stop()
            _active = None


def write_abort(reason="", rank=None, root=None):
    """Drop an ABORT marker for this rank (starts no thread); no-op when
    the launcher exported no heartbeat dir."""
    root = root if root is not None else os.environ.get(ENV_DIR, "")
    if not root:
        return False
    if rank is None:
        # an explicit rank bypasses the active writer: tests (and tooling)
        # use it to drop a marker on behalf of a DIFFERENT rank
        if _active is not None:
            _active.abort(reason)
            return True
        rank = int(os.environ.get(ENV_RANK, "0") or "0")
    try:
        os.makedirs(root, exist_ok=True)
        _atomic_write(
            abort_path(root, rank),
            {"rank": int(rank), "reason": str(reason)[:512], "time": time.time()},
        )
        return True
    except OSError as e:
        logger.error("abort marker write failed: %s", e)
        return False


def check_peer_abort(root=None, self_rank=None):
    """Raise :class:`PeerAbort` (exit 75) if any OTHER rank dropped an
    ABORT marker.  Cheap no-op outside a launched job; call before
    blocking regions (collective wait) and at step boundaries."""
    root = root if root is not None else os.environ.get(ENV_DIR, "")
    if not root:
        return
    if self_rank is None:
        self_rank = int(os.environ.get(ENV_RANK, "0") or "0")
    for rank, payload in scan_aborts(root).items():
        if rank != int(self_rank):
            reason = payload.get("reason", "")
            logger.error(
                "peer rank %d aborted (%s); exiting 75 for gang restart "
                "instead of hanging in the next collective", rank, reason,
            )
            raise PeerAbort(rank, reason)
