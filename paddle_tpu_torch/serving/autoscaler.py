"""The closed-loop serving autoscaler (counterpart of
`paddle_tpu/serving/autoscaler.py`).

An `Autoscaler` runs beside the `Router` and, every
`FLAGS_autoscale_interval` seconds, reads the fleet's own probe snapshots
(queue depth, `drain_estimate_s`, the `deadline_miss_rate` EWMA,
`tokens_per_step`, `page_free_frac`) and spawns or drains replicas to hold
the SLO.

The control law (every threshold a `FLAGS_autoscale_*` flag):

- **Pressure** (wants up), any of: no ready replica; the fleet's best
  drain estimate above `up_drain_s`; mean queued requests per ready
  replica above `up_queue_depth`; any replica's miss-rate EWMA above
  `up_miss_rate`; any replica's free page fraction below `min_page_free`.
- **Idle** (wants down), all of: the fleet above `min_replicas`, every
  ready replica's drain estimate at most `down_drain_s`, no queued or
  active work, the miss rate under the bar, and at least
  `down_idle_tokens_s` of idle decode capacity.
- **Hysteresis**: a want acts after `up_ticks` / `down_ticks` consecutive
  ticks.  **Cooldowns**: after any action, a scale-up waits `up_cooldown`
  and a scale-down `down_cooldown`.  **Band**: the fleet stays within
  [`min_replicas`, `max_replicas`].

A scale-up spawns a replica (`spawn_fn`, by default a `ReplicaProcess`
worker) and registers it with `Router.add_replica`; it takes no traffic
until its probe reads ready.  The `autoscale.spawn` fault point fires in
the spawn path: a failed spawn is absorbed, counted and retried after the
cooldown.  A spawn's tensor-parallel degree is `choose_tp`'s (the
reference's rule): the largest power of two up to `tp_max` that fits the
devices no replica claims and divides `kv_heads`; on one card that is 1.
A role pool (`role="prefill"` or `"decode"`) spawns tp role replicas
(`--tp N --role R`), whose handoffs carry whole kv heads whatever either
side's degree.
A scale-down rides the admin drain of `rolling_restart`: the
router stops picking the victim, the loop polls its probe until in-flight
work is done (bounded by `FLAGS_serve_drain_grace`), and only then
deregisters and stops it, so no request is aborted.  Managed workers
whose process died are reaped each tick.  With the router's journal the
band and the cooldown clock are journaled, and a successor restores them.

Every decision is a flight-recorder event (kind ``autoscale``) with the
signal vector behind it, a span (``autoscaler.scale_up`` /
``autoscaler.scale_down``) and a profiler counter (`paddle_autoscaler_*`
on /metrics).
"""

from __future__ import annotations

import itertools
import threading
import time

from .. import profiler as _prof
from ..framework import core as _core
from ..obs import flight as _flight
from ..obs import trace as _obs
from .replica import Replica, ReplicaProcess

# snapshot keys every decision event carries into the flight ring (the
# full signal vector, rounded — a dump must justify the decision alone)
_SIGNAL_KEYS = (
    "replicas", "ready", "min_drain_s", "max_drain_s", "mean_queue",
    "max_miss_rate", "min_page_free", "busy", "idle_tokens_per_s",
)


def load_signals(snapshots, role=None):
    """Fold per-replica probe snapshots into the fleet signal vector the
    control law reads.  Pure (unit-testable without a router): draining
    and down replicas count toward fleet size but not toward load — a
    fleet of one dead replica reads as ready=0, which is pressure.

    `role` restricts the fold to one serving role's band: a
    disaggregated fleet runs one controller per role, each scaling its
    own slice on its own signals — prefill bands feel compute backlog,
    decode bands feel page starvation — without double-counting the
    other's replicas against its [min, max] band."""
    if role is not None:
        snapshots = [
            s for s in snapshots if s.get("role", "colocated") == role
        ]
    ready = [
        s for s in snapshots
        if s["state"] == "ready" and not s["admin_draining"]
    ]
    n = len(ready)
    return {
        "replicas": len(snapshots),
        "ready": n,
        "min_drain_s": min((s["drain_estimate_s"] for s in ready), default=0.0),
        "max_drain_s": max((s["drain_estimate_s"] for s in ready), default=0.0),
        "mean_queue": (sum(s["queue_depth"] for s in ready) / n) if n else 0.0,
        "max_miss_rate": max(
            (s.get("deadline_miss_rate", 0.0) for s in ready), default=0.0
        ),
        "min_page_free": min(
            (s.get("page_free_frac", 1.0) for s in ready), default=1.0
        ),
        "busy": any(s["queue_depth"] or s["active_slots"] for s in ready),
        # the cost signal: decode capacity sitting idle
        # RIGHT NOW, in tokens/s — per idle ready replica, its per-step
        # token yield over its EWMA step time.  What a scale-down would
        # reclaim; 0.0 when every ready replica holds work (reclaiming a
        # busy replica is not a cost win, it is a capacity loss)
        "idle_tokens_per_s": sum(
            s.get("tokens_per_step", 1.0) * (1e3 / ewma)
            for s in ready
            if not (s["queue_depth"] or s["active_slots"])
            and (ewma := s.get("decode_ewma_ms", 0.0)) > 0
        ),
    }


def decide(sig, cfg):
    """One pure control-law evaluation: (want, reason).  `want` is "up",
    "down", or "hold"; `reason` names the FIRST signal that justified it
    (the string every flight event and span carries).  Hysteresis and
    cooldowns are the caller's job — this is the memoryless core."""
    if sig["replicas"] < cfg["max_replicas"]:
        if sig["ready"] == 0:
            return "up", "no ready replica"
        if sig["min_drain_s"] > cfg["up_drain_s"]:
            return "up", (
                f"best drain {sig['min_drain_s']:.2f}s > {cfg['up_drain_s']}s"
            )
        if sig["mean_queue"] > cfg["up_queue_depth"]:
            return "up", (
                f"mean queue {sig['mean_queue']:.1f} > {cfg['up_queue_depth']}"
            )
        if sig["max_miss_rate"] > cfg["up_miss_rate"]:
            return "up", (
                f"miss rate {sig['max_miss_rate']:.3f} > {cfg['up_miss_rate']}"
            )
        if sig["min_page_free"] < cfg["min_page_free"]:
            return "up", (
                f"page free {sig['min_page_free']:.3f} < {cfg['min_page_free']}"
            )
    if (
        sig["replicas"] > cfg["min_replicas"]
        and sig["ready"] > cfg["min_replicas"]
        and not sig["busy"]
        and sig["max_drain_s"] <= cfg["down_drain_s"]
        and sig["max_miss_rate"] <= cfg["up_miss_rate"]
        # the $/token gate: only shrink when the fleet is
        # actually wasting decode capacity — emptiness alone does not
        # justify a drain when the reclaimable idle throughput is below
        # the configured floor (0.0 keeps the pure-emptiness behavior)
        and sig.get("idle_tokens_per_s", 0.0)
        >= cfg.get("down_min_idle_tokens_s", 0.0)
    ):
        reason = (
            f"idle: max drain {sig['max_drain_s']:.2f}s <= "
            f"{cfg['down_drain_s']}s, no queued/active work"
        )
        idle_tok = sig.get("idle_tokens_per_s", 0.0)
        if idle_tok > 0:
            chips = max(1, int(cfg.get("chips", 1)))
            reason += (
                f", reclaim {idle_tok / chips:.1f} idle tokens/s/chip"
            )
        return "down", reason
    return "hold", "within band"


def choose_tp(free_devices, tp_max, kv_heads=None):
    """TP degree for a new replica: the largest power of two that fits the
    unclaimed devices, clamped by `tp_max` and (when given) dividing
    `kv_heads` — the same divisibility contract engine construction
    enforces with a typed ShardingError.  Always >= 1: a fleet out of
    free devices still spawns a single-device replica (oversubscription
    beats an under-provisioned fleet on CPU and is probed-before-picked
    everywhere)."""
    tp = 1
    cap = max(1, min(int(free_devices), int(tp_max)))
    while tp * 2 <= cap and (kv_heads is None or kv_heads % (tp * 2) == 0):
        tp *= 2
    return tp


class Autoscaler:
    """The closed loop.  Construct over a started `Router`, then either
    `start()` the background control thread or drive `tick()` inline
    (tests and the soak harness do the latter with an explicit clock).

    `spawn_fn(index, tp)` must return a ready-to-register `Replica`
    (default: boot a `ReplicaProcess` subprocess worker and wrap it);
    `stop_fn(replica)` tears one down after its drain (default: SIGTERM
    the managed process).  Injecting both keeps the control law testable
    with in-process replicas — the loop itself never cares which."""

    def __init__(self, router, spawn_fn=None, stop_fn=None, *,
                 min_replicas=None, max_replicas=None, interval=None,
                 up_ticks=None, down_ticks=None, up_cooldown=None,
                 down_cooldown=None, up_drain_s=None, up_queue_depth=None,
                 up_miss_rate=None, min_page_free=None, down_drain_s=None,
                 down_min_idle_tokens_s=None, tp_max=None, devices_total=None,
                 kv_heads=None, drain_grace=None, log_dir=None, journal=None,
                 role=None):
        f = _core.flag

        def _pick(v, name, cast):
            return cast(v if v is not None else f(name))

        self.router = router
        self._spawn_fn = spawn_fn
        self._stop_fn = stop_fn
        # disaggregated fleets run ONE controller per role:
        # this instance reads only its role's signals, drains only its
        # role's replicas, and spawns workers booted into that role
        self.role = None if role is None else str(role)
        self.min_replicas = _pick(min_replicas, "FLAGS_autoscale_min_replicas", int)
        self.max_replicas = _pick(max_replicas, "FLAGS_autoscale_max_replicas", int)
        if not 1 <= self.min_replicas <= self.max_replicas:
            raise ValueError(
                f"bad replica band [{self.min_replicas}, {self.max_replicas}]"
            )
        self.interval = _pick(interval, "FLAGS_autoscale_interval", float)
        self.up_ticks = _pick(up_ticks, "FLAGS_autoscale_up_ticks", int)
        self.down_ticks = _pick(down_ticks, "FLAGS_autoscale_down_ticks", int)
        self.up_cooldown = _pick(up_cooldown, "FLAGS_autoscale_up_cooldown", float)
        self.down_cooldown = _pick(
            down_cooldown, "FLAGS_autoscale_down_cooldown", float)
        self.cfg = {
            "min_replicas": self.min_replicas,
            "max_replicas": self.max_replicas,
            "up_drain_s": _pick(up_drain_s, "FLAGS_autoscale_up_drain_s", float),
            "up_queue_depth": _pick(
                up_queue_depth, "FLAGS_autoscale_up_queue_depth", float),
            "up_miss_rate": _pick(
                up_miss_rate, "FLAGS_autoscale_up_miss_rate", float),
            "min_page_free": _pick(
                min_page_free, "FLAGS_autoscale_min_page_free", float),
            "down_drain_s": _pick(
                down_drain_s, "FLAGS_autoscale_down_drain_s", float),
            "down_min_idle_tokens_s": _pick(
                down_min_idle_tokens_s,
                "FLAGS_autoscale_down_idle_tokens_s", float),
        }
        self.tp_max = _pick(tp_max, "FLAGS_autoscale_tp_max", int)
        if devices_total is None:
            import torch

            devices_total = max(1, torch.cuda.device_count())
        self.devices_total = int(devices_total)
        self.cfg["chips"] = max(1, self.devices_total)
        self.kv_heads = kv_heads
        self.drain_grace = float(
            drain_grace if drain_grace is not None
            else f("FLAGS_serve_drain_grace")
        )
        self.log_dir = log_dir
        # device claims: every pre-existing replica is assumed tp=1 (the
        # probe snapshot carries no degree); managed spawns record theirs
        self._claimed = {r.rid: 1 for r in router.replicas}
        self._managed = {}  # rid -> Replica, spawn order preserved
        self._seq = itertools.count()
        self._up_streak = 0
        self._down_streak = 0
        self._last_action_t = None  # monotonic time of the last up/down
        # durable control plane: default to the router's journal
        # so a journaled router automatically journals its controller too.
        # A RESUMED journal restores the cooldown clock — the journaled
        # wall-clock elapsed-since-last-action maps onto THIS process's
        # monotonic clock, so a successor does not flap the fleet the
        # moment it takes over (the primary's cooldown still binds).
        self.journal = (
            journal if journal is not None
            else getattr(router, "journal", None)
        )
        if self.journal is not None and self.journal.resumed:
            st = self.journal.state_snapshot().get("autoscale")
            if st:
                elapsed = max(0.0, time.time() - st["last_action_wall"])
                self._last_action_t = time.monotonic() - elapsed
                self._up_streak = int(st.get("up_streak", 0))
                self._down_streak = int(st.get("down_streak", 0))
                _flight.record(
                    "autoscale",
                    f"cooldown clock restored from journal "
                    f"({elapsed:.2f}s since last action)",
                    band=st.get("band"),
                )
        # one control lock serializes ticks: the background loop and any
        # inline tick() caller (tests, the soak harness) never interleave
        # a decision — scale actions are strictly sequential
        self._ctl_mu = threading.Lock()
        self._stop_ev = threading.Event()
        self._thread = None

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is not None:
            return self
        self._stop_ev.clear()
        t = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True
        )
        self._thread = t
        t.start()
        return self

    def stop(self):
        self._stop_ev.set()
        t = self._thread
        if t is not None:
            t.join(max(5.0, self.drain_grace + 5.0))
        self._thread = None

    def _loop(self):
        while not self._stop_ev.wait(self.interval):
            try:
                self.tick()
            except Exception as e:  # the loop must outlive one bad tick
                _flight.record("autoscale", f"tick error: {e}")

    # -- control law ---------------------------------------------------------

    def tick(self, now=None):
        """One control tick: read signals, apply hysteresis + cooldowns,
        act.  Returns {"want", "action", "reason", "signals"} so tests and
        the soak harness can assert the loop's reasoning directly.
        Serialized by _ctl_mu against the background loop."""
        with self._ctl_mu:
            return self._tick_locked(
                time.monotonic() if now is None else now
            )

    def _tick_locked(self, now):
        _prof.record_autoscale_event("ticks")
        self._reap_dead(now)
        sig = load_signals(
            [rep.snapshot() for rep in self.router.replicas], role=self.role
        )
        _prof.record_autoscale_replicas(sig["replicas"])
        want, reason = decide(sig, self.cfg)
        if want == "up":
            self._up_streak += 1
            self._down_streak = 0
        elif want == "down":
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        action = "hold"
        if (
            want == "up"
            and self._up_streak >= self.up_ticks
            and self._cooled(now, self.up_cooldown)
        ):
            action = "up" if self._scale_up(sig, reason) else "hold"
        elif (
            want == "down"
            and self._down_streak >= self.down_ticks
            and self._cooled(now, self.down_cooldown)
        ):
            action = "down" if self._scale_down(sig, reason) else "hold"
        if action == "hold":
            _prof.record_autoscale_event("holds")
        else:
            self._last_action_t = now
            self._up_streak = self._down_streak = 0
            if self.journal is not None:
                # journal the band + cooldown clock in WALL time (monotonic
                # clocks do not survive process death): a successor maps
                # elapsed-since-action back onto its own monotonic clock
                self.journal.append(
                    "autoscale",
                    band=[self.min_replicas, self.max_replicas],
                    last_action_wall=time.time(),
                    up_streak=self._up_streak,
                    down_streak=self._down_streak,
                )
        return {"want": want, "action": action, "reason": reason,
                "signals": sig}

    def _reap_dead(self, now):
        """Deregister MANAGED workers whose subprocess died (chaos kill -9,
        crash): a dead registration would count toward the band and pin the
        fleet at max_replicas with less-than-max live capacity — the loop
        could never replace what the chaos took.  Seed replicas the
        operator registered stay put: `rolling_restart` owns their respawn
        path (the Container revives the same process slot)."""
        for rid, rep in list(self._managed.items()):
            if rep.process is None or rep.process.alive():
                continue
            try:
                self.router.remove_replica(rid)
            except KeyError:
                pass
            self._managed.pop(rid, None)
            self._claimed.pop(rid, None)
            _prof.record_autoscale_event("reaps")
            _prof.record_autoscale_replicas(len(self.router.replicas))
            _flight.record(
                "autoscale", f"reaped dead replica {rid}",
                fleet=len(self.router.replicas),
            )

    def _cooled(self, now, cooldown):
        return self._last_action_t is None or (
            now - self._last_action_t >= cooldown
        )

    def _free_devices(self):
        return max(0, self.devices_total - sum(self._claimed.values()))

    def _event_fields(self, sig):
        return {
            k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in sig.items() if k in _SIGNAL_KEYS
        }

    # -- actions -------------------------------------------------------------

    def _scale_up(self, sig, reason):
        """Spawn + register one replica.  False on spawn failure (counted,
        recorded, retried after the cooldown) — a chaos-armed
        `autoscale.spawn` fault lands here, not in the control thread's
        lap."""
        from ..fault import injection as _inj

        tid, sid = _obs.new_trace_id(), _obs.new_span_id()
        t0 = time.perf_counter()
        idx = next(self._seq)
        tp = choose_tp(self._free_devices(), self.tp_max, self.kv_heads)
        try:
            _inj.inject("autoscale.spawn", context=f"as{idx}")
            rep = (
                self._spawn_fn(idx, tp) if self._spawn_fn is not None
                else self._default_spawn(idx, tp)
            )
            self.router.add_replica(rep)
        except Exception as e:
            _prof.record_autoscale_event("spawn_failures")
            _flight.record(
                "autoscale", f"scale_up FAILED: {e}", reason=reason, tp=tp,
                **self._event_fields(sig),
            )
            _obs.record(
                "autoscaler.scale_up", tid, t0=t0, t1=time.perf_counter(),
                span_id=sid, status="error", error=f"{type(e).__name__}: {e}",
                tp=tp,
            )
            return False
        self._managed[rep.rid] = rep
        self._claimed[rep.rid] = tp
        _prof.record_autoscale_event("scale_ups")
        _prof.record_autoscale_replicas(len(self.router.replicas))
        _flight.record(
            "autoscale", f"scale_up -> {rep.rid}", reason=reason, tp=tp,
            fleet=len(self.router.replicas), **self._event_fields(sig),
        )
        _obs.record(
            "autoscaler.scale_up", tid, t0=t0, t1=time.perf_counter(),
            span_id=sid, status="ok", replica=rep.rid, tp=tp, reason=reason,
        )
        return True

    def _scale_down(self, sig, reason):
        """Drain + deregister one replica through the admin-drain path
        (exactly-once: the router stops picking it, in-flight work
        finishes, ONLY then is the worker stopped)."""
        rep = self._pick_victim()
        if rep is None:
            return False
        tid, sid = _obs.new_trace_id(), _obs.new_span_id()
        t0 = time.perf_counter()
        rep.set_admin_draining(True)
        drained = False
        deadline = time.monotonic() + self.drain_grace
        while time.monotonic() < deadline:
            h = rep.probe()
            if h is None or (
                not h.get("active_slots") and not h.get("queue_depth")
            ):
                drained = True
                break
            time.sleep(0.05)
        self.router.remove_replica(rep.rid)
        self._managed.pop(rep.rid, None)
        self._claimed.pop(rep.rid, None)
        # the decision is complete at deregistration: count it BEFORE the
        # worker teardown below, which can block for seconds
        _prof.record_autoscale_event("scale_downs")
        _prof.record_autoscale_replicas(len(self.router.replicas))
        try:
            if self._stop_fn is not None:
                self._stop_fn(rep)
            elif rep.process is not None:
                rep.process.terminate()
        except Exception as e:
            _flight.record("autoscale", f"stop {rep.rid} failed: {e}")
        _flight.record(
            "autoscale", f"scale_down -> {rep.rid}", reason=reason,
            drained=drained, fleet=len(self.router.replicas),
            **self._event_fields(sig),
        )
        _obs.record(
            "autoscaler.scale_down", tid, t0=t0, t1=time.perf_counter(),
            span_id=sid, status="ok" if drained else "forced",
            replica=rep.rid, reason=reason,
        )
        return True

    def _pick_victim(self):
        """Least-loaded ready replica, managed spawns first (LIFO within
        the tie) — the seed fleet the operator registered by hand is the
        last thing the controller drains, and never below the band."""
        cands = []
        for i, rep in enumerate(self.router.replicas):
            s = rep.snapshot()
            if s["state"] != "ready" or s["admin_draining"]:
                continue
            if (
                self.role is not None
                and s.get("role", "colocated") != self.role
            ):
                continue
            cands.append((
                0 if rep.rid in self._managed else 1,
                s["queue_depth"] + s["active_slots"],
                -i,  # LIFO: newest spawn drains first on ties
                rep,
            ))
        ready = len(cands)
        if ready <= self.min_replicas:
            return None
        cands.sort(key=lambda c: c[:3])
        return cands[0][3]

    def _default_spawn(self, idx, tp):
        """Boot a ReplicaProcess worker on a free port and wait for its
        port to accept (readiness itself is probe-driven: the router only
        picks it after /healthz says ready)."""
        import socket
        import tempfile

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        log_dir = self.log_dir or tempfile.mkdtemp(prefix="autoscale_log_")
        extra = ["--tp", str(tp)] if tp > 1 else []
        if self.role is not None and self.role != "colocated":
            extra += ["--role", self.role]
        proc = ReplicaProcess(
            index=100 + idx, port=port, log_dir=log_dir, extra_args=extra,
        ).start()
        return Replica(f"as{idx}", proc.url, process=proc)
