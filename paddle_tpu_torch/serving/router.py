"""The serving router (counterpart of `paddle_tpu/serving/router.py`): a
front door over N `serve()` replicas with health-checked failover,
deadline propagation, breakers, brownout, hedging and rolling restarts.

A `Router` owns a registry of replicas (each a `serve()` instance,
optionally a router-managed `ReplicaProcess`).  A probe thread GETs every
replica's `/healthz` each `FLAGS_router_probe_interval` and keeps its
state and load gauges.

The routing contract:

- **Bounded admission**: at most `FLAGS_router_max_inflight` requests in
  flight through the router; past that, a 503 RouterOverloaded with a
  Retry-After from the healthiest replica's drain estimate, clamped by the
  request's own deadline.
- **Deadline propagation**: the client's `X-Deadline-Ms` (or body
  `deadline_s`) becomes an absolute deadline at arrival; every hop gets
  only the remaining budget.  A spent budget answers 504
  DeadlineExhausted without touching a replica; a deadline no ready
  replica's drain estimate can meet answers 504 DeadlineUnattainable
  first: over-deadline work never queues behind feasible work.
- **Failover, exactly once**: a connect failure, a 503 or a retriable
  typed error retries a zero-token request on another replica with
  jittered exponential backoff, up to `FLAGS_router_max_retries` and the
  remaining deadline.  The decision reads the typed error's `retriable`,
  never its text.  Once response bytes have crossed, the request fails
  typed (502 UpstreamIncomplete, not retriable): a retry could deliver
  twice.
- **Circuit breaker** per replica (`Replica`), **hedging** (with
  `FLAGS_router_hedge_s` > 0 a zero-token request unanswered after the
  delay is duplicated onto a second replica, the first complete response
  wins) and **rolling restarts** (`rolling_restart`: admin-drain, wait,
  restart, readmit once /healthz reads ready).
- **Disaggregated pipeline**: with a ready prefill-role and a ready
  decode-role replica, a single-prompt request without an adapter or a
  session goes /reserve (decode pages held first) -> /prefill (prefill,
  one token, the page export) -> /generate with the handoff on the decode
  worker.  `pick_pair()` scores prefill workers on compute backlog and
  decode workers on page headroom; page-starved decode workers are
  skipped, and with none left the request gets 503 NoDecodeCapacity.
  A pair's tensor-parallel degrees need not match: the handoff carries
  whole kv heads, so a tp-2 prefill worker hands off to a tp-1 decode
  worker and the reverse, and the pick never reads the degree.
  Every hop failure before decode bytes cross is a zero-token failover
  of the whole pipeline (the prefill is deterministic, so the retry's
  tokens are the same); an abandoned reservation lapses at its TTL.
- **Session affinity**: a request with a `session_id` goes to the replica
  that answered the session's last turn (its KV pages live there).  A
  dead, draining or breaker-open pin is dropped (a repin) and the turn
  takes a normal pick: the new replica prefills the conversation afresh,
  answers the same tokens, and becomes the pin.  The pins are not
  journaled.
- **Adapter-resident picks**: a request naming a LoRA adapter prefers the
  replicas whose last probe listed it resident.

Chaos: `router.replica.hang` wedges one dispatch, `router.replica.flap`
fails probes, `router.replica.kill` SIGKILLs a managed replica at probe
time, `disagg.handoff.drop` loses a handoff between its hops and
`router.crash` kills the front door: all armed through the
`FLAGS_fault_inject` registry.

The crash-proof front door: with a `journal=` the router journals every
breaker transition, registry and drain decision and idempotency outcome
(`journal.Journal`) and beats a rank-0 heartbeat from its probe loop.
Requests with an `X-Idempotency-Key` dedupe against a TTL'd cache with an
in-flight join.  After `router.crash` the heartbeat goes stale; a
`RouterStandby` sees it on its own clock, replays the journal, restores
the breakers, probes the fleet and serves (WATCHING -> TAKING_OVER ->
SERVING).

Host code over HTTP: nothing here touches the card; the replicas'
engines do.
"""

from __future__ import annotations

import json
import random
import threading
import time

from .. import profiler as _prof
from ..framework import core as _core
from ..obs import flight as _flight
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from .journal import IdempotencyCache, Journal
from .replica import Replica, ReplicaTransportError


def _count_by_value(mapping):
    out = {}
    for v in mapping.values():
        out[v] = out.get(v, 0) + 1
    return out


class RouterError(RuntimeError):
    """A typed router-level failure (with its HTTP mapping)."""

    status = 500
    retriable = False

    def __init__(self, msg, retry_after_s=None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class NoReadyReplica(RouterError):
    status = 503
    retriable = True


class RouterOverloaded(RouterError):
    status = 503
    retriable = True


class NoDecodeCapacity(RouterError):
    """Every decode-role worker is page-starved (no free page), so a
    handoff has nowhere to land: 503 with Retry-After, retriable (pages
    free as streams finish)."""

    status = 503
    retriable = True


class DeadlineExhausted(RouterError):
    status = 504
    retriable = False


class RouterCrashed(RuntimeError):
    """The router is dead (the `router.crash` drill): an in-process caller
    sees this where an HTTP client sees a connection reset, never a typed
    response.  The caller resubmits the same idempotency key to the
    successor; the dedupe on both sides keeps it to one generation."""


class Router:
    """The front door over N serve() replicas.  Handler threads call
    `handle_generate()` alongside the probe thread and the orchestrators;
    the router's own mutable state lives under `self._mu` (a replica's
    under its own lock)."""

    def __init__(self, replicas, probe_interval=None, probe_timeout=None,
                 max_retries=None, retry_backoff=None, max_inflight=None,
                 hedge_s=None, seed=0, journal=None, heartbeat=None,
                 idem_ttl=None):
        self.replicas = [r if isinstance(r, Replica) else Replica(f"r{i}", r)
                         for i, r in enumerate(replicas)]
        if len({r.rid for r in self.replicas}) != len(self.replicas):
            raise ValueError("replica ids must be unique")
        f = _core.flag
        self.probe_interval = float(probe_interval if probe_interval is not None
                                    else f("FLAGS_router_probe_interval"))
        self.probe_timeout = float(probe_timeout if probe_timeout is not None
                                   else f("FLAGS_router_probe_timeout"))
        self.max_retries = int(max_retries if max_retries is not None
                               else f("FLAGS_router_max_retries"))
        self.retry_backoff = float(retry_backoff if retry_backoff is not None
                                   else f("FLAGS_router_retry_backoff"))
        self.max_inflight = int(max_inflight if max_inflight is not None
                                else f("FLAGS_router_max_inflight"))
        self.hedge_s = float(hedge_s if hedge_s is not None
                             else f("FLAGS_router_hedge_s"))
        self.idem_ttl = float(idem_ttl if idem_ttl is not None
                              else f("FLAGS_router_idem_ttl"))
        self._retry_after_jitter = float(f("FLAGS_router_retry_after_jitter"))
        self._mu = threading.Lock()
        # the jitter of backoffs and Retry-After values: the same seed draws
        # the same sequence as the reference's router
        self._rng = random.Random(seed)
        self._inflight = 0
        self._session_pins = {}  # session id -> replica id
        self._stop = threading.Event()
        self._probe_thread = None
        self._crashed = False
        self._takeovers = 0
        # journal: the durable control plane (a path opens or replays one);
        # heartbeat: the rank-0 liveness a standby watches (a path starts a
        # writer)
        self.journal = (journal if journal is None or isinstance(journal, Journal)
                        else Journal(journal))
        if heartbeat is None or not isinstance(heartbeat, str):
            self._heartbeat = heartbeat
        else:
            from ..fault import heartbeat as _hb

            self._heartbeat = _hb.HeartbeatWriter(heartbeat, rank=0, interval=0.0)
        self._idem = IdempotencyCache(self.idem_ttl, journal=self.journal)
        if self.journal is not None:
            self._bootstrap_from_journal()

    def _bootstrap_from_journal(self):
        """A fresh journal gets the fleet registry.  A resumed one (this
        router is the successor after a takeover) rehydrates first: the
        journaled replicas missing from the registry, the breakers (so the
        successor does not close onto a replica the primary knew was sick),
        the drain flags and the completed idempotent responses; the
        autoscaler reads its clocks from the same state.  The replicas bind
        the journal last, so the restoration is not journaled again."""
        j = self.journal
        resumed = j.resumed
        st = j.state_snapshot() if resumed else None
        if resumed:
            t0 = time.perf_counter()
            reps = list(self.replicas)
            known = {r.rid for r in reps}
            for rid, info in st["replicas"].items():
                if rid not in known:
                    reps.append(Replica(rid, info["url"]))
            with self._mu:
                self.replicas = reps
            by_rid = {r.rid: r for r in reps}
            for rid, info in st["replicas"].items():
                rep = by_rid.get(rid)
                if rep is not None and info.get("draining"):
                    rep.set_admin_draining(True)
            for rid, b in st["breakers"].items():
                rep = by_rid.get(rid)
                if rep is not None:
                    rep.restore_breaker(b["breaker"], b["fails"],
                                        b["open_until_wall"])
            restored = self._idem.restore(st["idem"])
            with self._mu:
                self._takeovers = int(st["takeovers"]) + 1
                takeovers = self._takeovers
            j.append("takeover")
            _prof.record_router_event("takeovers")
            _flight.record(
                "router", f"takeover #{takeovers}: journal replayed to seq "
                f"{st['seq']}", replicas=len(reps), breakers=len(st["breakers"]),
                idem_restored=restored)
            _obs.record("router.takeover", _obs.new_trace_id(), t0=t0,
                        t1=time.perf_counter(), status="ok",
                        takeovers=takeovers, journal_seq=st["seq"])
        for rep in self.replicas:
            if not resumed or rep.rid not in st["replicas"]:
                j.append("replica", op="register", rid=rep.rid, url=rep.base_url)
            rep.bind_journal(j)

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        """One probe sweep now (so pick() has state before any traffic),
        then the background probe loop."""
        with self._mu:
            if self._probe_thread is not None:
                return self
        self.probe_once()
        t = threading.Thread(target=self._probe_loop, name="router-probe",
                             daemon=True)
        with self._mu:
            self._probe_thread = t
        t.start()
        return self

    def stop(self):
        self._stop.set()
        with self._mu:
            t = self._probe_thread
        if t is not None:
            t.join(5)

    def _probe_loop(self):
        while not self._stop.wait(self.probe_interval):
            self.probe_once()

    def probe_once(self):
        """One probe sweep over the registry (the probe thread's body;
        drills call it inline)."""
        from ..fault import injection as _inj

        if _inj.should_fire("router.crash"):
            self._crash("injected router.crash")
            return
        for rep in self.replicas:
            if (rep.process is not None
                    and _inj.should_fire("router.replica.kill", context=rep.rid)):
                rep.process.kill9()
            if _inj.should_fire("router.replica.flap", context=rep.rid):
                rep.note_probe_failure("injected flap")
            else:
                rep.probe(timeout=self.probe_timeout)
            _prof.record_router_replica_state(rep.rid, rep.state)
        hb = self._heartbeat
        if hb is not None:
            try:
                # the heartbeat rides the probe loop: an advancing seq says
                # the front door is alive and sweeping its fleet
                hb.beat()
            except OSError:
                pass

    def _crash(self, reason):
        """The router.crash drill (kill -9 of the front door): every
        in-flight and later handle_generate raises RouterCrashed (the HTTP
        layer drops the connection), the probe loop stops and the heartbeat
        goes stale, so a RouterStandby takes over.  The journal is left
        open, as a SIGKILL leaves it."""
        with self._mu:
            if self._crashed:
                return
            self._crashed = True
        self._stop.set()
        _prof.record_router_event("crashes")
        _flight.record("router", f"router crashed: {reason}")
        _flight.dump("router-crash")
        hb = self._heartbeat
        if hb is not None:
            hb.stop()

    def _check_crashed(self):
        with self._mu:
            crashed = self._crashed
        if crashed:
            raise RouterCrashed("router process is dead (kill -9 drill)")

    # -- registry (the autoscaler grows and shrinks the fleet live) ----------

    def add_replica(self, rep):
        """Register one replica while traffic flows.  `self.replicas` is
        replaced (copy on write) under `_mu`, never changed in place: a
        handler mid-scan keeps a consistent list.  The replica enters as
        'connecting' and takes no request until a probe reads ready."""
        rep = rep if isinstance(rep, Replica) else Replica(
            f"r{len(self.replicas)}", rep)
        with self._mu:
            if any(r.rid == rep.rid for r in self.replicas):
                raise ValueError(f"replica id {rep.rid!r} already registered")
            self.replicas = self.replicas + [rep]
        _prof.record_router_replica_state(rep.rid, rep.state)
        _flight.record("router", f"replica {rep.rid} registered",
                       url=rep.base_url, fleet=len(self.replicas))
        if self.journal is not None:
            self.journal.append("replica", op="register", rid=rep.rid,
                                url=rep.base_url)
            rep.bind_journal(self.journal)
        return rep

    def remove_replica(self, rid):
        """Deregister one replica (copy on write) and return its handle; the
        caller drained it first and ends its process."""
        with self._mu:
            rep = next((r for r in self.replicas if r.rid == rid), None)
            if rep is None:
                raise KeyError(f"no replica with id {rid!r}")
            self.replicas = [r for r in self.replicas if r.rid != rid]
        _prof.record_router_replica_state(rep.rid, "removed")
        _flight.record("router", f"replica {rep.rid} deregistered",
                       fleet=len(self.replicas))
        if self.journal is not None:
            self.journal.append("replica", op="deregister", rid=rep.rid)
        return rep

    # -- selection -----------------------------------------------------------

    def pick(self, exclude=(), adapter=None):
        """The least-loaded ready replica whose breaker admits: scored by
        (adapter residency, drain estimate, queued + active work, EWMA
        latency, registry order).  A request naming an adapter prefers the
        replicas that report it resident; a miss stays eligible (every
        replica loads on demand).  Breaker gates are taken in score order,
        so a half-open trial is spent only on the replica chosen.  A
        page-starved replica (no free KV page) is skipped while any other
        is eligible."""
        cands = []
        starved = []
        for i, rep in enumerate(self.replicas):
            if rep.rid in exclude:
                continue
            s = rep.snapshot()
            if s["state"] != "ready" or s["admin_draining"]:
                continue
            miss = 0 if not adapter else int(adapter not in s["lora_adapters"])
            key = (miss, s["drain_estimate_s"],
                   s["queue_depth"] + s["active_slots"], s["ewma_latency_s"],
                   i, rep)
            (starved if s["page_free_frac"] <= 0.0 else cands).append(key)
        for *_, rep in sorted(cands, key=lambda c: c[:5]):
            if rep.allow():
                return rep
        for *_, rep in sorted(starved, key=lambda c: c[:5]):
            if rep.allow():
                return rep
        return None

    def _pinned_replica(self, sid, tried):
        """The usable replica a session is pinned to, or None: a registered
        one that is ready, not draining, not tried in this dispatch and
        whose breaker admits.  Otherwise the pin is dropped (a repin) and
        the caller takes a normal pick."""
        with self._mu:
            rid = self._session_pins.get(sid)
        if rid is None:
            return None
        rep = next((r for r in self.replicas if r.rid == rid), None)
        usable = False
        if rep is not None and rid not in tried:
            s = rep.snapshot()
            usable = (s["state"] == "ready" and not s["admin_draining"]
                      and rep.allow())
        if usable:
            _prof.record_router_event("session_pin_hits")
            return rep
        with self._mu:
            if self._session_pins.get(sid) == rid:
                del self._session_pins[sid]
        _prof.record_router_event("session_repins")
        _flight.record("session", "pin broken, falling back to stateless re-prefill",
                       session_id=sid, pinned_rid=rid,
                       reason="gone" if rep is None else "unavailable")
        return None

    def _pin_session(self, sid, rid):
        with self._mu:
            prev = self._session_pins.get(sid)
            self._session_pins[sid] = rid
        if prev != rid:
            _flight.record("session", "pinned", session_id=sid, rid=rid)

    def pick_pair(self, exclude_prefill=(), exclude_decode=()):
        """The (prefill, decode) pair of the disaggregated pipeline.
        Prefill workers are scored on compute backlog (drain estimate,
        queued + active work, EWMA latency), decode workers on page headroom
        first (the most free pages), then drain estimate.  A decode worker
        with no free page is skipped; when every decode worker is starved
        this raises NoDecodeCapacity.  A side with no ready replica comes
        back None (the caller falls back to the colocated path).  Breaker
        gates are taken in score order.  The two sides' tp degrees may
        differ: the wire is whole kv heads."""
        pre_c, dec_c = [], []
        dec_starved = False
        for i, rep in enumerate(self.replicas):
            s = rep.snapshot()
            if s["state"] != "ready" or s["admin_draining"]:
                continue
            role = s.get("role", "colocated")
            if role == "prefill" and rep.rid not in exclude_prefill:
                pre_c.append((s["drain_estimate_s"],
                              s["queue_depth"] + s["active_slots"],
                              s["ewma_latency_s"], i, rep))
            elif role == "decode" and rep.rid not in exclude_decode:
                if s["page_free_frac"] <= 0.0:
                    dec_starved = True
                    continue
                dec_c.append((-s["page_free_frac"], s["drain_estimate_s"],
                              s["queue_depth"] + s["active_slots"], i, rep))
        pre = next((r for *_, r in sorted(pre_c, key=lambda c: c[:4])
                    if r.allow()), None)
        dec = next((r for *_, r in sorted(dec_c, key=lambda c: c[:4])
                    if r.allow()), None)
        if dec is None and dec_starved:
            _prof.record_disagg_event("no_decode_capacity")
            _flight.record("disagg", "no decode capacity (all page-starved)")
            raise NoDecodeCapacity(
                "every decode worker is page-starved (zero free KV pages)",
                retry_after_s=self.healthiest_retry_after())
        return pre, dec

    def _ready_drains(self):
        return [s["drain_estimate_s"]
                for s in (rep.snapshot() for rep in self.replicas)
                if s["state"] == "ready" and not s["admin_draining"]]

    def healthiest_retry_after(self, default=1.0):
        """Retry-After for a shed request: the smallest drain estimate of
        the ready replicas (the soonest any of them plausibly frees)."""
        drains = self._ready_drains()
        return max(default, min(drains)) if drains else default

    def healthz(self):
        snaps = [rep.snapshot() for rep in self.replicas]
        ready = sum(1 for s in snaps
                    if s["state"] == "ready" and not s["admin_draining"])
        with self._mu:
            inflight = self._inflight
            takeovers = self._takeovers
            session_pins = dict(self._session_pins)
        roles = {}
        for s in snaps:
            if s["state"] == "ready" and not s["admin_draining"]:
                role = s.get("role", "colocated")
                roles[role] = roles.get(role, 0) + 1
        return {
            "status": "ready" if ready else "degraded",
            "ready_replicas": ready,
            "roles": roles,
            "replicas": snaps,
            "inflight": inflight,
            "breakers": {s["id"]: s["breaker"] for s in snaps},
            "takeovers": takeovers,
            "journal_seq": self.journal.seq if self.journal is not None else None,
            "idempotency": self._idem.stats(),
            "session_pins": len(session_pins),
            "session_pins_by_replica": _count_by_value(session_pins),
        }

    # -- routing -------------------------------------------------------------

    def handle_generate(self, payload, deadline_ms=None, trace=None,
                        idem_key=None):
        """Route one /generate body.  Returns (status, body, headers): every
        request resolves exactly once, a success from one replica or one
        typed error.

        `idem_key` (or a body ``idempotency_key``, stripped before
        forwarding) engages the dedupe: a key completed within the TTL
        replays the kept response (``X-Idempotency-Replay: hit``), a key in
        flight joins the live request (``: join``), only a first sight
        executes.  Retriable outcomes are never kept.

        `trace` is the client hop's `(trace_id, parent_span_id)` or None
        (the router mints the trace).  The whole handle is the
        ``router.admit`` root span; error bodies carry the trace id."""
        if idem_key is None and isinstance(payload, dict):
            idem_key = payload.pop("idempotency_key", None)
        self._check_crashed()
        _prof.record_router_event("requests")
        if not idem_key:
            return self._handle_routed(payload, deadline_ms, trace, None)
        verdict, val = self._idem.begin(idem_key)
        if verdict == "done":
            return self._replayed(val, "hit")
        if verdict == "join":
            timeout = (max(0.05, float(deadline_ms) / 1e3)
                       if deadline_ms is not None else 600.0)
            resp = self._idem.wait(val, timeout=timeout)
            self._check_crashed()
            if resp is not None:
                return self._replayed(resp, "join")
            return self._error(
                503, "IdempotentJoinAborted",
                f"in-flight request for key {idem_key!r} ended without a "
                "response; retry with the same key", True,
                self._jitter_retry_after(self.healthiest_retry_after()))
        try:
            status, body, headers = self._handle_routed(payload, deadline_ms,
                                                        trace, idem_key)
        except BaseException:
            self._idem.abandon(idem_key)
            raise
        with self._mu:
            crashed = self._crashed
        if crashed:
            # the router died while this request was in flight: the client
            # saw a reset, never these bytes.  A completed generation is kept
            # on the replica, so the resubmit through the successor replays
            self._idem.abandon(idem_key)
            raise RouterCrashed("router crashed mid-request")
        self._idem.complete(idem_key, status, body, headers)
        return status, body, headers

    @staticmethod
    def _replayed(resp, how):
        status, body, hdrs = resp
        headers = dict(hdrs or {})
        headers["X-Idempotency-Replay"] = how
        return status, body, headers

    def _handle_routed(self, payload, deadline_ms, trace, idem_key):
        tid = trace[0] if trace else _obs.new_trace_id()
        client_sid = trace[1] if trace else None
        admit_sid = _obs.new_span_id()  # minted first: children parent on it
        t_adm = time.perf_counter()
        deadline_t = (time.monotonic() + float(deadline_ms) / 1e3
                      if deadline_ms is not None else None)
        with self._mu:
            admitted = self._inflight < self.max_inflight
            if admitted:
                self._inflight += 1
        if not admitted:
            _prof.record_router_event("brownout_sheds")
            _flight.record("admission", "router gate full (brownout shed)",
                           trace_id=tid, max_inflight=self.max_inflight)
            ra = self._clamp_retry_after(
                self._jitter_retry_after(self.healthiest_retry_after()),
                deadline_t)
            out = self._error(503, "RouterOverloaded",
                              "router admission gate full", True, ra, trace_id=tid)
            _obs.record("router.admit", tid, t0=t_adm, t1=time.perf_counter(),
                        span_id=admit_sid, parent_id=client_sid, status="error",
                        error="RouterOverloaded")
            return out
        try:
            status, body, headers = self._dispatch(payload, deadline_t,
                                                   (tid, admit_sid),
                                                   idem_key=idem_key)
        finally:
            with self._mu:
                self._inflight -= 1
        _obs.record("router.admit", tid, t0=t_adm, t1=time.perf_counter(),
                    span_id=admit_sid, parent_id=client_sid,
                    status="ok" if status == 200 else "error", http_status=status,
                    error=None if status == 200 else (body or {}).get("type"))
        return status, body, headers

    def _dispatch(self, payload, deadline_t, trace, idem_key=None):
        if self._disagg_eligible(payload):
            return self._dispatch_disagg(payload, deadline_t, trace,
                                         idem_key=idem_key)
        return self._dispatch_colocated(payload, deadline_t, trace,
                                        idem_key=idem_key)

    def _disagg_eligible(self, payload):
        """The disaggregated pipeline engages only with a ready prefill-role
        and a ready decode-role replica, for a single prompt with no
        adapter (the export carries no adapter deltas), no session (its KV
        lives on one replica) and no handoff of its own."""
        if not isinstance(payload, dict):
            return False
        if payload.get("adapter") or payload.get("handoff"):
            return False
        if payload.get("session_id"):
            return False
        ids = payload.get("input_ids")
        if not ids or isinstance(ids[0], list):
            return False
        has_pre = has_dec = False
        for rep in self.replicas:
            s = rep.snapshot()
            if s["state"] != "ready" or s["admin_draining"]:
                continue
            role = s.get("role", "colocated")
            has_pre = has_pre or role == "prefill"
            has_dec = has_dec or role == "decode"
            if has_pre and has_dec:
                return True
        return False

    def _deadline_spent(self, tid):
        return self._error(504, "DeadlineExhausted",
                           "deadline spent during disagg failover", False,
                           trace_id=tid)

    def _dispatch_disagg(self, payload, deadline_t, trace, idem_key=None):
        """One request through the disaggregated pipeline:

            /reserve (decode)  -- hold the pages the stream will take
            /prefill (prefill) -- prefill, one token, the page export
            /generate (decode) -- import the handoff, decode the rest

        A request of one new token takes /prefill alone (no export, no
        reservation, no decode hop): the prefill worker's token is the
        whole answer.  Every hop failure before the decode response
        completes retries the whole pipeline on a fresh pair; once decode
        bytes have crossed, the colocated exactly-once rule holds."""
        from ..fault import injection as _inj

        tid, admit_sid = trace
        tried_pre, tried_dec = set(), set()
        attempt = 0
        while True:
            remaining = None if deadline_t is None else deadline_t - time.monotonic()
            if remaining is not None and remaining <= 0:
                _prof.record_router_event("deadline_sheds")
                return self._error(
                    504, "DeadlineExhausted",
                    "deadline spent before the disagg pipeline completed",
                    False, trace_id=tid)
            t_pick = time.perf_counter()
            try:
                pre, dec = self.pick_pair(tried_pre, tried_dec)
                if (pre is None or dec is None) and (tried_pre or tried_dec):
                    # every distinct pair member was tried; with budget left,
                    # a second pass (a respawn may be back)
                    tried_pre, tried_dec = set(), set()
                    pre, dec = self.pick_pair()
            except NoDecodeCapacity as e:
                _obs.record("disagg.pair", tid, t0=t_pick, t1=time.perf_counter(),
                            parent_id=admit_sid, attempt=attempt, status="error",
                            error="NoDecodeCapacity")
                return self._error(
                    e.status, "NoDecodeCapacity", str(e), e.retriable,
                    self._clamp_retry_after(self._jitter_retry_after(
                        e.retry_after_s if e.retry_after_s is not None
                        else self.healthiest_retry_after()), deadline_t),
                    trace_id=tid)
            _obs.record("disagg.pair", tid, t0=t_pick, t1=time.perf_counter(),
                        parent_id=admit_sid, attempt=attempt,
                        prefill=pre.rid if pre is not None else None,
                        decode=dec.rid if dec is not None else None,
                        status="ok" if pre is not None and dec is not None
                        else "error")
            if pre is None or dec is None:
                # one side of the fleet went away mid-request: the colocated
                # path still serves (any role answers /generate)
                _flight.record("disagg", "pair incomplete; colocated fallback",
                               trace_id=tid)
                return self._dispatch_colocated(payload, deadline_t, trace,
                                                idem_key=idem_key)
            _prof.record_disagg_event("pair_picks")
            if attempt > 0:
                _prof.record_router_event("retries")
                _prof.record_disagg_event("handoff_retries")
            n_new = int(payload.get("max_new_tokens") or 32)
            single = n_new <= 1
            reservation = None

            if not single:
                # hop 1: reserve decode-side pages before the prefill runs
                status, body, headers, retriable = self._send(
                    dec, {"prompt_len": len(payload["input_ids"]),
                          "max_new_tokens": n_new},
                    remaining, trace, attempt=attempt, path="/reserve",
                    span="disagg.reserve", partial_retriable=True)
                if status != 200:
                    _prof.record_disagg_event("reserve_fails")
                    tried_dec.add(dec.rid)
                    if not retriable or attempt >= self.max_retries:
                        return status, body, headers
                    attempt = self._disagg_backoff(attempt, deadline_t)
                    if attempt is None:
                        return self._deadline_spent(tid)
                    continue
                reservation = body.get("reservation")

            # hop 2: prefill and the page export on the prefill worker
            status, body, headers, retriable = self._send(
                pre, {"input_ids": payload["input_ids"],
                      "temperature": payload.get("temperature", 0.0),
                      "eos_token_id": payload.get("eos_token_id"),
                      "export": not single},
                remaining, trace, attempt=attempt, path="/prefill",
                span="disagg.prefill", partial_retriable=True)
            if status != 200:
                # no token crossed: a death mid-handoff is a retriable
                # failover; the reservation just made lapses at its TTL
                tried_pre.add(pre.rid)
                if not retriable or attempt >= self.max_retries:
                    return status, body, headers
                attempt = self._disagg_backoff(attempt, deadline_t)
                if attempt is None:
                    return self._deadline_spent(tid)
                continue
            if single:
                return 200, {"tokens": list(payload["input_ids"])
                             + [int(body["first_token"])]}, headers
            handoff = body.get("handoff")

            # the handoff crosses router memory
            t_hand = time.perf_counter()
            try:
                _inj.inject("disagg.handoff.drop", context=f"{pre.rid}->{dec.rid}")
            except _inj.InjectedFault as e:
                # the payload is lost in flight: neither replica failed, so
                # no breaker or tried bookkeeping; retry the whole pipeline
                _obs.record("disagg.handoff", tid, t0=t_hand,
                            t1=time.perf_counter(), parent_id=admit_sid,
                            attempt=attempt, status="error", error=f"{e}")
                _flight.record("disagg", f"handoff dropped: {e}", trace_id=tid)
                attempt = self._disagg_backoff(attempt, deadline_t)
                if attempt is None:
                    return self._deadline_spent(tid)
                continue
            if not isinstance(handoff, dict):
                tried_pre.add(pre.rid)
                if attempt >= self.max_retries:
                    return self._error(
                        502, "HandoffMissing", f"prefill worker {pre.rid} "
                        "answered without a handoff payload", False, trace_id=tid)
                attempt = self._disagg_backoff(attempt, deadline_t)
                if attempt is None:
                    return self._deadline_spent(tid)
                continue
            _obs.record("disagg.handoff", tid, t0=t_hand, t1=time.perf_counter(),
                        parent_id=admit_sid, attempt=attempt, status="ok",
                        payload_bytes=handoff.get("payload_bytes"),
                        prefill=pre.rid, decode=dec.rid)

            # hop 3: import and decode on the decode worker
            fwd = {k: v for k, v in payload.items()
                   if k not in ("handoff", "reservation")}
            fwd["handoff"] = handoff
            fwd["reservation"] = reservation
            remaining = None if deadline_t is None else deadline_t - time.monotonic()
            status, body, headers, retriable = self._send(
                dec, fwd, remaining, trace, attempt=attempt, idem_key=idem_key,
                span="disagg.decode")
            if status == 200:
                return 200, body, headers
            tried_dec.add(dec.rid)
            if not retriable or attempt >= self.max_retries:
                return status, body, headers
            attempt = self._disagg_backoff(attempt, deadline_t)
            if attempt is None:
                return self._deadline_spent(tid)

    def _disagg_backoff(self, attempt, deadline_t):
        """Sleep the jittered backoff (at most half the remaining budget)
        and return the next attempt, or None when the deadline is spent."""
        delay = self._backoff(attempt)
        if deadline_t is not None:
            remaining = deadline_t - time.monotonic()
            if remaining <= 0.01:
                _prof.record_router_event("deadline_sheds")
                return None
            delay = min(delay, remaining / 2)
        time.sleep(delay)
        return attempt + 1

    def _dispatch_colocated(self, payload, deadline_t, trace, idem_key=None):
        tid, admit_sid = trace
        tried = set()
        attempt = 0
        prev_rid = None
        while True:
            remaining = None if deadline_t is None else deadline_t - time.monotonic()
            if remaining is not None and remaining <= 0:
                _prof.record_router_event("deadline_sheds")
                return self._error(504, "DeadlineExhausted",
                                   "deadline spent before a replica answered",
                                   False, trace_id=tid)
            if remaining is not None:
                # shed over-deadline work first: when every ready replica's
                # backlog exceeds the remaining budget, queueing it anywhere
                # only takes capacity from feasible work
                drains = self._ready_drains()
                if drains and min(drains) > remaining:
                    _prof.record_router_event("brownout_sheds")
                    _flight.record("admission", "deadline-infeasible shed",
                                   trace_id=tid, best_drain_s=round(min(drains), 3),
                                   remaining_s=round(remaining, 3))
                    return self._error(
                        504, "DeadlineUnattainable",
                        f"no replica can meet the deadline (best drain "
                        f"estimate {min(drains):.2f}s > remaining "
                        f"{remaining:.2f}s)", False,
                        retry_after=self._jitter_retry_after(min(drains)),
                        trace_id=tid)
            t_pick = time.perf_counter()
            adapter = payload.get("adapter") if isinstance(payload, dict) else None
            sid = payload.get("session_id") if isinstance(payload, dict) else None
            rep = self._pinned_replica(sid, tried) if sid else None
            if rep is None:
                rep = self.pick(exclude=tried, adapter=adapter)
            if rep is None and tried:
                # every distinct replica was tried; with budget left, a
                # second pass (a restarted replica may be back)
                tried = set()
                rep = self.pick(adapter=adapter)
            _obs.record("router.pick", tid, t0=t_pick, t1=time.perf_counter(),
                        parent_id=admit_sid, attempt=attempt,
                        picked=rep.rid if rep is not None else None,
                        status="ok" if rep is not None else "error")
            if rep is None:
                _prof.record_router_event("no_replica")
                _flight.record("admission", "no ready replica", trace_id=tid)
                ra = self._clamp_retry_after(
                    self._jitter_retry_after(self.healthiest_retry_after()),
                    deadline_t)
                return self._error(
                    503, "NoReadyReplica",
                    "no ready replica (all down, draining, or breaker-open)",
                    True, ra, trace_id=tid)
            if attempt > 0:
                _prof.record_router_event("retries")
                if rep.rid != prev_rid:
                    _prof.record_router_event("failovers")
            status, body, headers, retriable = self._send_hedged(
                rep, payload, remaining, trace, attempt=attempt, idem_key=idem_key)
            if status == 200:
                if sid:
                    self._pin_session(sid, rep.rid)
                return 200, body, headers
            prev_rid = rep.rid
            tried.add(rep.rid)
            if not retriable or attempt >= self.max_retries:
                return status, body, headers
            delay = self._backoff(attempt)
            if remaining is not None:
                remaining = deadline_t - time.monotonic()
                if remaining <= 0.01:
                    _prof.record_router_event("deadline_sheds")
                    return self._error(504, "DeadlineExhausted",
                                       "deadline spent during failover", False,
                                       trace_id=tid)
                delay = min(delay, remaining / 2)
            time.sleep(delay)
            attempt += 1

    def _backoff(self, attempt):
        """Jittered exponential backoff: base * 2^attempt * U(0.5, 1.5)."""
        with self._mu:
            jitter = 0.5 + self._rng.random()
        return self.retry_backoff * (2 ** attempt) * jitter

    def _send(self, rep, payload, remaining_s, trace, attempt=0, idem_key=None,
              path="/generate", span="replica.forward", partial_retriable=False):
        """One dispatch attempt.  Returns (status, body, headers, retriable)
        and folds the outcome into the replica's breaker and latency.

        The forward span id is minted before the HTTP call so it rides
        ``X-Parent-Span``: the replica's ``serve.handle`` parents on it,
        and a dead attempt leaves an ``aborted`` span in the same trace as
        the retry.  `partial_retriable=True` marks a hop that carries no
        client-visible tokens (/reserve, /prefill): a connection that dies
        mid-response there is still a zero-token failover."""
        tid, admit_sid = trace
        fwd_sid = _obs.new_span_id()
        t_fwd = time.perf_counter()
        try:
            if path == "/generate":
                status, body, headers, latency = rep.post_generate(
                    payload, remaining_s, trace=(tid, fwd_sid), idem_key=idem_key)
            else:
                status, body, headers, latency = rep.post_json(
                    path, payload, remaining_s, trace=(tid, fwd_sid),
                    idem_key=idem_key)
        except ReplicaTransportError as e:
            _obs.record(span, tid, t0=t_fwd, t1=time.perf_counter(),
                        span_id=fwd_sid, parent_id=admit_sid, status="aborted",
                        replica=rep.rid, attempt=attempt, error=f"{e}")
            rep.record_failure(str(e))
            if e.response_started and not partial_retriable:
                # bytes reached us: a retry could deliver twice
                st, bd, hd = self._error(
                    502, "UpstreamIncomplete",
                    f"replica {rep.rid} died mid-response: {e}", False,
                    trace_id=tid)
                return st, bd, hd, False
            st, bd, hd = self._error(503, "ReplicaUnreachable",
                                     f"replica {rep.rid} unreachable: {e}", True,
                                     trace_id=tid)
            return st, bd, hd, True
        _obs.record(span, tid, t0=t_fwd, t1=time.perf_counter(), span_id=fwd_sid,
                    parent_id=admit_sid, status="ok" if status == 200 else "error",
                    replica=rep.rid, attempt=attempt, http_status=status)
        if status == 200:
            rep.record_success(latency)
            return status, body, headers, False
        # a typed upstream error: serve()'s JSON decides the retry
        body = body if isinstance(body, dict) else {}
        retriable = bool(body.get("retriable", status == 503))
        err_type = body.get("type", "")
        if err_type in ("EngineRestarted", "NonFiniteLogits") or (
                status >= 500 and not body):
            # sick-replica signals feed the breaker; plain overload
            # (QueueFull, Draining) does not: a busy replica is healthy
            rep.record_failure(err_type or f"http {status}")
        else:
            rep.record_success(latency)
        return status, body, headers, retriable

    def _send_hedged(self, rep, payload, remaining_s, trace, attempt=0,
                     idem_key=None):
        """Dispatch with optional hedging: when the primary has not answered
        after `hedge_s`, the (zero-token, pure) request is duplicated onto a
        second replica; the first complete response wins."""
        if self.hedge_s <= 0:
            return self._send(rep, payload, remaining_s, trace, attempt=attempt,
                              idem_key=idem_key)
        results = []
        results_mu = threading.Lock()
        first_done = threading.Event()

        def _run(r):
            out = self._send(r, payload, remaining_s, trace, attempt=attempt,
                             idem_key=idem_key)
            with results_mu:
                results.append((out, r))
            first_done.set()

        t1 = threading.Thread(target=_run, args=(rep,), daemon=True)
        t1.start()
        if not first_done.wait(self.hedge_s):
            alt = self.pick(exclude={rep.rid}, adapter=payload.get("adapter")
                            if isinstance(payload, dict) else None)
            if alt is not None:
                _prof.record_router_event("hedges")
                t2 = threading.Thread(target=_run, args=(alt,), daemon=True)
                t2.start()
        first_done.wait()
        with results_mu:
            out, winner = results[0]
        if winner is not rep and out[0] == 200:
            _prof.record_router_event("hedge_wins")
        return out

    # -- rolling drain/restart ----------------------------------------------

    def rolling_restart(self, grace=None, ready_timeout=60.0, restart_fn=None):
        """Upgrade the fleet with no request dropped, one replica at a time:
        admin-drain -> wait for in-flight work up to `grace` -> restart (the
        launch Container's SIGTERM -> grace -> SIGKILL -> respawn, or
        `restart_fn(replica, grace)`) -> readmit once /healthz reads ready.
        Returns a report per replica."""
        if grace is None:
            grace = float(_core.flag("FLAGS_serve_drain_grace"))
        return [self._restart_one(rep, grace, ready_timeout, restart_fn)
                for rep in self.replicas]

    def _restart_one(self, rep, grace, ready_timeout, restart_fn=None):
        rep.set_admin_draining(True)
        _prof.record_router_replica_state(rep.rid, "draining")
        drained = False
        try:
            deadline = time.monotonic() + grace
            while time.monotonic() < deadline:
                h = rep.probe(timeout=self.probe_timeout)
                if h is None or (not h.get("active_slots")
                                 and not h.get("queue_depth")):
                    drained = True
                    break
                time.sleep(0.05)
            fn = restart_fn
            if fn is None and rep.process is not None:
                fn = lambda r, g: r.process.restart(g)  # noqa: E731
            if fn is not None:
                _prof.record_router_replica_state(rep.rid, "restarting")
                fn(rep, grace)
            ready = False
            deadline = time.monotonic() + ready_timeout
            while time.monotonic() < deadline:
                h = rep.probe(timeout=self.probe_timeout)
                if h is not None and h.get("status") in ("ready", "live"):
                    ready = True
                    break
                time.sleep(0.05)
            return {"replica": rep.rid, "drained": drained,
                    "restarted": fn is not None, "ready": ready}
        finally:
            rep.set_admin_draining(False)
            _prof.record_router_replica_state(rep.rid, rep.state)

    # -- helpers -------------------------------------------------------------

    def _jitter_retry_after(self, ra):
        """±FLAGS_router_retry_after_jitter on a shed's Retry-After: a
        takeover or a brownout sheds many clients at once, and equal waits
        would bring them back together.  The float rides the body's
        `retry_after_s`; the header floors at 1 s."""
        if ra is None or self._retry_after_jitter <= 0:
            return ra
        with self._mu:
            u = self._rng.random()
        return max(0.0, ra * (1.0 + self._retry_after_jitter * (2.0 * u - 1.0)))

    @staticmethod
    def _clamp_retry_after(ra, deadline_t):
        """Never tell a client to retry after its own deadline."""
        if deadline_t is not None:
            ra = min(ra, max(0.0, deadline_t - time.monotonic()))
        return ra

    @staticmethod
    def _error(status, err_type, msg, retriable, retry_after=None, trace_id=None):
        headers = {}
        # `is not None`: a clamped retry_after of 0.0 still emits the header
        # (rounded up to the 1 s floor HTTP clients expect)
        if retry_after is not None:
            headers["Retry-After"] = str(max(1, int(retry_after + 0.5)))
        if trace_id:
            headers[_obs.HDR_TRACE] = trace_id
        return status, {"error": msg, "type": err_type,
                        "retriable": bool(retriable),
                        "retry_after_s": retry_after or 0,
                        "trace_id": trace_id}, headers


class RouterStandby:
    """A warm standby of the front door: WATCHING (the primary's rank-0
    heartbeat seq advances) -> the seq stands still for
    `FLAGS_router_takeover_timeout` on the standby's own clock ->
    TAKING_OVER (replay the journal, repairing a torn final segment,
    rebuild the replica handles from the journaled registry, restore
    breakers, drains and idempotent responses, probe the fleet) -> SERVING
    (the successor Router answers and beats the same heartbeat slot).

    `primary_alive()` may be polled beside the `watch()` thread: every
    mutable field lives under `self._mu`."""

    def __init__(self, journal_root, heartbeat_root, replicas=(), *,
                 timeout=None, poll_interval=0.05, make_router=None,
                 router_kwargs=None):
        self.journal_root = str(journal_root)
        self.heartbeat_root = str(heartbeat_root)
        self.timeout = float(timeout if timeout is not None
                             else _core.flag("FLAGS_router_takeover_timeout"))
        self.poll_interval = float(poll_interval)
        self.replicas = list(replicas)
        self.router_kwargs = dict(router_kwargs or {})
        self._make_router = make_router
        self._mu = threading.Lock()
        self._last_seq = None
        self._last_advance = None
        self._router = None
        self._watch_thread = None
        self._stop = threading.Event()

    @property
    def router(self):
        """The successor Router once the takeover happened, else None."""
        with self._mu:
            return self._router

    def primary_alive(self, now=None):
        """True while the primary's heartbeat seq keeps advancing, judged on
        this process's monotonic clock.  The first observation arms the
        timer: a standby started beside a dead primary still waits one full
        timeout."""
        from ..fault import heartbeat as _hb

        now = time.monotonic() if now is None else now
        hb = _hb.scan_heartbeats(self.heartbeat_root).get(0)
        seq = hb.get("seq") if isinstance(hb, dict) else None
        with self._mu:
            if self._last_advance is None:
                self._last_advance = now
                self._last_seq = seq
                return True
            if seq is not None and seq != self._last_seq:
                self._last_seq = seq
                self._last_advance = now
                return True
            return (now - self._last_advance) < self.timeout

    def wait_for_death(self, timeout=60.0):
        """Poll until the primary is declared dead; False on timeout or
        stop()."""
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            if not self.primary_alive():
                return True
            if self._stop.wait(self.poll_interval):
                return False
        return False

    def takeover(self):
        """Become the front door: open the journal (replay and torn-tail
        repair happen in `Journal`), build the successor Router (its
        constructor rehydrates the registry, breakers and idempotent
        responses) and probe the fleet before any traffic.  Returns it."""
        journal = Journal(self.journal_root)
        if self._make_router is not None:
            router = self._make_router(journal)
        else:
            router = Router(list(self.replicas), journal=journal,
                            heartbeat=self.heartbeat_root, **self.router_kwargs)
        router.start()
        with self._mu:
            self._router = router
        return router

    def watch(self, on_takeover=None):
        """Background supervision: poll the primary's heartbeat; on its
        death take over and hand the successor to `on_takeover(router)`."""
        with self._mu:
            if self._watch_thread is not None:
                return self

        def _run():
            while not self._stop.is_set():
                if not self.primary_alive():
                    router = self.takeover()
                    if on_takeover is not None:
                        on_takeover(router)
                    return
                if self._stop.wait(self.poll_interval):
                    return

        t = threading.Thread(target=_run, name="router-standby", daemon=True)
        with self._mu:
            self._watch_thread = t
        t.start()
        return self

    def stop(self):
        self._stop.set()
        with self._mu:
            t = self._watch_thread
        if t is not None:
            t.join(5)


def serve_router(replicas, port=8900, host="127.0.0.1", block=True, probe=True):
    """The HTTP front door over a Router (the shape of inference.serve()):

    - GET  /health     -> 200
    - GET  /healthz    -> the fleet snapshot (200 with a ready replica)
    - GET  /metrics    -> Prometheus text, labelled {role="router"}
    - GET  /trace/<id> -> the router-side span tree of one trace
    - POST /generate   -> routed with failover and deadline propagation; the
      client's deadline comes as `X-Deadline-Ms` (or body `deadline_s`) and
      every upstream hop gets the remaining budget.  The trace context
      (`X-Trace-Id` / `X-Parent-Span`) is joined or minted and forwarded;
      `X-Idempotency-Key` engages the dedupe.  When the router has crashed
      the connection closes with no response byte.

    Returns the ThreadingHTTPServer with `.router`; with `block=False` it
    serves on a daemon thread and `server.stop_router()` stops both.
    """
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    router = replicas if isinstance(replicas, Router) else Router(replicas)
    if probe:
        router.start()

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
            elif self.path == "/healthz":
                h = router.healthz()
                self._reply(200 if h["status"] == "ready" else 503, h)
            elif self.path == "/metrics":
                # the bound address, not the port argument (0: ephemeral)
                bh, bp = self.server.server_address[:2]
                body = _obs_metrics.render(
                    labels={"replica": f"{bh}:{bp}", "role": "router"}).encode()
                self.send_response(200)
                self.send_header("Content-Type", _obs_metrics.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/trace/"):
                tid = self.path[len("/trace/"):]
                roots = _obs.tree(tid)
                if roots:
                    self._reply(200, {"trace_id": tid, "spans": roots})
                else:
                    self._reply(404, {"error": f"no spans buffered for trace {tid!r}"})
            else:
                self._reply(404, {"error": "use POST /generate"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "use POST /generate"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
            except Exception as e:
                self._reply(400, {"error": f"{type(e).__name__}: {e}"})
                return
            hdr = self.headers.get("X-Deadline-Ms")
            deadline_ms = float(hdr) if hdr is not None else None
            if deadline_ms is None and payload.get("deadline_s") is not None:
                deadline_ms = float(payload["deadline_s"]) * 1e3
            # the router owns the deadline now: replicas see the remaining
            # budget through X-Deadline-Ms only
            payload.pop("deadline_s", None)
            try:
                status, body, headers = router.handle_generate(
                    payload, deadline_ms=deadline_ms,
                    idem_key=self.headers.get("X-Idempotency-Key"),
                    trace=_obs.ctx_from_headers(self.headers))
            except RouterCrashed:
                # the front door is dead: drop the connection with no
                # response byte (the client resubmits to the successor)
                self.close_connection = True
                return
            self._reply(status, body, headers={
                k: v for k, v in headers.items()
                if k.lower() in ("retry-after", "x-trace-id", "x-idempotency-replay")})

    server = ThreadingHTTPServer((host, port), Handler)
    server.router = router

    def _shutdown():
        router.stop()
        server.shutdown()

    server.stop_router = _shutdown
    if block:
        try:
            server.serve_forever()
        finally:
            router.stop()
        return server
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server
