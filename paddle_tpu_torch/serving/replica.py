"""The router's replica handle and its managed worker process (counterpart
of `paddle_tpu/serving/replica.py`).

A `Replica` is the router's view of one `serve()` instance: its
probe-driven lifecycle state (ready, draining, dead, down), the load
signals `/healthz` exports (queue depth, drain estimate, free page
fraction, EWMA decode step time, role, reserved pages, sessions, resident
adapters), a circuit breaker (closed -> open after consecutive failures
-> one half-open trial -> closed) and the transport that dispatches
`/generate`, `/reserve` and `/prefill` with the remaining deadline budget
in `X-Deadline-Ms`.

A `ReplicaProcess` is a router-managed replica: this module run as a
script through the launch `Container` (`workerlog.N` capture, the env
contract), which gives the router `kill9()` for chaos drills and
`restart(grace)` for rolling upgrades.  `python paddle_tpu_torch/serving/
replica.py --port N` starts one worker: a tiny Llama built from a fixed
seed behind a warmed engine and `serve()`.  Every worker with the same
seed holds the same weights, so greedy outputs are the same whichever
replica answers (what failover relies on).  The worker runs on the CUDA
card; `--device cpu` asks for the CPU.  `--tp N` serves the model's
tensor-parallel build over N ranks on the devices `--devices` names (one
per rank; default the visible CUDA devices, each once).
"""

# PEP 366 bootstrap: the launch Container execs this file as a plain script
# (`python -u .../replica.py`), where relative imports have no package; put
# the repository root on sys.path and claim the package first
import os
import sys

if __package__ in (None, ""):  # pragma: no cover - subprocess entry only
    sys.path.insert(
        0,
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    )
    import paddle_tpu_torch.serving  # noqa: F401  (run the package __init__)

    __package__ = "paddle_tpu_torch.serving"

import json
import threading
import time
import urllib.error
import urllib.request

from .. import profiler as _prof
from ..framework import core as _core
from ..obs import flight as _flight
from ..obs import trace as _obs


class ReplicaTransportError(RuntimeError):
    """A transport failure talking to a replica: connect refused, reset,
    timeout.  `response_started` says whether any response bytes arrived
    first: the router retries only when none did, so delivery stays
    exactly once across a failover."""

    def __init__(self, msg, response_started=False):
        super().__init__(msg)
        self.response_started = bool(response_started)


class Replica:
    """The router's handle of one serve() endpoint.

    States (probe-driven): connecting -> ready -> draining -> dead, and
    down (a failed probe) -> ready (a probe that recovered); besides, the
    router's own `admin_draining` bit for rolling restarts and scale-downs
    (the replica keeps serving, the router stops picking it).  The probe
    thread, handler threads and the orchestrators all touch this object:
    every mutable field lives under `self._mu`."""

    def __init__(self, rid, base_url, process=None,
                 breaker_threshold=None, breaker_cooldown=None):
        self.rid = str(rid)
        self.base_url = base_url.rstrip("/")
        self.process = process  # ReplicaProcess, or None (an external one)
        self.breaker_threshold = int(
            breaker_threshold if breaker_threshold is not None
            else _core.flag("FLAGS_router_breaker_threshold"))
        self.breaker_cooldown = float(
            breaker_cooldown if breaker_cooldown is not None
            else _core.flag("FLAGS_router_breaker_cooldown"))
        self._mu = threading.Lock()
        self._state = "connecting"
        self._admin_draining = False
        self._breaker = "closed"
        self._fails = 0  # consecutive failures toward the breaker threshold
        self._open_until = 0.0
        self._trial_inflight = False  # the single half-open trial
        self._ewma_latency_s = None
        self._queue_depth = 0
        self._active_slots = 0
        self._drain_estimate_s = 0.0
        self._page_free_frac = 1.0
        self._decode_ewma_ms = 0.0
        self._tokens_per_step = 1.0
        self._deadline_miss_rate = 0.0
        self._lora_adapters = ()  # resident adapter names from /healthz
        self._role = "colocated"
        self._reserved_pages = 0
        self._cp = 1
        self._sessions_resident = 0
        self._probes_ok = 0
        self._probes_failed = 0
        # breaker transitions are journaled so a successor router does not
        # close onto a sick replica; open_until is kept in wall time too,
        # because a monotonic clock does not survive the process
        self._journal = None
        self._open_until_wall = 0.0

    # -- snapshots -----------------------------------------------------------

    @property
    def state(self):
        with self._mu:
            return self._state

    @property
    def breaker(self):
        with self._mu:
            return self._breaker

    def snapshot(self):
        """A copy of the routing state under one lock hold (the router
        scores candidates on this, never on live fields)."""
        with self._mu:
            return {
                "id": self.rid,
                "url": self.base_url,
                "state": self._state,
                "admin_draining": self._admin_draining,
                "breaker": self._breaker,
                "consecutive_fails": self._fails,
                "ewma_latency_s": self._ewma_latency_s or 0.0,
                "queue_depth": self._queue_depth,
                "active_slots": self._active_slots,
                "drain_estimate_s": self._drain_estimate_s,
                "page_free_frac": self._page_free_frac,
                "decode_ewma_ms": self._decode_ewma_ms,
                "tokens_per_step": self._tokens_per_step,
                "deadline_miss_rate": self._deadline_miss_rate,
                "lora_adapters": self._lora_adapters,
                "role": self._role,
                "reserved_pages": self._reserved_pages,
                "cp": self._cp,
                "sessions_resident": self._sessions_resident,
                "probes_ok": self._probes_ok,
                "probes_failed": self._probes_failed,
            }

    def set_admin_draining(self, flag):
        with self._mu:
            self._admin_draining = bool(flag)
            journal = self._journal
        if journal is not None:
            journal.append("replica", op="drain", rid=self.rid,
                           draining=bool(flag))

    # -- the durable control plane ------------------------------------------

    def bind_journal(self, journal):
        """Attach the control-plane journal: breaker transitions and drain
        decisions append to it from now on (outside `_mu`: the journal has
        its own lock)."""
        with self._mu:
            self._journal = journal

    def restore_breaker(self, state, fails, open_until_wall, now=None):
        """Rehydrate the breaker from a journal replay: the remaining
        cooldown of the journaled wall-clock open-until goes onto this
        process's monotonic clock (an expired one restores as open with an
        immediate half-open trial)."""
        now = time.time() if now is None else now
        remaining = max(0.0, float(open_until_wall) - now)
        with self._mu:
            if state == "open":
                self._breaker = "open"
                self._open_until = time.monotonic() + remaining
                self._open_until_wall = float(open_until_wall)
            else:
                self._breaker = "closed"
                self._open_until = 0.0
                self._open_until_wall = 0.0
            self._fails = int(fails)
            self._trial_inflight = False

    def _journal_breaker(self, journal, state, fails, open_until_wall):
        if journal is not None:
            journal.append("breaker", rid=self.rid, state=state,
                           fails=int(fails), open_until_wall=float(open_until_wall))

    # -- circuit breaker -----------------------------------------------------

    def allow(self, now=None):
        """The breaker's gate at dispatch: closed admits; open admits only
        after the cooldown, turning half-open; half-open admits one trial at
        a time (its outcome comes back through record_success or
        record_failure)."""
        now = time.monotonic() if now is None else now
        half_opened = False
        with self._mu:
            if self._breaker == "closed":
                ok = True
            elif self._breaker == "open":
                if now >= self._open_until:
                    self._breaker = "half_open"
                    self._trial_inflight = True
                    half_opened = True
                    ok = True
                else:
                    ok = False
            elif self._trial_inflight:
                ok = False
            else:  # half open, no trial in flight
                self._trial_inflight = True
                ok = True
        if half_opened:
            _prof.record_router_event("breaker_half_open")
            _flight.record("breaker", f"{self.rid} open -> half_open (trial)")
        return ok

    def record_success(self, latency_s=None):
        """A dispatch completed (any well-formed response, a 200 or a typed
        error: the replica is alive and talking)."""
        closed = False
        with self._mu:
            self._fails = 0
            self._trial_inflight = False
            if self._breaker != "closed":
                self._breaker = "closed"
                self._open_until_wall = 0.0
                closed = True
            if latency_s is not None:
                self._ewma_latency_s = (
                    latency_s if self._ewma_latency_s is None
                    else 0.8 * self._ewma_latency_s + 0.2 * latency_s)
            journal = self._journal
        if closed:
            _prof.record_router_event("breaker_closes")
            _flight.record("breaker", f"{self.rid} -> closed")
            self._journal_breaker(journal, "closed", 0, 0.0)

    def record_failure(self, reason=""):
        """A sick-replica signal (a transport failure, a failed probe, an
        engine restarted or dead): consecutive failures open the breaker; a
        failed half-open trial opens it for another cooldown."""
        tripped = False
        now = time.monotonic()
        with self._mu:
            self._fails += 1
            fails = self._fails
            self._trial_inflight = False
            if self._breaker == "half_open" or (
                    self._breaker == "closed"
                    and self._fails >= self.breaker_threshold):
                self._breaker = "open"
                self._open_until = now + self.breaker_cooldown
                self._open_until_wall = time.time() + self.breaker_cooldown
                tripped = True
            open_until_wall = self._open_until_wall
            journal = self._journal
        if tripped:
            _prof.record_router_event("breaker_trips")
            _flight.record("breaker", f"{self.rid} -> open: {reason}",
                           fails=fails, cooldown_s=self.breaker_cooldown)
            self._journal_breaker(journal, "open", fails, open_until_wall)

    # -- probing -------------------------------------------------------------

    def probe(self, timeout=None):
        """One /healthz probe: refresh the state and the load gauges.
        Returns the healthz dict (a 503 body too: draining and dead replicas
        still answer), or None on a transport failure (state down, a breaker
        failure)."""
        if timeout is None:
            timeout = float(_core.flag("FLAGS_router_probe_timeout"))
        try:
            with urllib.request.urlopen(self.base_url + "/healthz",
                                        timeout=timeout) as resp:
                h = json.loads(resp.read())
        except urllib.error.HTTPError as e:
            try:
                h = json.loads(e.read())
            except Exception:
                h = None
        except Exception:
            h = None
        if not isinstance(h, dict) or "status" not in h:
            with self._mu:
                self._state = "down"
                self._probes_failed += 1
            self.record_failure("probe failed")
            return None
        self._note_healthz(h)
        return h

    def _note_healthz(self, h):
        """Fold one healthz payload into the handle."""
        status = h.get("status")
        state = {"ready": "ready", "live": "ready", "draining": "draining",
                 "dead": "dead"}.get(status, "down")
        with self._mu:
            self._state = state
            self._probes_ok += 1
            self._queue_depth = int(h.get("queue_depth", 0))
            self._active_slots = int(h.get("active_slots", 0))
            self._drain_estimate_s = float(h.get("drain_estimate_s", 0.0))
            self._page_free_frac = float(h.get("page_free_frac", 1.0))
            self._decode_ewma_ms = float(h.get("decode_ewma_ms", 0.0))
            self._tokens_per_step = float(h.get("tokens_per_step", 1.0))
            self._deadline_miss_rate = float(h.get("deadline_miss_rate", 0.0))
            self._role = str(h.get("role", "colocated"))
            self._reserved_pages = int(h.get("reserved_pages", 0))
            self._cp = int(h.get("cp", 1))
            sess = h.get("sessions")
            self._sessions_resident = (int(sess.get("sessions_resident", 0))
                                       if isinstance(sess, dict) else 0)
            lora = h.get("lora")
            if isinstance(lora, dict):
                self._lora_adapters = tuple(lora.get("adapters", ()))
        if state == "ready":
            self.record_success()
        elif state == "dead":
            self.record_failure("replica dead")

    def note_probe_failure(self, reason="injected"):
        """The probe-failure path without the HTTP round trip (the
        router.replica.flap fault point lands here)."""
        with self._mu:
            self._state = "down"
            self._probes_failed += 1
        self.record_failure(reason)

    # -- transport -----------------------------------------------------------

    def post_generate(self, payload, remaining_s=None, timeout=None,
                      trace=None, idem_key=None):
        """One /generate dispatch, forwarding the remaining deadline budget
        as X-Deadline-Ms and the trace context as X-Trace-Id /
        X-Parent-Span (`trace` is the router's `(trace_id, span_id)`).
        Returns (status, body, headers, latency_s) for any complete HTTP
        response (the router decides on a typed error's `retriable`);
        raises ReplicaTransportError when the connection dies."""
        return self.post_json("/generate", payload, remaining_s=remaining_s,
                              timeout=timeout, trace=trace, idem_key=idem_key)

    def post_json(self, path, payload, remaining_s=None, timeout=None,
                  trace=None, idem_key=None):
        """One POST to `path` with post_generate's contract (the
        disaggregated pipeline's /reserve and /prefill hops ride it)."""
        from ..fault import injection as _inj

        # an armed router.replica.hang stands in for a wedged connection:
        # the dispatch blocks, bounded by the HTTP timeout below
        _inj.inject_hang("router.replica.hang", context=self.rid)
        data = json.dumps(payload).encode()
        req = urllib.request.Request(self.base_url + path, data=data,
                                     headers={"Content-Type": "application/json"})
        if remaining_s is not None:
            req.add_header("X-Deadline-Ms", str(int(remaining_s * 1e3)))
        if idem_key:
            # the replica replays its kept response when a router retry (or a
            # successor router) resubmits a completed key: one generation
            req.add_header("X-Idempotency-Key", str(idem_key))
        if trace is not None:
            req.add_header(_obs.HDR_TRACE, trace[0])
            if trace[1]:
                req.add_header(_obs.HDR_PARENT, trace[1])
        if timeout is None:
            timeout = (remaining_s + 5.0) if remaining_s is not None else 600.0
        t0 = time.monotonic()
        started = False
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                started = True
                raw = resp.read()
                status, headers = resp.status, dict(resp.headers)
        except urllib.error.HTTPError as e:
            # a complete (typed) error response, not a transport failure
            raw = e.read()
            status, headers = e.code, dict(e.headers)
        except Exception as e:
            raise ReplicaTransportError(f"{type(e).__name__}: {e}",
                                        response_started=started) from None
        try:
            body = json.loads(raw) if raw else {}
        except ValueError:
            body = {}
        return status, body, headers, time.monotonic() - t0


class ReplicaProcess:
    """A router-managed replica worker: this module run as a script through
    the launch `Container`.  `kill9()` for the chaos drill, `restart(grace)`
    (SIGTERM -> drain grace -> SIGKILL -> respawn) for rolling upgrades,
    `terminate()` to end it; each reaps the process."""

    def __init__(self, index, port, log_dir, host="127.0.0.1", extra_args=()):
        from ..distributed.launch.main import Container

        self.port = int(port)
        self.host = host
        # rank index + 1 keeps the worker's output in a workerlog file (the
        # Container lets rank 0 write to the parent's console)
        self.container = Container(
            rank=int(index) + 1,
            world_size=1,
            endpoints=[],
            script=os.path.abspath(__file__),
            script_args=["--port", str(port), "--host", host, *extra_args],
            log_dir=log_dir,
        )

    @property
    def url(self):
        return f"http://{self.host}:{self.port}"

    def start(self):
        self.container.start()
        return self

    def alive(self):
        return self.container.proc is not None and self.container.poll() is None

    def kill9(self):
        self.container.kill9()

    def restart(self, grace=10.0):
        return self.container.restart(grace)

    def terminate(self):
        self.container.terminate()


def main(argv=None):
    """The replica worker: a tiny Llama from a fixed seed -> a warmed
    continuous-batching engine -> serve() with its SIGTERM drain."""
    import argparse

    p = argparse.ArgumentParser(prog="paddle_tpu_torch.serving.replica")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--max-len", type=int, default=64)
    p.add_argument("--buckets", default="8,16")
    p.add_argument("--queue-depth", type=int, default=32)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument(
        "--lora", default="",
        help="comma list of adapter specs name[:rank] to register and serve "
             "(a paged engine; weights are seeded by list position, so the "
             "same --lora string means the same adapters on every worker)")
    p.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel degree: the model's heads, its KV arena and the "
             "paged decode kernel split over N ranks (heads and kv_heads must "
             "divide by N; greedy outputs stay those of --tp 1)")
    p.add_argument(
        "--devices", default=None,
        help="comma list of the tp ranks' devices, one per rank (a device "
             "named several times holds several ranks; default: the visible "
             "CUDA devices, each once)")
    p.add_argument(
        "--role", default="colocated", choices=("colocated", "prefill", "decode"),
        help="disaggregated serving role: 'prefill' workers answer /prefill "
             "with exported pages, 'decode' workers import them through "
             "/generate handoffs (both a paged engine)")
    p.add_argument(
        "--kv-quant", default="none", choices=("none", "int8"),
        help="KV-cache storage precision (a paged engine): 'int8' pages with "
             "per-row float32 scales")
    p.add_argument(
        "--device", default=None,
        help="the device the worker serves on (default: the CUDA card; "
             "'cpu' runs the plain PyTorch versions of the kernels)")
    args = p.parse_args(argv)

    from ..framework.core import resolve_device
    from ..inference import serve
    from ..inference.engine import ContinuousBatchingEngine
    from ..models.llama import LlamaConfig, LlamaForCausalLM

    device = resolve_device(args.device)  # raises with no card unless "cpu"
    # the same seed on every worker: the same weights, so greedy outputs
    # are the same whichever replica serves (the failover contract)
    model = LlamaForCausalLM(LlamaConfig.tiny(tensor_parallel_degree=args.tp),
                             device=device, seed=args.seed)
    extra = {}
    if args.tp > 1:
        extra["tp"] = args.tp
        if args.devices:
            extra["devices"] = args.devices.split(",")
    if args.lora:
        # the same --lora string on every worker: the same registration
        # order and seeds, so the same adapter weights fleet-wide
        from ..lora import AdapterArena, AdapterRegistry, make_random

        reg = AdapterRegistry(model.config)
        for i, spec in enumerate(args.lora.split(",")):
            name, _, rank = spec.partition(":")
            make_random(reg, name, rank=int(rank) if rank else 4, seed=i + 1)
        extra.update(paged=True, page_size=8, lora=AdapterArena(reg, device=device))
    if args.kv_quant != "none":
        extra.update(paged=True, kv_quant=args.kv_quant)
        extra.setdefault("page_size", 8)
    if args.role != "colocated":
        # the wire format is the page arenas' rows: both ends are paged
        extra.update(paged=True, role=args.role)
        extra.setdefault("page_size", 8)
    eng = ContinuousBatchingEngine(
        model,
        slots=args.slots,
        max_len=args.max_len,
        prefill_buckets=[int(b) for b in args.buckets.split(",")],
        queue_depth=args.queue_depth,
        seed=0,
        device=device,
        **extra,
    )
    eng.warmup()
    serve(eng, port=args.port, host=args.host, block=True, handle_signals=True)
    return 0


if __name__ == "__main__":  # pragma: no cover - subprocess entry only
    sys.exit(main())
