"""The soak workload (counterpart of `paddle_tpu/serving/workload.py`):
traffic that falsifies.

A `Workload` describes a non-homogeneous Poisson arrival process (a
diurnal modulation times a step function of burst multipliers on a base
rate) mixed with adversarial requests (spent deadlines, unknown adapters,
prompts past the context, each with the typed outcome it must provoke).
`run_soak` drives it through a live `Router` with a bounded worker pool
while arming chaos faults on a schedule through the `FLAGS_fault_inject`
registry.

Determinism: arrivals, lengths and the adversarial mix are drawn from one
seeded numpy `RandomState` by thinning (draw at the peak rate, accept with
probability rate(t) / peak), the reference's draws in its order, so one
seed gives the same request list in both packages.

Scale: arrivals are generated lazily and results fold into counters and a
bounded latency reservoir, so memory does not grow with the request
count.  The exactly-once audit is client-side: every offered request must
come back with exactly one terminal status (`SoakReport.exactly_once`).
Plain Python and numpy: nothing here touches the card.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

_LATENCY_RESERVOIR = 65536  # sampled latencies kept for percentiles

# adversarial kinds and the HTTP statuses that count as "the typed outcome
# we provoked" (anything else is an unexpected_outcome in the report)
_EXPECTED = {
    "ok": (200,),
    # budget spent before admission -> 504 family (router sheds or the
    # replica rejects; under brownout a 503 shed is also within contract)
    "over_deadline": (504, 503),
    # unregistered adapter -> terminal typed 4xx, never retried: 404
    # AdapterUnknown on a LoRA fleet, typed 400 on a fleet with no arena
    "unknown_adapter": (404, 400),
    # prompt >= engine max_len -> typed 400 (ValueError at submit); the
    # router does not retry non-retriable 4xx
    "over_bucket": (400,),
}


class Workload:
    """Declarative soak traffic.  All knobs are data so a soak config can
    be printed into a bench record or a flight dump verbatim.

    rate_hz          base Poisson arrival rate
    duration_s       soak length (arrival clock, not wall-bounded)
    diurnal_period_s sinusoidal modulation period (0 = flat)
    diurnal_amp      modulation amplitude in [0, 1): rate x (1 + a*sin)
    steps            ((t_s, multiplier), ...) step function on the base
                     rate; the LATEST step at or before t applies — this
                     is the "traffic step-function" the acceptance soak
                     drives (e.g. ((0, 1), (120, 4), (300, 1)))
    prompt_len       (lo, hi) inclusive bounds for normal prompts
    max_new_tokens   per-request generation budget
    deadline_s       per-request deadline for NORMAL traffic (None = none)
    frac_*           adversarial mix fractions (summing under 1.0)
    over_bucket_len  prompt length for the over-bucket kind (default
                     max_len_hint + 8, i.e. reliably past the engine cap)
    adapters         known adapter names cycled onto normal traffic
    requests         optional hard cap on offered requests (None = until
                     duration_s of arrival time)
    """

    def __init__(self, *, rate_hz=20.0, duration_s=10.0, seed=0,
                 diurnal_period_s=0.0, diurnal_amp=0.0, steps=(),
                 prompt_len=(4, 12), max_new_tokens=4, deadline_s=None,
                 temperature=0.0, frac_over_deadline=0.0,
                 frac_unknown_adapter=0.0, frac_over_bucket=0.0,
                 over_bucket_len=None, max_len_hint=64, adapters=(),
                 vocab=256, requests=None):
        if not 0.0 <= diurnal_amp < 1.0:
            raise ValueError("diurnal_amp must be in [0, 1)")
        fr = frac_over_deadline + frac_unknown_adapter + frac_over_bucket
        if fr >= 1.0:
            raise ValueError("adversarial fractions must sum under 1.0")
        self.rate_hz = float(rate_hz)
        self.duration_s = float(duration_s)
        self.seed = int(seed)
        self.diurnal_period_s = float(diurnal_period_s)
        self.diurnal_amp = float(diurnal_amp)
        self.steps = tuple((float(t), float(m)) for t, m in steps)
        if any(m <= 0 for _, m in self.steps):
            raise ValueError("step multipliers must be > 0")
        self.prompt_len = (int(prompt_len[0]), int(prompt_len[1]))
        self.max_new_tokens = int(max_new_tokens)
        self.deadline_s = deadline_s
        self.temperature = float(temperature)
        self.frac_over_deadline = float(frac_over_deadline)
        self.frac_unknown_adapter = float(frac_unknown_adapter)
        self.frac_over_bucket = float(frac_over_bucket)
        self.over_bucket_len = int(
            over_bucket_len if over_bucket_len is not None
            else max_len_hint + 8
        )
        self.adapters = tuple(adapters)
        self.vocab = int(vocab)
        self.requests = None if requests is None else int(requests)

    # -- the rate function ---------------------------------------------------

    def rate_at(self, t):
        """Instantaneous arrival rate at soak time t (Hz)."""
        r = self.rate_hz
        if self.diurnal_period_s > 0 and self.diurnal_amp > 0:
            r *= 1.0 + self.diurnal_amp * math.sin(
                2.0 * math.pi * t / self.diurnal_period_s
            )
        r *= self._step_mult(t)
        return max(0.0, r)

    def _step_mult(self, t):
        m = 1.0
        for ts, mult in self.steps:
            if t >= ts:
                m = mult
        return m

    def peak_rate(self):
        peak_step = max((m for _, m in self.steps), default=1.0)
        return self.rate_hz * (1.0 + self.diurnal_amp) * max(1.0, peak_step)

    # -- arrivals ------------------------------------------------------------

    def arrivals(self):
        """Lazy deterministic arrival stream: yields (t, kind, request)
        with t strictly increasing.  `request` is {"payload", "deadline_ms"}
        ready for `Router.handle_generate`.  Thinning keeps the draw count
        proportional to the PEAK rate while matching rate_at(t) exactly in
        distribution."""
        rng = np.random.RandomState(self.seed)
        peak = self.peak_rate()
        if peak <= 0:
            return
        t = 0.0
        n = 0
        while True:
            t += float(rng.exponential(1.0 / peak))
            if t >= self.duration_s:
                return
            if float(rng.uniform()) * peak > self.rate_at(t):
                continue  # thinned: the instantaneous rate is below peak
            yield t, *self._draw_request(rng, n)
            n += 1
            if self.requests is not None and n >= self.requests:
                return

    def _draw_request(self, rng, n):
        u = float(rng.uniform())
        lo, hi = self.prompt_len
        ids = rng.randint(1, self.vocab, size=int(rng.randint(lo, hi + 1)))
        payload = {
            "input_ids": ids.tolist(),
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
        }
        deadline_ms = (
            None if self.deadline_s is None else self.deadline_s * 1e3
        )
        if u < self.frac_over_deadline:
            kind = "over_deadline"
            deadline_ms = 0.001  # spent on arrival: sheds before admission
        elif u < self.frac_over_deadline + self.frac_unknown_adapter:
            kind = "unknown_adapter"
            payload["adapter"] = f"no-such-adapter-{n}"
        elif u < (self.frac_over_deadline + self.frac_unknown_adapter
                  + self.frac_over_bucket):
            kind = "over_bucket"
            payload["input_ids"] = rng.randint(
                1, self.vocab, size=self.over_bucket_len
            ).tolist()
        else:
            kind = "ok"
            if self.adapters:
                payload["adapter"] = self.adapters[n % len(self.adapters)]
        return kind, {"payload": payload, "deadline_ms": deadline_ms}


class SoakReport:
    """Exactly-once accounting + SLO summary for one soak run.  Counters
    are exact; latencies are a bounded reservoir (percentiles only)."""

    def __init__(self):
        self.offered = 0
        self.resolved = 0
        self.status_counts = {}  # http status -> n
        self.kind_counts = {}  # kind -> {"n", "expected", "unexpected"}
        self.error_types = {}  # typed error name -> n
        self.deadline_misses = 0  # ok-kind requests that 504'd
        self.ok_kind_total = 0
        self.latencies = []  # bounded reservoir, seconds
        self._res_rng = np.random.RandomState(20160816)
        self.wall_s = 0.0
        self.faults_armed = []

    def note(self, kind, status, body, latency_s):
        self.resolved += 1
        self.status_counts[status] = self.status_counts.get(status, 0) + 1
        k = self.kind_counts.setdefault(
            kind, {"n": 0, "expected": 0, "unexpected": 0}
        )
        k["n"] += 1
        expected = status in _EXPECTED.get(kind, (200,))
        k["expected" if expected else "unexpected"] += 1
        if status != 200 and isinstance(body, dict) and body.get("type"):
            t = body["type"]
            self.error_types[t] = self.error_types.get(t, 0) + 1
        if kind == "ok":
            self.ok_kind_total += 1
            if status == 504:
                self.deadline_misses += 1
        if len(self.latencies) < _LATENCY_RESERVOIR:
            self.latencies.append(latency_s)
        else:  # reservoir sampling keeps the percentile estimate unbiased
            j = int(self._res_rng.randint(0, self.resolved))
            if j < _LATENCY_RESERVOIR:
                self.latencies[j] = latency_s

    @property
    def exactly_once(self):
        """Every offered request came back with exactly one terminal
        status.  Workers record one outcome per dequeued request and the
        pool joins before the report closes, so offered == resolved IS
        the exactly-once audit at the client boundary."""
        return self.offered == self.resolved

    @property
    def miss_rate(self):
        """Deadline misses over ORGANIC traffic only (adversarial kinds
        provoke their failures on purpose and must not pollute the SLO)."""
        return (
            self.deadline_misses / self.ok_kind_total
            if self.ok_kind_total else 0.0
        )

    def _pctl(self, q):
        if not self.latencies:
            return 0.0
        v = sorted(self.latencies)
        return v[min(len(v) - 1, int(round(q * (len(v) - 1))))]

    def summary(self):
        ok = self.status_counts.get(200, 0)
        return {
            "offered": self.offered,
            "resolved": self.resolved,
            "exactly_once": self.exactly_once,
            "ok": ok,
            "status_counts": dict(self.status_counts),
            "kind_counts": {k: dict(v) for k, v in self.kind_counts.items()},
            "error_types": dict(self.error_types),
            "deadline_misses": self.deadline_misses,
            "miss_rate": round(self.miss_rate, 5),
            "latency_p50_ms": round(self._pctl(0.50) * 1e3, 2),
            "latency_p95_ms": round(self._pctl(0.95) * 1e3, 2),
            "wall_s": round(self.wall_s, 2),
            "requests_per_s": round(
                self.resolved / self.wall_s, 2) if self.wall_s else 0.0,
            "faults_armed": list(self.faults_armed),
        }


def run_soak(router, workload, *, threads=8, faults=(), realtime=True,
             queue_bound=4096, on_progress=None, crash_retries=100,
             crash_retry_s=0.05):
    """Drive `workload` through `router.handle_generate` with a bounded
    worker pool.  Returns a closed `SoakReport`.

    router     a live `Router`, or a zero-arg callable returning the
               CURRENT router (HA soaks pass a provider so workers pick
               up the standby's successor after a `router.crash` drill)
    faults     ((t_s, spec), ...): each `spec` is armed through
               `fault.injection.arm` when the arrival clock first passes
               t_s — the SAME registry and grammar production uses, so a
               soak's chaos schedule is one printable tuple
    realtime   True paces arrivals on the wall clock (latency numbers are
               meaningful); False dispatches as fast as the pool drains
               (throughput / million-request capability runs)
    on_progress  optional callable(report, t) invoked about once per
               arrival-clock second (progress logging in long soaks)
    crash_retries / crash_retry_s  resubmit budget when the front door
               dies mid-request (`RouterCrashed`): the worker re-attaches
               the SAME idempotency key and resubmits against whatever
               the provider returns, so a takeover window never breaks
               the exactly-once audit

    Every request carries a deterministic idempotency key
    (``soak-<seed>-<n>``), so a resubmit after a router crash joins or
    replays the original generation instead of double-generating.
    """
    import queue as _q

    from ..fault import injection as _finj
    from .router import RouterCrashed

    get_router = router if callable(router) else (lambda: router)
    report = SoakReport()
    work = _q.Queue(maxsize=queue_bound)
    done = threading.Event()
    mu = threading.Lock()

    def _worker():
        while True:
            item = work.get()
            if item is None:
                return
            kind, req = item
            key = req["payload"].get("idempotency_key")
            t0 = time.monotonic()
            try:
                for attempt in range(int(crash_retries) + 1):
                    try:
                        status, body, _hdrs = get_router().handle_generate(
                            req["payload"], deadline_ms=req["deadline_ms"]
                        )
                        break
                    except RouterCrashed:
                        # The front door died with zero response bytes on
                        # the wire; resubmitting the SAME key against the
                        # successor is the exactly-once drill.
                        # handle_generate pops the key, so re-attach it.
                        if attempt >= crash_retries:
                            raise
                        if key is not None:
                            req["payload"]["idempotency_key"] = key
                        time.sleep(crash_retry_s)
            except Exception as e:  # a raising router is a broken contract:
                status, body = -1, {"type": type(e).__name__}  # count it loud
            with mu:
                report.note(kind, status, body, time.monotonic() - t0)

    pool = [
        threading.Thread(target=_worker, name=f"soak-{i}", daemon=True)
        for i in range(int(threads))
    ]
    for t in pool:
        t.start()

    fault_sched = sorted(((float(ts), spec) for ts, spec in faults))
    fi = 0
    wall0 = time.monotonic()
    last_progress = 0.0
    try:
        for t_arr, kind, req in workload.arrivals():
            # Deterministic per-request idempotency key: replayable from
            # the seed, unique per offered request, honoured by the
            # router's dedupe cache (a crash-window resubmit reuses it).
            req["payload"].setdefault(
                "idempotency_key", f"soak-{workload.seed}-{report.offered}"
            )
            while fi < len(fault_sched) and fault_sched[fi][0] <= t_arr:
                spec = fault_sched[fi][1]
                _finj.arm(spec)
                report.faults_armed.append({"t": fault_sched[fi][0],
                                            "spec": spec})
                fi += 1
            if realtime:
                lag = wall0 + t_arr - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
            report.offered += 1
            work.put((kind, req))
            if on_progress is not None and t_arr - last_progress >= 1.0:
                last_progress = t_arr
                with mu:
                    on_progress(report, t_arr)
    finally:
        for _ in pool:
            work.put(None)
        for t in pool:
            t.join()
        done.set()
        report.wall_s = time.monotonic() - wall0
    return report
