"""The port's autoscaler and soak workload (`serving.autoscaler`,
`serving.workload`) against the JAX package's, on the CPU.

- `load_signals`, `decide` and `choose_tp` return the reference's results
  on the same snapshots.
- The control loop over stubbed replicas (`_FakeRep`, a stubbed
  `ReplicaProcess`): hysteresis, cooldowns and the band, a spawn failure
  absorbed and retried, a dead managed worker reaped and replaced, the
  admin drain before the stop, role-scoped victims and spawn arguments;
  every tick's want, action and reason equal the reference's, and so do
  the `paddle_autoscaler_*` counters.
- A live scale cycle 1 -> 2 -> 1 over in-process port replicas of a tiny
  Llama, the grown fleet answering the reference engine's tokens, and its
  flight events carrying the signal vector.
- `Workload.arrivals()` gives the reference's list for the same seed;
  `SoakReport.summary()` the same figures for the same notes; `run_soak`
  attaches the same deterministic keys and resubmits the same key
  through a router crash; the router's jitter draws the reference's
  sequence for the same seed.
"""

import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import workload as jworkload
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import flight as tflight
from paddle_tpu_torch.serving import workload as tworkload
from torch_fleet_fakes import BOTH, PORT, reset_counters

WORKLOADS = {"reference": jworkload, "port": tworkload}
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8], queue_depth=16, seed=0)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()


def _snap(**kw):
    s = {"state": "ready", "admin_draining": False, "queue_depth": 0,
         "active_slots": 0, "drain_estimate_s": 0.0, "deadline_miss_rate": 0.0,
         "page_free_frac": 1.0}
    s.update(kw)
    return s


_CFG = {"min_replicas": 1, "max_replicas": 4, "up_drain_s": 0.5,
        "up_queue_depth": 4.0, "up_miss_rate": 0.05, "min_page_free": 0.05,
        "down_drain_s": 0.05}

SNAPSHOTS = {
    "mixed": [_snap(queue_depth=6, active_slots=2, drain_estimate_s=1.5),
              _snap(queue_depth=2, drain_estimate_s=0.5, deadline_miss_rate=0.2,
                    page_free_frac=0.01),
              _snap(state="down", queue_depth=99, drain_estimate_s=99.0),
              _snap(admin_draining=True, queue_depth=99, deadline_miss_rate=1.0)],
    "dead": [_snap(state="down")],
    "drain": [_snap(drain_estimate_s=2.0, active_slots=1)],
    "queue": [_snap(queue_depth=9)],
    "miss": [_snap(deadline_miss_rate=0.5, active_slots=1)],
    "pages": [_snap(page_free_frac=0.01, active_slots=1)],
    "idle_two": [_snap(), _snap()],
    "busy_two": [_snap(active_slots=1), _snap()],
    "at_min": [_snap()],
    "at_max": [_snap(queue_depth=50)] * 4,
    "idle_tokens": [_snap(decode_ewma_ms=10.0, tokens_per_step=2.0),
                    _snap(decode_ewma_ms=20.0, tokens_per_step=3.0)],
    "roles": [_snap(role="prefill", queue_depth=8), _snap(role="decode", page_free_frac=0.05),
              _snap(role="colocated")],
}
CFGS = {"default": _CFG,
        "cost_gate": {**_CFG, "down_drain_s": 1.0, "down_min_idle_tokens_s": 1e9,
                      "chips": 2},
        "cost_reason": {**_CFG, "down_drain_s": 1.0, "down_min_idle_tokens_s": 0.0,
                        "chips": 2}}


@pytest.mark.parametrize("cfg", list(CFGS))
@pytest.mark.parametrize("name", list(SNAPSHOTS))
def test_load_signals_and_decide_match_the_reference(name, cfg):
    out = {}
    for pkg in BOTH:
        a = pkg.autoscaler
        snaps = SNAPSHOTS[name]
        out[pkg.name] = [(a.load_signals(snaps, role=role),
                          a.decide(a.load_signals(snaps, role=role), CFGS[cfg]))
                         for role in (None, "prefill", "decode")]
    assert out["port"] == out["reference"]


@pytest.mark.parametrize("free,tp_max,kv_heads", [
    (8, 4, None), (3, 8, None), (0, 4, None), (8, 8, 2), (8, 8, 3), (1, 1, None),
    (4, 1, 32), (16, 16, 8)])
def test_choose_tp_matches_the_reference(free, tp_max, kv_heads):
    assert (PORT.autoscaler.choose_tp(free, tp_max, kv_heads)
            == BOTH[0].autoscaler.choose_tp(free, tp_max, kv_heads))


class _FakeRep:
    """Just enough of a replica for the control loop."""

    def __init__(self, rid, **snap):
        self.rid = rid
        self.process = None
        self.calls = []
        self._snap = _snap(**snap)

    def snapshot(self):
        return dict(self._snap, id=self.rid)

    def set_admin_draining(self, v):
        self.calls.append(("drain", bool(v)))
        self._snap["admin_draining"] = bool(v)

    def probe(self):
        self.calls.append(("probe",))
        return {"active_slots": self._snap["active_slots"],
                "queue_depth": self._snap["queue_depth"]}

    def set_queue(self, n):
        self._snap["queue_depth"] = n


class _FakeRouter:
    def __init__(self, reps):
        self.replicas = list(reps)

    def add_replica(self, rep):
        self.replicas = self.replicas + [rep]

    def remove_replica(self, rid):
        rep = next(r for r in self.replicas if r.rid == rid)
        self.replicas = [r for r in self.replicas if r.rid != rid]
        return rep


def _mk(pkg, router, **kw):
    cfg = dict(min_replicas=1, max_replicas=3, interval=0.01, up_ticks=2, down_ticks=2,
               up_cooldown=2.0, down_cooldown=5.0, up_drain_s=0.5, up_queue_depth=4.0,
               up_miss_rate=0.05, min_page_free=0.05, down_drain_s=0.05, tp_max=1,
               devices_total=4, drain_grace=1.0)
    cfg.update(kw)
    return pkg.autoscaler.Autoscaler(router, **cfg)


def _tick(asc, now):
    t = asc.tick(now=now)
    return (t["want"], t["action"], t["reason"], [r.rid for r in asc.router.replicas])


def _hysteresis_drill(pkg):
    router = _FakeRouter([_FakeRep("r0", queue_depth=8)])
    log = []
    asc = _mk(pkg, router, spawn_fn=lambda idx, tp: log.append(("spawn", idx, tp))
              or _FakeRep(f"as{idx}"), stop_fn=lambda rep: log.append(("stop", rep.rid)))
    trail = [_tick(asc, 0.0), _tick(asc, 1.0)]
    for rep in router.replicas:
        rep.set_queue(8)
    trail += [_tick(asc, t) for t in (1.5, 2.0, 3.0)]
    for rep in router.replicas:
        rep.set_queue(50)
    trail.append(_tick(asc, 4.0))
    for rep in router.replicas:
        rep.set_queue(0)
    trail += [_tick(asc, t) for t in (5.0, 6.0, 8.0, 13.5, 14.0, 30.0)]
    return trail, log, pkg.prof.autoscale_summary()


def _spawn_failure_drill(pkg):
    router = _FakeRouter([_FakeRep("r0", queue_depth=9)])
    pkg.inj.arm("autoscale.spawn:1")
    asc = _mk(pkg, router, spawn_fn=lambda idx, tp: _FakeRep(f"as{idx}"), up_ticks=1)
    return [_tick(asc, 0.0), _tick(asc, 0.1)], [], pkg.prof.autoscale_summary()


class _DeadProc:
    def alive(self):
        return False


def _reap_drill(pkg):
    as0 = _FakeRep("as0", state="down")
    as0.process = _DeadProc()
    router = _FakeRouter([_FakeRep("r0", queue_depth=9), as0])
    asc = _mk(pkg, router, spawn_fn=lambda i, tp: _FakeRep(f"as{i}"), up_ticks=1,
              max_replicas=2)
    asc._managed["as0"] = as0
    trail = [_tick(asc, 0.0)]
    return trail, [router.replicas[1] is not as0], pkg.prof.autoscale_summary()


def _drain_drill(pkg):
    r0, as0 = _FakeRep("r0"), _FakeRep("as0")
    router = _FakeRouter([r0, as0])
    stopped = []
    asc = _mk(pkg, router, spawn_fn=lambda i, tp: None,
              stop_fn=lambda rep: stopped.append((rep.rid, list(rep.calls))),
              down_ticks=1, down_cooldown=0.0)
    asc._managed[as0.rid] = as0
    trail = [_tick(asc, t) for t in (0.0, 1.0, 2.0, 3.0)]
    return trail, stopped, pkg.prof.autoscale_summary()


def _role_drill(pkg):
    reps = [_FakeRep("p0", role="prefill"), _FakeRep("d0", role="decode"),
            _FakeRep("d1", role="decode")]
    asc = _mk(pkg, _FakeRouter(reps), spawn_fn=lambda idx, tp: None,
              stop_fn=lambda rep: None, max_replicas=4, role="decode", devices_total=8)
    return [asc._pick_victim().rid], [], pkg.prof.autoscale_summary()


DRILLS = {"hysteresis": _hysteresis_drill, "spawn_failure": _spawn_failure_drill,
          "reap": _reap_drill, "drain_before_stop": _drain_drill, "role": _role_drill}


@pytest.mark.parametrize("drill", list(DRILLS))
def test_the_control_loop_decides_as_the_reference(drill):
    seen = {pkg.name: DRILLS[drill](pkg) for pkg in BOTH}
    assert seen["port"] == seen["reference"]
    trail, extra, g = seen["port"]
    if drill == "hysteresis":
        assert [t[1] for t in trail] == ["hold", "up", "hold", "hold", "up", "hold",
                                         "hold", "hold", "down", "hold", "down", "hold"]
        assert extra[-2:] == [("stop", "as1"), ("stop", "as0")]
        assert (g["scale_ups"], g["scale_downs"], g["replicas_peak"]) == (2, 2, 3)
    elif drill == "spawn_failure":
        assert [t[1] for t in trail] == ["hold", "up"] and g["spawn_failures"] == 1
    elif drill == "reap":
        assert trail[0][1] == "up" and extra == [True] and g["reaps"] == 1
    elif drill == "drain_before_stop":
        # the router stopped picking it, its probe saw no work, then it stopped
        assert extra == [("as0", [("drain", True), ("probe",)])]
        assert [t[3] for t in trail] == [["r0"]] * 4
    else:
        assert trail[0] in ("d0", "d1")


@pytest.mark.parametrize("role", [None, "decode", "prefill"])
def test_default_spawn_boots_a_replica_process_with_the_references_arguments(
        monkeypatch, role):
    captured = {}

    class _StubProc:
        def __init__(self, index, port, log_dir, host="127.0.0.1", extra_args=()):
            captured.setdefault(mod_name, []).append((index, list(extra_args)))
            self.host, self.port = host, port

        @property
        def url(self):
            return f"http://{self.host}:{self.port}"

        def start(self):
            return self

    for pkg in BOTH:
        mod_name = pkg.name
        monkeypatch.setattr(pkg.autoscaler, "ReplicaProcess", _StubProc)
        asc = _mk(pkg, _FakeRouter([]), role=role, log_dir="unused-log-dir")
        rep = asc._default_spawn(3, 1)
        assert rep.rid == "as3" and rep.process is not None
    assert captured["port"] == captured["reference"]
    assert captured["port"][0] == (103, [] if role in (None, "colocated")
                                   else ["--role", role])


@pytest.fixture(scope="module")
def models():
    state = paddle.get_rng_state()
    paddle.seed(51)
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    paddle.set_rng_state(state)
    return jm, load_reference_state(tm, weights)


def test_a_live_scale_cycle_over_in_process_port_replicas(models, tmp_path):
    """One seed replica; pressure on its snapshot scales the fleet to two
    (the spawn enters 'connecting' until a probe reads it ready), the grown
    fleet answers the reference engine's tokens, and idleness drains the
    spawn away through the admin drain."""
    servers = {}

    def serve_one():
        eng = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE).warmup()
        srv = tinference.serve(eng, port=0, block=False, supervise=False,
                               handle_signals=False)
        return srv, f"http://127.0.0.1:{srv.server_address[1]}"

    servers["r0"], url0 = serve_one()
    router = PORT.Router([PORT.Replica("r0", url0)], probe_interval=3600,
                         retry_backoff=0.02)

    def spawn(idx, tp):
        srv, url = serve_one()
        servers[f"as{idx}"] = srv
        return PORT.Replica(f"as{idx}", url)

    def stop(rep):
        servers.pop(rep.rid).stop()

    asc = PORT.autoscaler.Autoscaler(
        router, spawn_fn=spawn, stop_fn=stop, min_replicas=1, max_replicas=2,
        up_ticks=2, down_ticks=2, up_cooldown=0.0, down_cooldown=0.0, up_drain_s=10.0,
        up_queue_depth=4.0, up_miss_rate=0.5, min_page_free=0.0, down_drain_s=10.0,
        tp_max=1, devices_total=1, drain_grace=5.0, interval=3600)
    tflight.reset()
    ref = JaxEngine(models[0], **ENGINE)
    try:
        router.probe_once()
        router.replicas[0]._queue_depth = 9  # pressure on the last probe
        assert asc.tick(now=0.0)["action"] == "hold"
        t = asc.tick(now=1.0)
        assert t["action"] == "up" and "mean queue" in t["reason"]
        assert [r.rid for r in router.replicas] == ["r0", "as0"]
        assert router.replicas[1].state == "connecting"
        router.probe_once()
        assert router.replicas[1].state == "ready"
        for i in range(3):
            p = np.random.RandomState(5 + i).randint(1, 250, size=6).astype(np.int32)
            status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                      "max_new_tokens": 3},
                                                     idem_key=None)
            assert status == 200 and body["tokens"] == ref.generate(
                p, max_new_tokens=3).tolist()
        router.probe_once()
        assert asc.tick(now=2.0)["want"] == "down"
        t = asc.tick(now=3.0)
        assert t["action"] == "down" and [r.rid for r in router.replicas] == ["r0"]
        assert "as0" not in servers
        g = PORT.prof.autoscale_summary()
        assert (g["scale_ups"], g["scale_downs"], g["replicas_peak"]) == (1, 1, 2)
        path = tflight.dump("autoscale-test", path=str(tmp_path / "f.jsonl"))
        with open(path) as f:
            lines = [json.loads(line) for line in f]
        assert lines[0]["autoscale"]["scale_ups"] == 1
        evs = [e for e in lines[1:] if e.get("kind") == "autoscale"]
        up = next(e for e in evs if "scale_up -> as0" in e["detail"])
        down = next(e for e in evs if "scale_down -> as0" in e["detail"])
        assert up["mean_queue"] >= 4.0 and up["tp"] == 1 and down["fleet"] == 1
    finally:
        router.stop()
        for srv in servers.values():
            srv.stop()


WORKLOAD_KW = {
    "stepped": dict(rate_hz=40.0, duration_s=6.0, seed=11,
                    steps=((0.0, 1.0), (2.0, 4.0), (4.0, 1.0)), diurnal_period_s=6.0,
                    diurnal_amp=0.3, frac_over_deadline=0.05, frac_unknown_adapter=0.05,
                    frac_over_bucket=0.05, max_len_hint=64, deadline_s=30.0),
    "capped": dict(rate_hz=1e6, duration_s=3600.0, requests=50, seed=1),
    "adapters": dict(rate_hz=100.0, duration_s=1.0, seed=4, adapters=("a1", "a2"),
                     prompt_len=(2, 20), vocab=32000, temperature=0.7),
}


@pytest.mark.parametrize("name", list(WORKLOAD_KW))
def test_workload_arrivals_are_the_references_for_the_same_seed(name):
    lists = {pkg: list(mod.Workload(**WORKLOAD_KW[name]).arrivals())
             for pkg, mod in WORKLOADS.items()}
    assert lists["port"] == lists["reference"] and len(lists["port"]) >= 50
    w = {pkg: mod.Workload(**WORKLOAD_KW[name]) for pkg, mod in WORKLOADS.items()}
    for t in (0.0, 1.0, 2.5, 3.0, 5.9):
        assert w["port"].rate_at(t) == w["reference"].rate_at(t)
    assert w["port"].peak_rate() == w["reference"].peak_rate()


@pytest.mark.parametrize("kw", [dict(diurnal_amp=1.0),
                                dict(frac_over_deadline=0.6, frac_unknown_adapter=0.5),
                                dict(steps=((0.0, 0.0),))])
def test_workload_refuses_the_references_bad_knobs(kw):
    for mod in WORKLOADS.values():
        with pytest.raises(ValueError):
            mod.Workload(**kw)


def test_soak_report_summary_is_the_references_for_the_same_notes():
    notes = [("ok", 200, {"tokens": [1]}, 0.010), ("ok", 200, {"tokens": [2]}, 0.020),
             ("ok", 504, {"type": "DeadlineExceeded"}, 0.500),
             ("unknown_adapter", 404, {"type": "AdapterUnknown"}, 0.002),
             ("over_bucket", 400, {"type": "ValueError"}, 0.001),
             ("over_deadline", 503, {"type": "RouterOverloaded"}, 0.001),
             ("ok", 500, {"type": "NonFiniteLogits"}, 0.1)]
    rng = np.random.RandomState(0)
    notes += [("ok", 200, {}, float(x)) for x in rng.exponential(0.05, size=200)]
    out = {}
    for name, mod in WORKLOADS.items():
        rep = mod.SoakReport()
        rep.offered = len(notes) - 1
        for n in notes:
            rep.note(*n)
        rep.wall_s = 2.5
        out[name] = (rep.summary(), rep.exactly_once, rep.miss_rate)
    assert out["port"] == out["reference"]
    assert out["port"][1] is False and out["port"][0]["kind_counts"]["ok"]["unexpected"] == 2


def _soak_keys(mod, crashed):
    seen = []

    class _Router:
        crashes = 2 if crashed else 0

        def handle_generate(self, payload, deadline_ms=None):
            key = payload.pop("idempotency_key", None)  # the real router pops it
            seen.append(key)
            if self.crashes:
                self.crashes -= 1
                raise mod_router.RouterCrashed("drill")
            return 200, {"tokens": []}, {}

    mod_router = PORT.router if mod is tworkload else BOTH[0].router
    wl = mod.Workload(rate_hz=200.0, duration_s=5.0, seed=7, requests=1 if crashed else 20)
    report = mod.run_soak(_Router(), wl, threads=1 if crashed else 2, realtime=False,
                          crash_retry_s=0.0)
    return sorted(seen), report.exactly_once, report.status_counts, report.offered


@pytest.mark.parametrize("crashed", [False, True], ids=["keys", "crash"])
def test_run_soak_keys_and_crash_resubmission_match_the_reference(crashed):
    out = {name: _soak_keys(mod, crashed) for name, mod in WORKLOADS.items()}
    assert out["port"] == out["reference"]
    keys, once, statuses, offered = out["port"]
    assert once and statuses == {200: offered}
    if crashed:
        assert keys == ["soak-7-0"] * 3  # two crashes and the success, one key
    else:
        assert len(set(keys)) == 20 and all(k.startswith("soak-7-") for k in keys)


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_the_routers_jitter_draws_the_references_sequence(seed):
    draws = {}
    for pkg in BOTH:
        router = pkg.Router([], probe_interval=60.0, seed=seed)
        draws[pkg.name] = ([router._jitter_retry_after(10.0) for _ in range(50)]
                           + [router._backoff(a) for a in range(4)])
    assert draws["port"] == draws["reference"]
    assert all(7.5 <= d <= 12.5 for d in draws["port"][:50])
