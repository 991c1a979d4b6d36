"""The port's serving router (`paddle_tpu_torch.serving.router`) against
the JAX package's, on the CPU.

Two port replicas (`serve()` over tiny float32 Llama engines) and two
reference replicas hold the same weights (`load_reference_state`).  The
same greedy stream goes through the port's Router over the port replicas
and the reference's Router over the reference replicas:

- the tokens are identical, and so are the router counters;
- failover from a replica stopped after its probe: every request resolves
  once with the same tokens, and `router_summary()` counts the same
  retries, failovers and breaker transitions;
- the typed errors (NoReadyReplica, RouterOverloaded, DeadlineExhausted,
  DeadlineUnattainable) carry the same status, body and headers (the same
  seed draws the same Retry-After jitter; the body's trace id aside);
- the breaker cycle (open -> half-open -> closed, and a flapping probe)
  and a hedge that beats a hung replica count the same;
- one trace holds the aborted hop and the surviving retry, with the
  reference's span names;
- `serve_router` over HTTP: tokens, /healthz, /metrics with
  role="router", /trace/<id>, and a crashed router dropping the
  connection;
- a rolling restart drops no request (the clients wait on state).

The control-plane drills run both routers over the same scripted
replicas (`torch_fleet_fakes.FakeReplica`).
"""

import http.client
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference import serve as jserve
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from torch_fleet_fakes import BOTH, PORT, FakeReplica, reset_counters, strip_trace

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8], queue_depth=16, seed=0)
COUNTERS = ("requests", "retries", "failovers", "breaker_trips", "breaker_half_open",
            "breaker_closes", "hedges", "hedge_wins", "brownout_sheds",
            "deadline_sheds", "no_replica")


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


STREAM = [(_prompt(n, seed=i), 6) for i, n in enumerate((5, 7, 6, 4, 8, 3))]


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()
    for pkg in BOTH:
        pkg.core.set_flags({"FLAGS_fault_hang_sec": 3600.0, "FLAGS_trace": False})
        pkg.trace.reset()


@pytest.fixture(scope="module")
def models():
    paddle.seed(51)
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


def _url(srv):
    return f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def fleets(models):
    """Two warmed replicas per package: {"reference": [...], "port": [...]}
    of (server, engine, url)."""
    jm, tm = models
    out = {"reference": [], "port": []}
    for _ in range(2):
        eng = JaxEngine(jm, **ENGINE)
        srv = jserve(eng, port=0, block=False, supervise=False, handle_signals=False)
        out["reference"].append((srv, eng, _url(srv)))
        teng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE).warmup()
        tsrv = tinference.serve(teng, port=0, block=False, supervise=False,
                                handle_signals=False)
        out["port"].append((tsrv, teng, _url(tsrv)))
    # every replica compiles (or traces) its steps before any timed drill
    for reps in out.values():
        for _, _, url in reps:
            assert _post(url, {"input_ids": [1, 2, 3], "max_new_tokens": 2})[0] == 200
    yield out
    for srv, eng, _ in out["reference"]:
        eng.stop()
        srv.shutdown()
        srv.server_close()
    for srv, _, _ in out["port"]:
        srv.stop()
        srv.server_close()


@pytest.fixture(scope="module")
def ref_tokens(fleets):
    """The reference replicas' greedy tokens of STREAM, one direct POST each."""
    url = fleets["reference"][0][2]
    return [_post(url, {"input_ids": p.tolist(), "max_new_tokens": n})[1]["tokens"]
            for p, n in STREAM]


def _post(url, body, headers=None, path="/generate"):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(url, path):
    try:
        with urllib.request.urlopen(url + path, timeout=60) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _urls(fleets, pkg):
    return [url for _, _, url in fleets[pkg.name]]


def _counts(pkg, keys=COUNTERS):
    g = pkg.prof.router_summary()
    return {k: g[k] for k in keys}


def test_the_same_stream_through_both_routers_gives_identical_tokens(fleets, ref_tokens):
    got, counts = {}, {}
    for pkg in BOTH:
        router = pkg.Router(_urls(fleets, pkg), probe_interval=3600)
        router.probe_once()
        got[pkg.name] = []
        for p, n in STREAM:
            status, body, _ = router.handle_generate(
                {"input_ids": p.tolist(), "max_new_tokens": n})
            assert status == 200, body
            got[pkg.name].append(body["tokens"])
        counts[pkg.name] = _counts(pkg)
        assert pkg.prof.router_summary()["replica_states"] == {"r0": "ready",
                                                               "r1": "ready"}
        router.stop()
    assert got["port"] == got["reference"] == ref_tokens
    assert counts["port"] == counts["reference"]
    assert counts["port"]["requests"] == len(STREAM) and counts["port"]["retries"] == 0


def test_failover_from_a_stopped_replica_resolves_each_request_once(fleets, ref_tokens):
    """The preferred replica dies after its probe read it ready: the first
    requests fail over to the survivor until the breaker opens, then the
    survivor is picked directly; every request answers once, the same
    tokens, and both routers count the same."""
    got, counts, breakers = {}, {}, {}
    for pkg in BOTH:
        dead = FakeReplica()
        router = pkg.Router([dead.url, _urls(fleets, pkg)[1]], probe_interval=3600,
                            retry_backoff=0.01)
        router.probe_once()
        dead.stop()
        got[pkg.name] = [router.handle_generate(
            {"input_ids": p.tolist(), "max_new_tokens": n}) for p, n in STREAM]
        counts[pkg.name] = _counts(pkg)
        breakers[pkg.name] = [r.breaker for r in router.replicas]
        router.stop()
    for pkg in BOTH:
        assert [s for s, _, _ in got[pkg.name]] == [200] * len(STREAM)
        assert [b["tokens"] for _, b, _ in got[pkg.name]] == ref_tokens
    assert counts["port"] == counts["reference"]
    assert counts["port"]["retries"] == counts["port"]["failovers"] == 3
    assert counts["port"]["breaker_trips"] == 1
    assert breakers["port"] == breakers["reference"] == ["open", "closed"]


def _error_drills(pkg):
    """Each typed router error on one package's routers (seed 0)."""
    out = {}
    never = pkg.Router([pkg.Replica("r0", "http://127.0.0.1:9")], probe_interval=3600)
    out["NoReadyReplica"] = never.handle_generate({"input_ids": [1]})
    fake = FakeReplica()
    try:
        gate = pkg.Router([fake.url], probe_interval=3600, max_inflight=0)
        gate.probe_once()
        out["RouterOverloaded"] = gate.handle_generate({"input_ids": [1, 2, 3]})
        spent = pkg.Router([fake.url], probe_interval=3600)
        spent.probe_once()
        out["DeadlineExhausted"] = spent.handle_generate({"input_ids": [1, 2]},
                                                         deadline_ms=0)
    finally:
        fake.stop()
    rep = pkg.Replica("r0", "http://127.0.0.1:9")
    rep._note_healthz({"status": "ready", "queue_depth": 8, "active_slots": 2,
                       "drain_estimate_s": 50.0})
    busy = pkg.Router([rep], probe_interval=3600)
    out["DeadlineUnattainable"] = busy.handle_generate({"input_ids": [1, 2, 3]},
                                                       deadline_ms=1000)
    out["counts"] = _counts(pkg)
    return out


def test_typed_errors_carry_the_references_status_body_and_headers():
    got = {pkg.name: _error_drills(pkg) for pkg in BOTH}
    for err in ("NoReadyReplica", "RouterOverloaded", "DeadlineExhausted",
                "DeadlineUnattainable"):
        (js, jb, jh), (ts, tb, th) = got["reference"][err], got["port"][err]
        assert ts == js and strip_trace(tb) == strip_trace(jb), err
        assert tb["type"] == err and tb["trace_id"]
        assert {k: v for k, v in th.items() if k != "X-Trace-Id"} == \
               {k: v for k, v in jh.items() if k != "X-Trace-Id"}, err
    assert got["port"]["counts"] == got["reference"]["counts"]
    status, body, headers = got["port"]["DeadlineUnattainable"]
    assert (status, body["retriable"]) == (504, False)
    # the shed's Retry-After is the healthiest drain estimate under the
    # +/-25% jitter (FLAGS_router_retry_after_jitter), not exactly 50
    assert 50 * 0.75 <= body["retry_after_s"] <= 50 * 1.25
    assert int(headers["Retry-After"]) == int(body["retry_after_s"] + 0.5)
    assert got["port"]["NoReadyReplica"][0] == 503
    assert got["port"]["DeadlineExhausted"][1]["retriable"] is False


def test_breaker_cycle_counts_as_the_reference():
    """closed -> open (3 failures) -> half-open trial -> open (it failed) ->
    half-open -> closed, on each package's Replica."""
    seen = {}
    for pkg in BOTH:
        rep = pkg.Replica("r0", "http://127.0.0.1:9", breaker_threshold=3,
                          breaker_cooldown=0.05)
        trail = [rep.breaker, rep.allow()]
        for _ in range(3):
            rep.record_failure("x")
            trail.append(rep.breaker)
        trail.append(rep.allow())
        time.sleep(0.06)
        trail += [rep.allow(), rep.breaker, rep.allow()]
        rep.record_failure("trial failed")
        trail.append(rep.breaker)
        time.sleep(0.06)
        trail.append(rep.allow())
        rep.record_success(0.01)
        trail += [rep.breaker, rep.allow()]
        seen[pkg.name] = (trail, _counts(pkg))
    assert seen["port"] == seen["reference"]
    assert seen["port"][1]["breaker_trips"] == 2
    assert seen["port"][1]["breaker_half_open"] == 2
    assert seen["port"][1]["breaker_closes"] == 1


def test_a_flapping_probe_opens_the_breaker_and_a_good_one_closes_it():
    seen = {}
    fake = FakeReplica()
    try:
        for pkg in BOTH:
            router = pkg.Router([fake.url], probe_interval=3600, retry_backoff=0.01)
            router.probe_once()
            pkg.inj.arm("router.replica.flap:3")
            for _ in range(3):
                router.probe_once()
            rep = router.replicas[0]
            trail = [rep.state, rep.breaker, router.pick()]
            pkg.inj.disarm()
            router.probe_once()
            trail += [rep.state, rep.breaker, router.pick() is rep]
            seen[pkg.name] = (trail, _counts(pkg),
                              pkg.prof.router_summary()["replica_states"])
    finally:
        fake.stop()
    assert seen["port"] == seen["reference"]
    assert seen["port"][0] == ["down", "open", None, "ready", "closed", True]


def test_a_hedge_beats_a_hung_replica(fleets, ref_tokens):
    got = {}
    for pkg in BOTH:
        router = pkg.Router(_urls(fleets, pkg), probe_interval=3600,
                            retry_backoff=0.01, hedge_s=0.05)
        router.probe_once()
        pkg.core.set_flags({"FLAGS_fault_hang_sec": 2.0})
        pkg.inj.arm("router.replica.hang:1")  # wedges the primary dispatch
        p, n = STREAM[2]
        t0 = time.monotonic()
        status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                  "max_new_tokens": n})
        got[pkg.name] = (status, body["tokens"], time.monotonic() - t0, _counts(pkg))
        router.stop()
    for pkg in BOTH:
        status, tokens, wall, counts = got[pkg.name]
        assert status == 200 and tokens == ref_tokens[2]
        assert wall < 2.0  # the hedge answered; the hang did not gate it
    assert got["port"][3] == got["reference"][3]
    assert got["port"][3]["hedges"] == got["port"][3]["hedge_wins"] == 1


def _span_shape(trace, tid):
    """The trace's spans as (name, status, attrs of interest, parent's name)."""
    spans = trace.spans(tid)
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in sorted(spans, key=lambda s: (s["ts"], s["name"])):
        parent = by_id.get(s.get("parent_id"))
        a = s.get("attrs") or {}
        out.append((s["name"], s["status"], a.get("replica"), a.get("http_status"),
                    parent["name"] if parent else None))
    return out


def test_one_trace_holds_the_aborted_hop_and_the_retry(fleets):
    shapes = {}
    for pkg in BOTH:
        pkg.core.set_flags({"FLAGS_trace": True})
        pkg.trace.reset()
        dead = FakeReplica()
        router = pkg.Router([dead.url, _urls(fleets, pkg)[1]], probe_interval=3600,
                            retry_backoff=0.01)
        router.probe_once()
        dead.stop()
        p, n = STREAM[3]
        status, _, headers = router.handle_generate({"input_ids": p.tolist(),
                                                     "max_new_tokens": n})
        assert status == 200
        tids = {s["trace_id"] for s in pkg.trace.spans()}
        assert len(tids) == 1  # one trace spans the failure and the retry
        tid = tids.pop()
        # the survivor's serve.handle is recorded after its reply's bytes
        deadline = time.monotonic() + 30
        while (not any(s["name"] == "serve.handle" for s in pkg.trace.spans(tid))
               and time.monotonic() < deadline):
            time.sleep(0.01)
        spans = pkg.trace.spans(tid)
        fwd = [s for s in spans if s["name"] == "replica.forward"]
        handle = [s for s in spans if s["name"] == "serve.handle"]
        assert [s["status"] for s in fwd] == ["aborted", "ok"]
        assert fwd[0]["attrs"]["error"]
        assert len(handle) == 1 and handle[0]["parent_id"] == fwd[1]["span_id"]
        shapes[pkg.name] = [x for x in _span_shape(pkg.trace, tid)
                            if x[0].startswith(("router.", "replica.", "serve.handle"))]
        router.stop()
    assert shapes["port"] == shapes["reference"]
    assert [x[0] for x in shapes["port"]] == [
        "router.admit", "router.pick", "replica.forward", "router.pick",
        "replica.forward", "serve.handle"]


def _front_door(pkg, urls):
    server = pkg.router.serve_router(urls, port=0, block=False, probe=False)
    server.router.probe_once()
    return server, _url(server)


def test_serve_router_front_door_over_http(fleets, ref_tokens):
    seen = {}
    for pkg in BOTH:
        pkg.core.set_flags({"FLAGS_trace": True})
        server, url = _front_door(pkg, _urls(fleets, pkg))
        try:
            p, n = STREAM[0]
            status, body, headers = _post(url, {"input_ids": p.tolist(),
                                                "max_new_tokens": n,
                                                "deadline_s": 60.0})
            tid = headers["X-Trace-Id"]
            code_h, healthz = _get(url, "/healthz")
            code_m, metrics = _get(url, "/metrics")
            code_t, tree = _get(url, f"/trace/{tid}")
            code_404, _ = _get(url, "/nowhere")
            requests = [line for line in metrics.splitlines()
                        if line.startswith("paddle_router_requests_total{")]
            healthz = json.loads(healthz)
            seen[pkg.name] = dict(
                status=status, tokens=body["tokens"], codes=(code_h, code_m, code_t,
                                                             code_404),
                healthz_keys=sorted(healthz), ready=healthz["ready_replicas"],
                requests=[line.split("}")[0].split("{")[1].split(",")[1:]
                          + line.rsplit(" ", 1)[1:] for line in requests],
                roots=[s["name"] for s in json.loads(tree)["spans"]])
            # the front door dies: the connection closes with no response
            pkg.inj.arm("router.crash:1")
            server.router.probe_once()
            host, port = server.server_address[:2]
            conn = http.client.HTTPConnection(host, port, timeout=30)
            conn.request("POST", "/generate", body=json.dumps({"input_ids": [1, 2]}),
                         headers={"Content-Type": "application/json"})
            with pytest.raises((http.client.RemoteDisconnected, ConnectionError)):
                conn.getresponse()
            conn.close()
            seen[pkg.name]["crashes"] = pkg.prof.router_summary()["crashes"]
        finally:
            server.stop_router()
            server.server_close()
    assert seen["port"] == seen["reference"]
    assert seen["port"]["tokens"] == ref_tokens[0]
    assert seen["port"]["codes"] == (200, 200, 200, 404)
    assert seen["port"]["requests"] == [['role="router"', "1"]]
    assert seen["port"]["roots"] == ["router.admit"] and seen["port"]["crashes"] == 1


def test_a_rolling_restart_drops_no_request(fleets, ref_tokens):
    """Clients keep posting while each replica is drained, restarted (a warm
    engine restart behind the same server) and readmitted; the clients stop
    only once every one of them has been answered after the restart, so
    the drill waits on state, not on sleeps."""
    engines = {f"r{i}": eng for i, (_, eng, _) in enumerate(fleets["port"])}
    router = PORT.Router(_urls(fleets, PORT), probe_interval=0.05, retry_backoff=0.01)
    restarted, results, mu = [], [], threading.Lock()
    done = threading.Event()
    after = {}  # client -> answers after the restart finished

    def restart(rep, grace):
        engines[rep.rid].restart()
        restarted.append(rep.rid)

    def client(c):
        i = 0
        while not (done.is_set() and after.get(c, 0) >= 1):
            p, n = STREAM[(c + i) % len(STREAM)]
            status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                      "max_new_tokens": n})
            with mu:
                results.append(((c + i) % len(STREAM), status, body))
                if done.is_set():
                    after[c] = after.get(c, 0) + 1
            i += 1

    router.start()
    threads = [threading.Thread(target=client, args=(c,), daemon=True) for c in range(3)]
    try:
        for t in threads:
            t.start()
        while len(results) < 3:  # load is flowing before the upgrade
            time.sleep(0.01)
        report = router.rolling_restart(grace=10.0, ready_timeout=10.0,
                                        restart_fn=restart)
        done.set()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        done.set()
        router.stop()
    assert restarted == ["r0", "r1"]
    assert all(r["drained"] and r["ready"] and r["restarted"] for r in report)
    assert results and all(status == 200 for _, status, _ in results)
    assert all(body["tokens"] == ref_tokens[i] for i, _, body in results)
    assert {r.state for r in router.replicas} == {"ready"}
