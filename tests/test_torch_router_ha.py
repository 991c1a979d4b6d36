"""The port's crash-proof front door (`Router` with a journal and a
heartbeat, `RouterStandby`) against the JAX package's, on the CPU.

- Idempotency: a double submit (header or body key) and an in-flight join
  reach the replica once and return identical bytes, with the
  reference's replay headers and counters, both routers over the same
  scripted replica; and over a port replica serving a tiny Llama, the
  tokens of the reference's engine.
- Rehydration: a successor restores the breakers (no close onto a sick
  replica), the drain flags, the registry and the completed keys (replayed
  with zero replicas), as the reference's does; a journal the reference's
  primary wrote rehydrates the port's successor and the reverse; the
  autoscaler's cooldown clock survives the takeover.
- The standby: a stale heartbeat is detected on the standby's own clock
  after one full timeout, and the takeover replays the journal.
- The drill: `router.crash` kills a journaled, heartbeating port router
  over two port replicas; a keyed caller sees RouterCrashed; the standby
  takes over; the key replays from the journal without a new generation
  and new traffic gets the reference's tokens.
"""

import json
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.fault import heartbeat as jhb
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.serving import journal as jjournal
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fault import heartbeat as thb
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.serving import journal as tjournal
from torch_fleet_fakes import BOTH, PORT, REF, FakeReplica, reset_counters

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8], queue_depth=16, seed=0)
JOURNALS = {"reference": jjournal, "port": tjournal}


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path / "flightrec"))
    reset_counters()
    yield
    reset_counters()


@pytest.fixture(scope="module")
def models():
    paddle.seed(51)
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture(scope="module")
def ref_generate(models):
    eng = JaxEngine(models[0], **ENGINE)
    return lambda p, n: eng.generate(p, max_new_tokens=n).tolist()


@pytest.fixture(scope="module")
def port_fleet(models):
    """Two port replicas with a count of their engines' admissions."""
    servers, admitted = [], []
    for _ in range(2):
        eng = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE).warmup()
        real = eng.submit

        def submit(*a, _real=real, **kw):
            admitted.append(1)
            return _real(*a, **kw)

        eng.submit = submit
        servers.append(tinference.serve(eng, port=0, block=False, supervise=False,
                                        handle_signals=False))
    yield [f"http://127.0.0.1:{s.server_address[1]}" for s in servers], admitted
    for s in servers:
        s.stop()
        s.server_close()


def _keyed_drill(pkg, url):
    """A header key twice, then the same key in the body."""
    router = pkg.Router([url], probe_interval=3600)
    router.probe_once()
    payload = {"input_ids": [3, 1, 4, 1, 5], "max_new_tokens": 4, "temperature": 0.0}
    out = [router.handle_generate(dict(payload), idem_key="dup-1"),
           router.handle_generate(dict(payload), idem_key="dup-1"),
           router.handle_generate({**payload, "idempotency_key": "dup-1"})]
    g = pkg.prof.router_summary()
    router.stop()
    return ([(s, json.dumps(b), h.get("X-Idempotency-Replay")) for s, b, h in out],
            g["idem_hits"], g["idem_joins"])


def test_a_double_submit_generates_once_with_identical_bytes():
    seen = {}
    for pkg in BOTH:
        fake = FakeReplica()
        try:
            seen[pkg.name] = _keyed_drill(pkg, fake.url) + (fake.counts.get("/generate"),)
            # the key in the body is stripped before the replica sees it
            assert all("idempotency_key" not in body for _, body, _ in fake.calls)
        finally:
            fake.stop()
    assert seen["port"] == seen["reference"]
    replies, hits, joins, generations = seen["port"]
    assert [r[2] for r in replies] == [None, "hit", "hit"]
    assert len({r[1] for r in replies}) == 1
    assert (hits, joins, generations) == (2, 0, 1)


def test_a_double_submit_over_a_port_replica_gives_the_references_tokens(
        port_fleet, ref_generate):
    urls, admitted = port_fleet
    before = len(admitted)
    replies, hits, _ = _keyed_drill(PORT, urls[0])
    assert len(admitted) == before + 1  # one generation reached the engine
    assert hits == 2
    assert json.loads(replies[0][1])["tokens"] == ref_generate(
        np.array([3, 1, 4, 1, 5], np.int32), 4)


def _join_drill(pkg, fake):
    """The first keyed request holds inside the replica (1 s) while a
    second one with the same key arrives and joins it."""
    router = pkg.Router([fake.url], probe_interval=3600)
    router.probe_once()
    fake.hang_s, fake.mode = 1.0, "hang"
    out = {}

    def submit(tag):
        out[tag] = router.handle_generate({"input_ids": [2, 7, 1], "max_new_tokens": 3},
                                          idem_key="join-1")

    first = threading.Thread(target=submit, args=("first",))
    first.start()
    while fake.counts.get("/generate", 0) == 0:  # the first is in flight
        time.sleep(0.005)
    second = threading.Thread(target=submit, args=("second",))
    second.start()
    first.join(30)
    second.join(30)
    router.stop()
    fake.mode = "ok"
    (s1, b1, h1), (s2, b2, h2) = out["first"], out["second"]
    g = pkg.prof.router_summary()
    return ((s1, json.dumps(b1), h1.get("X-Idempotency-Replay")),
            (s2, json.dumps(b2), h2.get("X-Idempotency-Replay")),
            g["idem_joins"], fake.counts["/generate"])


def test_an_in_flight_join_returns_the_live_requests_bytes():
    seen = {}
    for pkg in BOTH:
        fake = FakeReplica()
        try:
            seen[pkg.name] = _join_drill(pkg, fake)
        finally:
            fake.stop()
    assert seen["port"] == seen["reference"]
    first, second, joins, generations = seen["port"]
    assert first[:2] == second[:2] and first[0] == 200
    assert (first[2], second[2], joins, generations) == (None, "join", 1, 1)


def _primary_history(pkg, root, url):
    """A journaled primary: a sick replica (breaker open, drained), a
    healthy one, one completed key; then its death (no graceful close)."""
    sick = pkg.Replica("sick", "http://127.0.0.1:9", breaker_threshold=2,
                       breaker_cooldown=30.0)
    primary = pkg.Router([sick, pkg.Replica("good", url)], probe_interval=60.0,
                         journal=root)
    sick.record_failure("x")
    sick.record_failure("x")
    sick.set_admin_draining(True)
    primary._idem.complete("done-key", 200, {"tokens": [1, 2, 3]}, {"X-Trace-Id": "t"})
    primary.journal.close()


def _successor_view(pkg, root):
    successor = pkg.Router([], probe_interval=60.0, journal=root)
    reps = {r.rid: r for r in successor.replicas}
    view = dict(
        rids=sorted(reps), urls=sorted(r.base_url for r in reps.values()),
        breakers={rid: r.breaker for rid, r in reps.items()},
        allow_sick=reps["sick"].allow(),
        draining={rid: r.snapshot()["admin_draining"] for rid, r in reps.items()},
        takeovers=successor.healthz()["takeovers"],
        replay=successor.handle_generate({"input_ids": [1], "max_new_tokens": 3},
                                         idem_key="done-key"),
        counted=pkg.prof.router_summary()["takeovers"])
    successor.journal.close()
    successor.stop()
    return view


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_successor_rehydrates_from_either_packages_journal(tmp_path, writer):
    """The primary of `writer` journals; each package's successor then
    opens a copy of that journal: the same registry, breakers (still open,
    the primary's cooldown binding), drains and replayed key."""
    import shutil

    fake = FakeReplica()
    try:
        src = str(tmp_path / "primary")
        _primary_history(REF if writer == "reference" else PORT, src, fake.url)
        views = {}
        for pkg in BOTH:
            root = str(tmp_path / pkg.name)
            shutil.copytree(src, root)
            views[pkg.name] = _successor_view(pkg, root)
        assert fake.counts == {}  # the key replayed with no replica contacted
    finally:
        fake.stop()
    assert views["port"] == views["reference"]
    v = views["port"]
    assert v["rids"] == ["good", "sick"] and v["breakers"]["sick"] == "open"
    assert v["allow_sick"] is False and v["draining"] == {"good": False, "sick": True}
    assert v["takeovers"] == 1 and v["counted"] == 1
    status, body, headers = v["replay"]
    assert (status, body, headers["X-Idempotency-Replay"]) == (200, {"tokens": [1, 2, 3]},
                                                               "hit")


def test_takeovers_accumulate_across_successors(tmp_path):
    seen = {}
    for pkg in BOTH:
        root = str(tmp_path / pkg.name)
        pkg.Router([pkg.Replica("r0", "http://127.0.0.1:9")], probe_interval=60.0,
                   journal=root).journal.close()
        counts = []
        for _ in range(2):
            r = pkg.Router([], probe_interval=60.0, journal=root)
            counts.append(r.healthz()["takeovers"])
            r.journal.close()
        seen[pkg.name] = counts
    assert seen["port"] == seen["reference"] == [1, 2]


def test_the_autoscalers_cooldown_clock_survives_a_takeover(tmp_path):
    seen = {}
    for pkg in BOTH:
        root = str(tmp_path / pkg.name)
        j1 = JOURNALS[pkg.name].Journal(root)
        j1.append("autoscale", band=[1, 3], last_action_wall=time.time() - 5.0,
                  up_streak=0, down_streak=2)
        j1.close()
        j2 = JOURNALS[pkg.name].Journal(root)
        asc = pkg.autoscaler.Autoscaler(
            pkg.Router([], probe_interval=60.0), spawn_fn=lambda i, tp: None,
            stop_fn=lambda r: None, min_replicas=1, max_replicas=3, interval=999.0,
            tp_max=1, devices_total=1, drain_grace=1.0, journal=j2)
        seen[pkg.name] = (round(time.monotonic() - asc._last_action_t),
                          asc._down_streak, asc._up_streak)
        j2.close()
    assert seen["port"] == seen["reference"]
    assert 4 <= seen["port"][0] <= 7 and seen["port"][1:] == (2, 0)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_the_standby_takes_over_after_one_full_timeout_on_its_own_clock(tmp_path,
                                                                         writer):
    """Either package's heartbeat writer; the port's standby watches it."""
    j_root, hb_root = str(tmp_path / "j"), str(tmp_path / "hb")
    seed = tjournal.Journal(j_root)
    seed.append("replica", op="register", rid="r0", url="http://127.0.0.1:9")
    seed.close()

    class _Dummy:
        def __init__(self, journal):
            self.journal = journal

        def start(self):
            return self

    hb = jhb if writer == "reference" else thb
    beat = hb.HeartbeatWriter(hb_root, rank=0, interval=0.0)
    standby = PORT.router.RouterStandby(j_root, hb_root, timeout=0.4,
                                        poll_interval=0.02, make_router=_Dummy)
    try:
        assert standby.primary_alive()  # the first observation arms the timer
        for _ in range(3):
            time.sleep(0.15)
            beat.beat()
            assert standby.primary_alive()
        beat.stop()  # the seq stops advancing
        t0 = time.monotonic()
        assert standby.wait_for_death(timeout=5.0)
        assert time.monotonic() - t0 >= 0.3
        successor = standby.takeover()
        assert standby.router is successor and successor.journal.resumed
        assert "r0" in successor.journal.state_snapshot()["replicas"]
        successor.journal.close()
    finally:
        standby.stop()
        beat.stop()


def test_router_crash_then_standby_takeover_replays_from_the_journal(
        tmp_path, port_fleet, ref_generate):
    urls, admitted = port_fleet
    j_root, hb_root = str(tmp_path / "journal"), str(tmp_path / "hb")
    primary = PORT.Router([PORT.Replica("a", urls[0]), PORT.Replica("b", urls[1])],
                          probe_interval=0.1, retry_backoff=0.02, journal=j_root,
                          heartbeat=hb_root).start()
    standby = PORT.router.RouterStandby(j_root, hb_root, timeout=0.4, poll_interval=0.02,
                                        router_kwargs={"probe_interval": 0.1})
    successor = None
    try:
        p = _prompt(6, seed=3)
        payload = {"input_ids": p.tolist(), "max_new_tokens": 4}
        s1, b1, _ = primary.handle_generate(dict(payload), idem_key="ha-1")
        assert s1 == 200 and b1["tokens"] == ref_generate(p, 4)
        assert standby.primary_alive()
        PORT.inj.arm("router.crash:1")
        deadline = time.monotonic() + 10
        while PORT.prof.router_summary()["crashes"] == 0 and time.monotonic() < deadline:
            time.sleep(0.02)
        with pytest.raises(PORT.router.RouterCrashed):
            primary.handle_generate(dict(payload), idem_key="ha-2")
        assert standby.wait_for_death(timeout=10.0)
        t0 = time.monotonic()
        successor = standby.takeover()
        takeover_s = time.monotonic() - t0
        before = len(admitted)
        s2, b2, h2 = successor.handle_generate(dict(payload), idem_key="ha-1")
        assert (s2, json.dumps(b2), h2["X-Idempotency-Replay"]) == (
            200, json.dumps(b1), "hit")
        assert len(admitted) == before  # replayed from the journal, not generated
        q = _prompt(7, seed=8)
        s3, b3, _ = successor.handle_generate({"input_ids": q.tolist(),
                                               "max_new_tokens": 5}, idem_key="ha-2")
        assert s3 == 200 and b3["tokens"] == ref_generate(q, 5)
        h = successor.healthz()
        assert h["takeovers"] == 1 and h["ready_replicas"] == 2 and takeover_s < 5.0
        assert PORT.prof.router_summary()["crashes"] == 1
        assert list((tmp_path / "flightrec").glob("flight-*router-crash*.jsonl"))
    finally:
        standby.stop()
        primary.stop()
        if successor is not None:
            successor.stop()
