"""Disaggregated pairs, session pins and adapter-aware picks through the
port's router, against the JAX package's, on the CPU.

- `pick_pair()` picks the same (prefill, decode) pair as the reference on
  the same snapshots, with and without exclusions, and both raise
  NoDecodeCapacity alike; `pick()` skips page-starved replicas and
  prefers adapter-resident ones alike; a fleet whose decode workers are
  all starved answers the reference's typed 503.
- Both routers drive the same scripted prefill and decode replicas
  through the three hops and the one-token fast path, and through `disagg.prefill.crash`-style drops,
  `disagg.handoff.drop` and a dead decode worker: the same hop calls, the
  same answers and the same `paddle_disagg_*` router counters, every
  request resolved once.
- Over the port's prefill and decode servers (tiny Llamas in float32 and
  over int8 pages), the pipeline gives the reference engine's tokens, and
  each drill resolves every request once with those tokens.
- Session pins over a four-turn chat and the repin after the pinned
  replica dies count the same `paddle_session_pin_hits_total` /
  `_repins_total` as the reference; over port replicas every turn gives
  the reference engine's tokens for the whole conversation.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import metrics as tmetrics
from torch_fleet_fakes import BOTH, PORT, FakeReplica, gen_tokens, reset_counters, \
    stop_all, strip_trace

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16, seed=0,
              paged=True, page_size=8)
DISAGG = ("pair_picks", "handoff_retries", "reserve_fails", "no_decode_capacity")


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    yield
    reset_counters()
    tcore.set_flags({"FLAGS_serve_reserve_ttl_s": 30.0})


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
    """The reference colocated engine's greedy tokens, per KV precision."""
    engines = {}

    def gen(p, n, kv_quant="none"):
        if kv_quant not in engines:
            engines[kv_quant] = JaxEngine(models[0], kv_quant=kv_quant, **ENGINE)
        return engines[kv_quant].generate(p, max_new_tokens=n).tolist()

    return gen


def _serve(tm, role="colocated", **kw):
    eng = ContinuousBatchingEngine(tm, device="cpu", role=role, **{**ENGINE, **kw})
    eng.warmup()
    srv = tinference.serve(eng, port=0, block=False, supervise=False,
                           handle_signals=False)
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def pairs(models):
    """Warmed port prefill and decode servers, in float32 and over int8."""
    out = {q: {role: _serve(models[1], role, kv_quant=q) for role in ("prefill", "decode")}
           for q in ("none", "int8")}
    yield out
    for pair in out.values():
        for srv, _ in pair.values():
            srv.stop()
            srv.server_close()


def _disagg(pkg):
    g = pkg.prof.disagg_summary()
    return {k: g.get(k, 0) for k in DISAGG}


def _fake_rep(pkg, rid, role="colocated", page_free=0.5, queue=0, **h):
    rep = pkg.Replica(rid, f"http://127.0.0.1:1/{rid}")
    rep._note_healthz({"status": "ready", "role": role, "page_free_frac": page_free,
                       "queue_depth": queue, "active_slots": 0,
                       "drain_estimate_s": 0.0, "decode_ewma_ms": 1.0, **h})
    return rep


PAIR_FLEETS = {
    "compute_vs_pages": [("p0", "prefill", 0.5, 6, 0.0), ("p1", "prefill", 0.5, 0, 0.0),
                         ("d0", "decode", 0.1, 0, 0.0), ("d1", "decode", 0.9, 4, 0.0)],
    "drain_breaks_ties": [("p0", "prefill", 0.5, 0, 2.0), ("p1", "prefill", 0.5, 0, 0.5),
                          ("d0", "decode", 0.5, 0, 3.0), ("d1", "decode", 0.5, 0, 1.0)],
    "one_side_missing": [("d0", "decode", 0.5, 0, 0.0), ("c0", "colocated", 0.5, 0, 0.0)],
    "starved_decode": [("p0", "prefill", 0.5, 0, 0.0), ("d0", "decode", 0.0, 0, 0.0),
                       ("d1", "decode", 0.2, 7, 0.0)],
}


def _pair(router, **kw):
    """The picked pair's ids, or the name of the error pick_pair raised."""
    try:
        return tuple(r.rid if r is not None else None for r in router.pick_pair(**kw))
    except Exception as e:
        return type(e).__name__


@pytest.mark.parametrize("fleet", list(PAIR_FLEETS))
def test_pick_pair_picks_the_references_pair(fleet):
    seen = {}
    for pkg in BOTH:
        reps = [_fake_rep(pkg, rid, role, pf, q, drain_estimate_s=d)
                for rid, role, pf, q, d in PAIR_FLEETS[fleet]]
        router = pkg.Router(reps, probe_interval=3600)
        seen[pkg.name] = [_pair(router), _pair(router, exclude_prefill=("p1",),
                                               exclude_decode=("d1",)),
                          router.pick().rid, _disagg(pkg)]
    assert seen["port"] == seen["reference"]


def test_no_decode_capacity_is_the_references_typed_503():
    seen = {}
    for pkg in BOTH:
        reps = [_fake_rep(pkg, "p0", "prefill"), _fake_rep(pkg, "d0", "decode", 0.0),
                _fake_rep(pkg, "d1", "decode", 0.0)]
        router = pkg.Router(reps, probe_interval=3600)
        with pytest.raises(pkg.router.NoDecodeCapacity) as ei:
            router.pick_pair()
        err = (ei.value.status, ei.value.retriable, ei.value.retry_after_s)
        status, body, headers = router.handle_generate({"input_ids": [1, 2, 3],
                                                        "max_new_tokens": 4})
        seen[pkg.name] = (err, status, strip_trace(body), headers.get("Retry-After"),
                          _disagg(pkg))
    assert seen["port"] == seen["reference"]
    assert seen["port"][1] == 503 and seen["port"][2]["type"] == "NoDecodeCapacity"
    assert seen["port"][2]["retriable"] is True and seen["port"][4]["no_decode_capacity"] == 2


def test_pick_prefers_adapter_resident_and_skips_starved_replicas():
    seen = {}
    for pkg in BOTH:
        cold = _fake_rep(pkg, "cold", page_free=0.5)
        warm = _fake_rep(pkg, "warm", page_free=0.5, queue=3,
                         lora={"adapters": ["a1", "a2"]})
        starved = _fake_rep(pkg, "starved", page_free=0.0)
        router = pkg.Router([starved, cold, warm], probe_interval=3600)
        solo = pkg.Router([_fake_rep(pkg, "only", page_free=0.0)], probe_interval=3600)
        seen[pkg.name] = (router.pick().rid, router.pick(adapter="a1").rid,
                          router.pick(adapter="zz").rid,
                          router.pick(exclude=("cold", "warm")).rid, solo.pick().rid,
                          warm.snapshot()["lora_adapters"])
    assert seen["port"] == seen["reference"]
    assert seen["port"] == ("cold", "warm", "cold", "starved", "only", ("a1", "a2"))


def _fake_pipeline(pkg, arm=None, fail=None, dead_decode=False):
    """The hops on scripted replicas: a prefill worker and two decode
    workers (the first dies after its probe when `dead_decode`).  Returns
    the answers, hop calls per replica and counters."""
    pre = FakeReplica(role="prefill")
    decs = [FakeReplica(role="decode", page_free_frac=0.9),
            FakeReplica(role="decode", page_free_frac=0.5)]
    fleet = [pre, *decs]
    try:
        router = pkg.Router([f.url for f in fleet], probe_interval=3600,
                            retry_backoff=0.01)
        router.probe_once()
        if dead_decode:
            decs[0].stop()
        for path, n in (fail or {}).items():
            pre.fail[path] = n
        if arm:
            pkg.inj.arm(arm)
        answers = [router.handle_generate({"input_ids": list(range(1, 6 + i)),
                                           "max_new_tokens": 4}) for i in range(3)]
        answers.append(router.handle_generate({"input_ids": [9, 8, 7],
                                               "max_new_tokens": 1}))
        router.stop()
        calls = [dict(f.counts) for f in fleet]
        forwarded = [sorted(k for k in body if k in ("handoff", "reservation"))
                     for f in fleet for path, body, _ in f.calls if path == "/generate"]
    finally:
        stop_all(fleet)
    g = pkg.prof.router_summary()
    return ([(s, b) for s, b, _ in answers], calls, forwarded, _disagg(pkg),
            {k: g[k] for k in ("retries", "breaker_trips")},
            [r.breaker for r in router.replicas])


@pytest.mark.parametrize("drill", ["plain", "prefill_dropped", "handoff_dropped",
                                   "dead_decode"])
def test_the_three_hops_on_scripted_replicas_match_the_reference(drill):
    kw = {"plain": {}, "prefill_dropped": {"fail": {"/prefill": 1}},
          "handoff_dropped": {"arm": "disagg.handoff.drop:1"},
          "dead_decode": {"dead_decode": True}}[drill]
    seen = {pkg.name: _fake_pipeline(pkg, **kw) for pkg in BOTH}
    assert seen["port"] == seen["reference"]
    answers = seen["port"][0]
    # every request resolved once, with the replicas' tokens
    assert [s for s, _ in answers] == [200] * 4
    assert [b["tokens"] for _, b in answers[:3]] == [
        gen_tokens(list(range(1, 6 + i)), 4) for i in range(3)]
    assert answers[3][1]["tokens"] == gen_tokens([9, 8, 7], 1)  # the fast path
    counters = seen["port"][3]
    assert counters["pair_picks"] >= 4
    if drill != "plain":
        assert counters["handoff_retries"] >= 1


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_the_pipeline_through_the_router_gives_the_reference_engines_tokens(
        pairs, ref_generate, kv_quant):
    pair = pairs[kv_quant]
    dec_engine = pair["decode"][0].engine
    router = PORT.Router([pair["prefill"][1], pair["decode"][1]], probe_interval=3600,
                         retry_backoff=0.01)
    router.probe_once()
    assert router.healthz()["roles"] == {"prefill": 1, "decode": 1}
    for i in range(3):
        p = _prompt(6 + 2 * i, seed=60 + i)
        status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                  "max_new_tokens": 5})
        assert status == 200, body
        assert body["tokens"] == ref_generate(p, 5, kv_quant)
    g = PORT.prof.disagg_summary()
    assert (g["pair_picks"], g["exports"], g["imports"], g["handoff_retries"]) == (3, 3, 3, 0)
    assert dec_engine.healthz()["reserved_pages"] == 0
    # a batched body rides the colocated path (any role answers /generate)
    p = _prompt(6, seed=70)
    status, body, _ = router.handle_generate({"input_ids": [p.tolist()],
                                              "max_new_tokens": 4})
    assert status == 200 and body["tokens"][0] == ref_generate(p, 4, kv_quant)
    assert PORT.prof.disagg_summary()["pair_picks"] == 3
    router.stop()


@pytest.mark.parametrize("drill", ["disagg.prefill.crash:1", "disagg.handoff.drop:1",
                                   "dead_decode"])
def test_each_drill_resolves_every_request_once(pairs, models, ref_generate, drill):
    pair = pairs["none"]
    urls = [pair["prefill"][1], pair["decode"][1]]
    victim = None
    if drill == "dead_decode":
        victim, url = _serve(models[1], "decode")
        urls.insert(1, url)
    else:
        tcore.set_flags({"FLAGS_serve_reserve_ttl_s": 0.2})
    router = PORT.Router(urls, probe_interval=3600, retry_backoff=0.01)
    router.probe_once()
    if victim is not None:
        victim.stop()  # dies after the probe read it ready
    else:
        PORT.inj.arm(drill)
    answers = []
    for i in range(2):
        p = _prompt(7 + i, seed=90 + i)
        status, body, _ = router.handle_generate({"input_ids": p.tolist(),
                                                  "max_new_tokens": 5})
        answers.append((status, body.get("tokens"), ref_generate(p, 5)))
    router.stop()
    assert all(s == 200 and got == want for s, got, want in answers), answers
    g = PORT.prof.disagg_summary()
    assert g["handoff_retries"] >= 1 and g["imports"] == 2
    if drill == "disagg.handoff.drop:1":
        assert g["exports"] == 3  # the lost payload was exported, then again
        assert all(r.breaker == "closed" for r in router.replicas)
    if drill == "dead_decode":
        assert g["reserve_fails"] >= 1


def _session_drill(pkg, fleet_urls, stop_first):
    """A four-turn chat pinned to its first replica, that replica dying
    before the fourth turn (`stop_first()`), then a fifth turn."""
    router = pkg.Router(fleet_urls, probe_interval=3600, retry_backoff=0.01)
    router.probe_once()
    convo, answers = [], []
    for turn in range(5):
        if turn == 3:
            stop_first()
        convo = convo + list(_prompt(4, seed=200 + turn))
        status, body, _ = router.handle_generate({"input_ids": [int(x) for x in convo],
                                                  "max_new_tokens": 3,
                                                  "session_id": "chat-1"})
        answers.append((status, body.get("tokens")))
        convo = body["tokens"]
    h = router.healthz()
    router.stop()
    g = pkg.prof.router_summary()
    return answers, (g["session_pin_hits"], g["session_repins"]), (
        h["session_pins"], h["session_pins_by_replica"])


def _session_metrics(mod):
    lines = [line for line in mod.render().splitlines()
             if line.startswith(("paddle_session_pin_hits_total",
                                 "paddle_session_repins_total"))]
    return lines


def test_session_pins_and_repins_count_as_the_reference():
    seen = {}
    for pkg in BOTH:
        fleet = [FakeReplica(), FakeReplica()]
        try:
            seen[pkg.name] = _session_drill(pkg, [f.url for f in fleet], fleet[0].stop)
            seen[pkg.name] += (fleet[1].counts.get("/generate"),)
        finally:
            stop_all(fleet)
    seen["metrics"] = (_session_metrics(tmetrics), _session_metrics(jmetrics))
    assert seen["port"] == seen["reference"]
    answers, counts, pins, survivor_turns = seen["port"]
    assert [s for s, _ in answers] == [200] * 5
    assert counts == (4, 1)  # turns 2-4 and 5 hit a pin, turn 4 broke one
    assert pins == (1, {"r1": 1}) and survivor_turns == 2
    assert seen["metrics"][0] == seen["metrics"][1]
    assert seen["metrics"][0] == ["paddle_session_pin_hits_total 4",
                                  "paddle_session_repins_total 1"]


def test_session_turns_over_port_replicas_give_the_references_tokens(models,
                                                                     ref_generate):
    servers = [_serve(models[1]) for _ in range(2)]
    try:
        answers, counts, _ = _session_drill(PORT, [url for _, url in servers],
                                            servers[0][0].stop)
    finally:
        for srv, _ in servers:
            srv.stop()
            srv.server_close()
    convo = []
    for turn, (status, tokens) in enumerate(answers):
        convo = convo + list(_prompt(4, seed=200 + turn))
        assert status == 200 and tokens == ref_generate(np.array(convo, np.int32), 3)
        convo = tokens
    assert counts == (4, 1)
