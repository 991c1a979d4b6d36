"""The port's observability over HTTP, beside the reference's `serve()` on
the CPU: tiny Llamas on shared weights (`load_reference_state`) behind
both servers, FLAGS_trace on in both packages.

- the span tree of a traced request, once it has settled: one
  `serve.handle` root under the client's span, the engine's stage spans
  under it, the same names in the same order as the reference's (also
  when an engine span lands after `serve.handle`);
- `X-Trace-Id` echoed, or minted when the client sent none; `trace_id` in
  a 504 body; `GET /trace/<unknown>` answers 404;
- `GET /metrics`: the reference's name set, and equal request and token
  counts after the same traffic, with the bound address as the replica
  label;
- flight dumps on `EngineSupervisor.restart`, on an exhausted restart
  budget and on the drain (while it drains, /metrics and /trace answer
  200 and /generate 503);
- `serve.handle` noted in the flight ring (waited for, bounded: it is
  recorded after the reply's bytes are out), the `engine.*` spans not;
- trace on against trace off on one engine: the same tokens, the same
  `compile_counts()`, the same host fetches;
- a traced engine whose watchdog tripped is freed once dropped.
"""

import gc
import json
import re
import time
import urllib.error
import urllib.request
import weakref

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import profiler as jprof
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.obs import trace as jtrace
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.fault import EngineSupervisor
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.fault import watchdog as twd
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import flight as tflight
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import trace as ttrace

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, prefix_cache=False)
WAIT_S = 30
QUIET_S = 0.5  # no new span for this long: a trace has settled
CLIENT_SPAN = "c" * 16


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32).tolist()


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(2468)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture(autouse=True)
def _traced():
    for set_flags in (paddle.set_flags, tcore.set_flags):
        set_flags({"FLAGS_trace": True})
    yield
    for set_flags in (paddle.set_flags, tcore.set_flags):
        set_flags({"FLAGS_trace": False, "FLAGS_serve_step_timeout_sec": 0.0,
                   "FLAGS_fault_hang_sec": 3600.0})
    tinj.disarm()


def _serve(engine, module):
    return module.serve(engine, port=0, block=False, supervise=False,
                        handle_signals=False)


@pytest.fixture(scope="module")
def pair(models):
    """(reference server, port server), warmed engines behind each."""
    jm, tm = models
    jeng, teng = JaxEngine(jm, **ENGINE), ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    jeng.warmup()
    teng.warmup()
    servers = (_serve(jeng, jinference), _serve(teng, tinference))
    yield servers
    jeng.stop()
    servers[0].shutdown()
    servers[0].server_close()
    servers[1].stop()


def _url(server, path):
    return f"http://127.0.0.1:{server.server_address[1]}{path}"


def _call(server, path, body=None, headers=None):
    """(status, headers, decoded body: JSON, or text for /metrics)."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(_url(server, path), data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, hdrs, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    return status, hdrs, (text if path == "/metrics" else json.loads(text))


def _both(pair, path, body=None, headers=None):
    return tuple(_call(s, path, body, headers) for s in pair)


def _names(node):
    return (node["name"], [_names(c) for c in node["children"]])


def _span_count(nodes):
    return sum(1 + _span_count(n["children"]) for n in nodes)


def _tree_of(server, tid):
    """The span tree once it has settled: serve.handle is in it and no new
    span came for QUIET_S.  serve.handle is recorded after the reply's
    bytes are out, and both engines record some spans after they resolved
    the request (engine.prefill after the first token is emitted, which
    ends a one-token request; engine.decode when an epoch closes;
    engine.fetch in a flush), so either may land after serve.handle.
    Bounded by WAIT_S."""
    t_end = time.monotonic() + WAIT_S
    seen, t_seen = None, None
    while True:
        status, _, doc = _call(server, f"/trace/{tid}")
        if status == 200 and any(r["name"] == "serve.handle" for r in doc["spans"]):
            n = _span_count(doc["spans"])
            if n != seen:
                seen, t_seen = n, time.monotonic()
            elif time.monotonic() - t_seen >= QUIET_S:
                return doc
        assert time.monotonic() < t_end, f"span tree of {tid} did not settle"
        time.sleep(0.01)


@pytest.mark.parametrize("prompt_len,new", [(6, 3), (12, 5), (5, 1)],
                         ids=["short", "long", "one-token"])
def test_span_tree_names_match_reference(pair, prompt_len, new):
    tids = [ttrace.new_trace_id() for _ in pair]
    docs = []
    for server, tid in zip(pair, tids):
        status, hdrs, body = _call(server, "/generate",
                                   {"input_ids": _prompt(prompt_len, prompt_len),
                                    "max_new_tokens": new},
                                   {"X-Trace-Id": tid, "X-Parent-Span": CLIENT_SPAN})
        assert status == 200 and hdrs["X-Trace-Id"] == tid
        docs.append(_tree_of(server, tid))
    ref, port = docs
    assert [_names(r) for r in port["spans"]] == [_names(r) for r in ref["spans"]]
    (handle,) = port["spans"]
    assert handle["parent_id"] == CLIENT_SPAN and handle["trace_id"] == tids[1]
    names = [c["name"] for c in handle["children"]]
    assert names[:2] == ["engine.queue", "engine.prefill"]
    if new > 2:
        assert "engine.decode" in names and "engine.fetch" in names
    for child in handle["children"]:
        assert child["parent_id"] == handle["span_id"]
        assert all(isinstance(v, (str, int, float)) for v in child.get("attrs", {}).values())


def test_span_tree_settles_after_a_late_engine_span(pair, monkeypatch):
    """The port's engine.prefill span held back past serve.handle (as a
    descheduled scheduler thread holds it under load): the settled trees
    still carry the same names as the reference's."""
    late = ContinuousBatchingEngine._obs_prefilled

    def held_back(self, *args):
        time.sleep(0.2)
        late(self, *args)

    monkeypatch.setattr(ContinuousBatchingEngine, "_obs_prefilled", held_back)
    tids = [ttrace.new_trace_id() for _ in pair]
    docs = []
    for server, tid in zip(pair, tids):
        status, _, _ = _call(server, "/generate",
                             {"input_ids": _prompt(5, 5), "max_new_tokens": 1},
                             {"X-Trace-Id": tid, "X-Parent-Span": CLIENT_SPAN})
        assert status == 200
        docs.append(_tree_of(server, tid))
    ref, port = docs
    assert [_names(r) for r in port["spans"]] == [_names(r) for r in ref["spans"]]
    (handle,) = port["spans"]
    assert [c["name"] for c in handle["children"]] == ["engine.queue", "engine.prefill"]


def test_batched_rows_share_the_trace_context(pair):
    tids = [ttrace.new_trace_id() for _ in pair]
    counts = []
    for server, tid in zip(pair, tids):
        status, _, _ = _call(server, "/generate",
                             {"input_ids": [_prompt(5, 1), _prompt(9, 2)],
                              "max_new_tokens": 4}, {"X-Trace-Id": tid})
        assert status == 200
        (handle,) = _tree_of(server, tid)["spans"]
        names = [c["name"] for c in handle["children"]]
        counts.append(sorted(names))
        assert len({c["attrs"]["req"] for c in handle["children"]}) == 2
    assert counts[1] == counts[0]


def test_trace_id_echoed_or_minted(pair):
    minted = []
    for server in pair:
        status, hdrs, _ = _call(server, "/generate",
                                {"input_ids": _prompt(4), "max_new_tokens": 1})
        assert status == 200
        minted.append(hdrs["X-Trace-Id"])
    assert all(re.fullmatch("[0-9a-f]{16}", t) for t in minted)
    assert minted[0] != minted[1]


def test_error_body_carries_the_trace_id(pair):
    tid = jtrace.new_trace_id()
    ref, port = _both(pair, "/generate", {"input_ids": [1, 2, 3]},
                      {"X-Trace-Id": tid, "X-Deadline-Ms": "0"})
    assert port[0] == ref[0] == 504
    assert port[2] == ref[2] and port[2]["trace_id"] == tid
    assert port[1]["X-Trace-Id"] == tid
    # without a client id the server mints one, in the header and the body
    status, hdrs, body = _call(pair[1], "/generate", {"input_ids": [1, 2, 3]},
                               {"X-Deadline-Ms": "0"})
    assert status == 504 and body["trace_id"] == hdrs["X-Trace-Id"] != tid
    assert re.fullmatch("[0-9a-f]{16}", body["trace_id"])


def test_unknown_trace_answers_404(pair):
    ref, port = _both(pair, "/trace/deadbeefdeadbeef")
    assert port[0] == ref[0] == 404
    assert port[2] == ref[2]


def _samples(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        key, val = line.rsplit(" ", 1)
        out[key] = float(val)  # every sample parses
    return out


def test_metrics_names_and_counts_match_reference(pair):
    jprof.reset()
    tprof.reset()
    for n, new in ((6, 3), (9, 4), (5, 2)):
        ref, port = _both(pair, "/generate", {"input_ids": _prompt(n, n),
                                              "max_new_tokens": new})
        assert ref[0] == port[0] == 200 and port[2] == ref[2]
    ref, port = _both(pair, "/metrics")
    assert port[0] == ref[0] == 200
    assert port[1]["Content-Type"] == ref[1]["Content-Type"] == tmetrics.CONTENT_TYPE
    names = [[l.split()[2] for l in d[2].splitlines() if l.startswith("# TYPE")]
             for d in (ref, port)]
    assert names[1] == names[0] == list(tmetrics.METRIC_NAMES)
    rs, ps = _samples(ref[2]), _samples(port[2])
    label = f'{{replica="127.0.0.1:{pair[1].server_address[1]}"}}'
    jlabel = f'{{replica="127.0.0.1:{pair[0].server_address[1]}"}}'
    for name in ("paddle_serving_requests_total", "paddle_serving_tokens_total"):
        assert ps[name + label] == rs[name + jlabel]
    assert ps["paddle_serving_requests_total" + label] == 3
    assert ps["paddle_serving_tokens_total" + label] == 3 + 4 + 2
    # zero-valued counters are exported, never left out
    assert ps["paddle_router_breaker_trips_total" + label] == 0
    assert ps["paddle_paging_pages_total" + label] > 0
    assert ps["paddle_sanitizer_host_syncs_total" + label] > 0


def _dumps(path):
    out = {}
    for f in sorted(path.glob("flight-*.jsonl")):
        lines = [json.loads(l) for l in f.read_text().splitlines()]
        out[lines[0]["reason"]] = lines
    return out


def test_supervisor_restarts_write_flight_dumps(models, tmp_path, monkeypatch):
    """A restart dumps `engine-restart-{n}` before it clears the engine; an
    exhausted budget dumps `engine-restart-budget-exhausted`; the reference's
    supervisor writes the same reasons and header keys."""
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
    jm, tm = models
    headers = {}
    for name, eng, sup_cls in (
            ("port", ContinuousBatchingEngine(tm, device="cpu", **ENGINE),
             EngineSupervisor),
            ("reference", JaxEngine(jm, **ENGINE), None)):
        if sup_cls is None:
            from paddle_tpu.fault import EngineSupervisor as sup_cls
        d = tmp_path / name
        monkeypatch.setenv("PADDLE_OBS_DIR", str(d))
        eng.start()
        try:
            sup = sup_cls(eng, max_restarts=1, backoff=0.0)
            assert sup.restart("unit drill") is True
            assert sup.restart("unit drill") is False  # the budget is spent
        finally:
            eng.stop()
        dumps = _dumps(d)
        assert list(dumps) == ["engine-restart-1", "engine-restart-budget-exhausted"]
        headers[name] = {r: sorted(lines[0]) for r, lines in dumps.items()}
    assert headers["port"] == headers["reference"]
    events = _dumps(tmp_path / "port")["engine-restart-budget-exhausted"][1:]
    assert any(e["kind"] == "engine" and "restart #1" in e["detail"] for e in events)


def test_serve_handle_noted_in_flight_ring_engine_spans_not(pair):
    tflight.reset()
    status, hdrs, _ = _call(pair[1], "/generate", {"input_ids": _prompt(6),
                                                   "max_new_tokens": 3})
    assert status == 200
    tid = hdrs["X-Trace-Id"]
    t_end = time.monotonic() + WAIT_S
    while not any(e["kind"] == "span" and e.get("trace_id") == tid
                  for e in tflight.events()):
        assert time.monotonic() < t_end, "serve.handle never reached the ring"
        time.sleep(0.01)
    spans = [e for e in tflight.events() if e["kind"] == "span"]
    assert [e["detail"] for e in spans if e["trace_id"] == tid] == ["serve.handle"]
    assert not any(e["detail"].startswith("engine.") for e in spans)


def _traffic(server, traced):
    out = []
    for n, new in ((6, 5), (11, 4), (7, 6), (9, 3)):
        headers = ({"X-Trace-Id": ttrace.new_trace_id(), "X-Parent-Span": CLIENT_SPAN}
                   if traced else {})
        status, _, body = _call(server, "/generate",
                                {"input_ids": _prompt(n, 100 + n),
                                 "max_new_tokens": new}, headers)
        assert status == 200
        out.append(body["tokens"])
    return out


def test_trace_on_keeps_tokens_compiles_and_host_fetches(pair):
    """Tracing is host bookkeeping around the dispatches: the same tokens,
    no new trace of a step, and the same number of token fetches."""
    eng = pair[1].engine
    runs = {}
    for traced in (False, True):
        tcore.set_flags({"FLAGS_trace": traced})
        tprof.reset_serving()
        compiles = eng.compile_counts()
        recorded = ttrace.stats()["spans_recorded"]
        tokens = _traffic(pair[1], traced)
        eng.stop()  # the last step records after its flush answered the POST
        summary = tprof.serving_summary()
        eng.start()
        runs[traced] = (tokens, summary["host_fetches"], summary["decode_steps"])
        assert eng.compile_counts() == compiles
        assert (ttrace.stats()["spans_recorded"] > recorded) is traced
    assert runs[True] == runs[False]


def test_metrics_and_trace_answer_while_draining(models, tmp_path, monkeypatch):
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    server = tinference.serve(eng, port=0, block=False, handle_signals=False)
    try:
        status, hdrs, _ = _call(server, "/generate", {"input_ids": _prompt(5),
                                                      "max_new_tokens": 2})
        assert status == 200
        tid = hdrs["X-Trace-Id"]
        _tree_of(server, tid)
        eng.submit(_prompt(6), max_new_tokens=40)  # keeps the drain open
        worker = server.drain(grace=5.0)
        assert _call(server, "/metrics")[0] == 200
        assert _call(server, f"/trace/{tid}")[0] == 200
        status, _, body = _call(server, "/generate", {"input_ids": _prompt(5)})
        assert status == 503 and body["type"] == "Draining" and body["trace_id"]
        worker.join(WAIT_S)
        assert not worker.is_alive()
    finally:
        server.stop()
    assert "serve-drain" in _dumps(tmp_path)


def test_metrics_continue_across_a_supervised_restart(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    server = tinference.serve(eng, port=0, block=False, handle_signals=False)
    label = f'{{replica="127.0.0.1:{server.server_address[1]}"}}'
    try:
        tprof.reset()
        assert _call(server, "/generate", {"input_ids": _prompt(5), "max_new_tokens": 2})[0] == 200
        assert server.supervisor.restart("unit drill") is True
        assert _call(server, "/generate", {"input_ids": _prompt(7), "max_new_tokens": 2})[0] == 200
        status, _, text = _call(server, "/metrics")
        samples = _samples(text)
    finally:
        server.stop()
    assert status == 200
    assert samples["paddle_serving_requests_total" + label] == 2
    restarts = 'paddle_serving_faults_total{kind="restarts",replica="127.0.0.1:%d"}' % (
        server.server_address[1])
    assert samples[restarts] == 1


def test_a_traced_engine_whose_watchdog_tripped_is_freed(models, tmp_path, monkeypatch):
    """Spans, the epoch's bookkeeping, flight events and the trip's dump
    hold strings and numbers only: the engine goes once dropped."""
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    tcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.05, "FLAGS_fault_hang_sec": 0.3})
    tinj.arm("serve.prefill.hang")
    tid = ttrace.new_trace_id()
    reqs = [eng.submit(_prompt(n), max_new_tokens=4, trace=(tid, CLIENT_SPAN))
            for n in (4, 6)]
    eng.run_until_idle()
    for r in reqs:
        r.wait(WAIT_S)
    assert twd.wait_for_monitor(WAIT_S)
    assert eng._watchdog_trip is not None
    assert {s["name"] for s in ttrace.spans(tid)} >= {
        "engine.queue", "engine.prefill", "engine.decode", "engine.fetch"}
    assert list(tmp_path.glob("flight-*-watchdog-serve.prefill.jsonl"))
    ref = weakref.ref(eng)
    del eng, reqs
    gc.collect()
    assert ref() is None
