"""The port's disaggregated serving over HTTP (`POST /reserve`,
`POST /prefill`, `/generate` with `handoff` and `reservation`) against the
JAX package on the CPU.

- `/reserve`: 200 with `rsv-` ids until stacked holds exhaust the pool,
  then a retriable 503 QueueFull; `/prefill`: the first token of the
  reference engine's tokens, `payload_bytes` > 0, 400 on a batch, and the
  `export: false` fast path (no handoff).
- The three hops by hand, port prefill server -> port decode server, give
  the reference engine's tokens on shared weights; every reservation is
  consumed by its admission.
- `disagg.prefill.crash` closes the /prefill connection with no byte of
  response, and the orphaned reservation lapses at its TTL.
- `/metrics`: the reference's `paddle_disagg_*` names
  (`test_disagg_metrics_exposition`), the engine-side four equal to the
  traffic's counts, the router-side four at 0, under the decode server's
  role label; `/healthz` carries the role and the reserved pages.
- The decode hop's span tree (`engine.import` under `serve.handle`) and the
  `disagg` flight records (reserve, export, reserve_expired) carry the
  reference's names, the same traffic on a reference prefill/decode pair.
- A bad handoff answers 400 HandoffFormatError; a handoff to the prefill
  server the reference's 400 ValueError.
- F14: three servers (a colocated, a prefill and a decode one, as a
  disaggregated deployment starts them) stopped in the order they started
  leave the SIGTERM handler as it was and free their engines.

Tiny Llamas in float32, page_size 8.
"""

import gc
import http.client
import json
import signal
import time
import weakref
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu.obs import flight as jflight
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import flight as tflight
from paddle_tpu_torch.obs import trace as ttrace

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8)
WAIT_S, QUIET_S = 30.0, 0.3


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean():
    profiler.reset_disagg()
    yield
    tinj.disarm()
    for set_flags in (paddle.set_flags, tcore.set_flags):
        set_flags({"FLAGS_trace": False})
    tcore.set_flags({"FLAGS_serve_reserve_ttl_s": 30.0})


@pytest.fixture(scope="module")
def models():
    paddle.seed(51)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture(scope="module")
def ref_tokens(models):
    """The reference colocated engine's greedy tokens, by (prompt, n)."""
    eng = JaxEngine(models[0], **ENGINE)
    return lambda p, n: eng.generate(p, max_new_tokens=n).tolist()


def _serve_port(tm, role, warm=True, **kw):
    eng = ContinuousBatchingEngine(tm, device="cpu", role=role, **{**ENGINE, **kw})
    if warm:
        eng.warmup()
    return tinference.serve(eng, port=0, block=False, supervise=False,
                            handle_signals=False)


@pytest.fixture(scope="module")
def pair(models):
    """Warmed port prefill and decode servers, shared by the module."""
    servers = {role: _serve_port(models[1], role) for role in ("prefill", "decode")}
    yield servers
    for srv in servers.values():
        srv.stop()


@pytest.fixture
def fresh_pair(pair):
    # an earlier test's orphaned reservation must not reach this one's
    # reservation counts
    dec = pair["decode"].engine
    with dec._mu:
        dec._reserved.clear()
        dec._reserved_pages = 0
    return pair


def _call(server, path, body=None, headers=None):
    """(status, headers, decoded body: JSON, or text for /metrics)."""
    url = f"http://127.0.0.1:{server.server_address[1]}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=120) as resp:
            status, hdrs, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, dict(e.headers), e.read()
    text = raw.decode()
    return status, hdrs, (text if path == "/metrics" else json.loads(text))


def _hops(pre, dec, p, n, headers=None):
    """The router's three hops by hand: /reserve on the decode server,
    /prefill on the prefill server, /generate with the handoff and the
    reservation on the decode server.  Returns (the reservation, the
    /prefill answer, the /generate answer)."""
    st, _, rsv = _call(dec, "/reserve", {"prompt_len": int(p.size),
                                         "max_new_tokens": n})
    assert st == 200, rsv
    st, _, pf = _call(pre, "/prefill", {"input_ids": p.tolist()})
    assert st == 200, pf
    st, _, out = _call(dec, "/generate", {
        "input_ids": p.tolist(), "max_new_tokens": n, "handoff": pf["handoff"],
        "reservation": rsv["reservation"]}, headers)
    assert st == 200, out
    return rsv, pf, out


def test_reserve_endpoint(models):
    srv = _serve_port(models[1], "decode", warm=False)
    try:
        st, _, body = _call(srv, "/reserve", {"prompt_len": 8, "max_new_tokens": 8})
        assert st == 200 and body["reservation"].startswith("rsv-")
        assert body["pages"] == 2 and body["ttl_s"] == 30.0
        for _ in range(100):  # stacked holds exhaust the pool
            st, hdrs, body = _call(srv, "/reserve",
                                   {"prompt_len": 56, "max_new_tokens": 8})
            if st != 200:
                break
        assert st == 503 and body["type"] == "QueueFull"
        assert body["retriable"] is True and "Retry-After" in hdrs
        st, _, body = _call(srv, "/reserve", {"max_new_tokens": 8})
        assert st == 400 and body["type"] == "KeyError"
    finally:
        srv.stop()


def test_prefill_endpoint(pair, ref_tokens):
    pre = pair["prefill"]
    p = _prompt(9, seed=3)
    ref = ref_tokens(p, 4)
    st, _, body = _call(pre, "/prefill", {"input_ids": p.tolist()})
    assert st == 200 and body["prompt_len"] == 9
    assert body["first_token"] == ref[9] == body["handoff"]["first_token"]
    hand = body["handoff"]
    assert hand["version"] == 1 and hand["payload_bytes"] == 2 * 2 * 9 * 4 * 16 * 4
    st, _, body = _call(pre, "/prefill", {"input_ids": [p.tolist(), p.tolist()]})
    assert st == 400 and body["type"] == "ValueError"
    st, _, body = _call(pre, "/prefill", {"input_ids": p.tolist(), "export": False})
    assert st == 200 and body == {"first_token": ref[9], "prompt_len": 9,
                                  "handoff": None}
    assert profiler.disagg_summary()["exports"] == 1


def test_three_hops_equal_the_reference_engine(fresh_pair, ref_tokens):
    pre, dec = fresh_pair["prefill"], fresh_pair["decode"]
    warm = {role: s.engine.compile_counts() for role, s in fresh_pair.items()}
    wire, pages = 0, 0
    for i in range(3):
        p = _prompt(6 + 5 * i, seed=60 + i)
        rsv, pf, out = _hops(pre, dec, p, 5)
        assert out["tokens"] == ref_tokens(p, 5)
        assert dec.engine.healthz()["reserved_pages"] == 0
        wire += pf["handoff"]["payload_bytes"]
        pages += -(-p.size // 8)
    assert profiler.disagg_summary() == {
        "exports": 3, "imports": 3, "import_pages": pages, "handoff_bytes": wire,
        "pair_picks": 0, "handoff_retries": 0, "reserve_fails": 0,
        "no_decode_capacity": 0}
    assert {role: s.engine.compile_counts() for role, s in fresh_pair.items()} == warm


def test_prefill_crash_drops_the_connection_and_the_ttl_reclaims(fresh_pair,
                                                                ref_tokens):
    pre, dec = fresh_pair["prefill"], fresh_pair["decode"]
    p = _prompt(10, seed=70)
    st, _, orphan = _call(dec, "/reserve", {"prompt_len": 10, "max_new_tokens": 4,
                                            "ttl_s": 0.2})
    assert st == 200 and dec.engine.healthz()["reserved_pages"] == orphan["pages"]
    tinj.arm("disagg.prefill.crash:1")
    conn = http.client.HTTPConnection("127.0.0.1", pre.server_address[1], timeout=60)
    try:
        conn.request("POST", "/prefill", json.dumps({"input_ids": p.tolist()}),
                     {"Content-Type": "application/json"})
        with pytest.raises(http.client.RemoteDisconnected):
            conn.getresponse()  # the connection closed before a status line
    finally:
        conn.close()
    assert tinj.hits("disagg.prefill.crash") == 1
    time.sleep(0.3)
    rsv, _, out = _hops(pre, dec, p, 4)  # its /reserve purges the orphan
    assert out["tokens"] == ref_tokens(p, 4)
    assert dec.engine.healthz()["reserved_pages"] == 0
    expired = [e for e in tflight.events()
               if e["kind"] == "disagg" and e["detail"] == "reserve_expired"]
    assert [e["rid"] for e in expired][-1:] == [orphan["reservation"]]
    assert profiler.disagg_summary()["exports"] == 2  # the dropped one too


def _samples(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("paddle_disagg_"):
            key, val = line.rsplit(" ", 1)
            out[key] = float(val)
    return out


def test_disagg_metrics_exposition(fresh_pair, ref_tokens):
    pre, dec = fresh_pair["prefill"], fresh_pair["decode"]
    p = _prompt(6, seed=80)
    _, pf, out = _hops(pre, dec, p, 4)
    assert out["tokens"] == ref_tokens(p, 4)
    st, _, text = _call(dec, "/metrics")
    assert st == 200
    ref_names = [ln.split()[2] for ln in jmetrics.render().splitlines()
                 if ln.startswith("# TYPE paddle_disagg_")]
    names = [ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE paddle_disagg_")]
    assert names == ref_names and len(names) == 8
    label = f'{{replica="127.0.0.1:{dec.server_address[1]}",role="decode"}}'
    want = {"exports": 1, "imports": 1, "import_pages": 1,
            "handoff_bytes": pf["handoff"]["payload_bytes"], "pair_picks": 0,
            "handoff_retries": 0, "reserve_fails": 0, "no_decode_capacity": 0}
    assert _samples(text) == {f"paddle_disagg_{k}_total{label}": v
                              for k, v in want.items()}


def test_healthz_reports_the_role_and_the_reserved_pages(fresh_pair):
    for role, srv in fresh_pair.items():
        st, _, h = _call(srv, "/healthz")
        assert st == 200 and h["role"] == role and h["reserved_pages"] == 0
    dec = fresh_pair["decode"]
    st, _, rsv = _call(dec, "/reserve", {"prompt_len": 20, "max_new_tokens": 4})
    st, _, h = _call(dec, "/healthz")
    assert h["reserved_pages"] == rsv["pages"] == 3
    pool = dec.engine._pool  # committed prefix pages are not free
    assert h["page_free_frac"] == round((pool.free_count() - 3) / pool.usable_pages, 4)


def test_a_bad_handoff_answers_a_typed_400(fresh_pair):
    pre, dec = fresh_pair["prefill"], fresh_pair["decode"]
    p = _prompt(7, seed=90)
    _, _, pf = _call(pre, "/prefill", {"input_ids": p.tolist()})
    bad = json.loads(json.dumps(pf["handoff"]))
    bad["layers"][0]["k"] = bad["layers"][0]["k"][:-8]
    st, _, body = _call(dec, "/generate", {"input_ids": p.tolist(), "handoff": bad})
    assert st == 400 and body["type"] == "HandoffFormatError"
    assert body["retriable"] is False and "layer 0 k" in body["error"]
    st, _, body = _call(pre, "/generate", {"input_ids": p.tolist(),
                                           "handoff": pf["handoff"]})
    assert st == 400 and body["type"] == "ValueError"
    assert "'decode' role" in body["error"]


def _tree_of(server, tid):
    """The span tree of `tid` once it has settled (serve.handle in it, no
    new span for QUIET_S), bounded by WAIT_S."""
    def count(nodes):
        return sum(1 + count(n["children"]) for n in nodes)

    t_end = time.monotonic() + WAIT_S
    seen, t_seen = None, None
    while True:
        status, _, doc = _call(server, f"/trace/{tid}")
        if status == 200 and any(r["name"] == "serve.handle" for r in doc["spans"]):
            n = count(doc["spans"])
            if n != seen:
                seen, t_seen = n, time.monotonic()
            elif time.monotonic() - t_seen >= QUIET_S:
                return doc
        assert time.monotonic() < t_end, f"span tree of {tid} did not settle"
        time.sleep(0.01)


def _names(node):
    return (node["name"], sorted(_names(c) for c in node["children"]))


def _disagg_records(flight, since):
    """(detail, field names) of the flight ring's disagg records after the
    first `since` events."""
    return [(e["detail"], sorted(k for k in e if k not in ("t", "kind", "detail")))
            for e in flight.events()[since:] if e["kind"] == "disagg"]


def test_import_span_and_flight_records_carry_the_reference_names(models,
                                                                   fresh_pair):
    """The same traffic through a reference prefill/decode pair and the
    port's: an orphaned short reservation, then the three hops, the decode
    hop traced from the client."""
    jm, _ = models
    ref = {role: jinference.serve(JaxEngine(jm, role=role, **ENGINE), port=0,
                                  block=False, supervise=False, handle_signals=False)
           for role in ("prefill", "decode")}
    for set_flags in (paddle.set_flags, tcore.set_flags):
        set_flags({"FLAGS_trace": True})
    p = _prompt(11, seed=95)
    trees, records = [], []
    try:
        for servers, flight in ((ref, jflight), (fresh_pair, tflight)):
            since = len(flight.events())
            st, _, _ = _call(servers["decode"], "/reserve", {
                "prompt_len": 11, "max_new_tokens": 3, "ttl_s": 0.05})
            time.sleep(0.1)
            tid = ttrace.new_trace_id()
            _, _, out = _hops(servers["prefill"], servers["decode"], p, 3,
                              {"X-Trace-Id": tid})
            trees.append([_names(r) for r in _tree_of(servers["decode"], tid)["spans"]])
            records.append(_disagg_records(flight, since))
    finally:
        for srv in ref.values():
            srv.engine.stop()
            srv.shutdown()
            srv.server_close()
    assert trees[1] == trees[0]
    (handle,) = trees[1]
    assert "engine.import" in [c[0] for c in handle[1]]
    assert records[1] == records[0]
    assert [d for d, _ in records[1]] == ["reserve", "reserve_expired", "reserve",
                                          "export"]


def test_servers_stopped_in_start_order_leave_no_handler_behind(models):
    """F14: each serve() on the main thread installs a SIGTERM drain handler
    over the one before.  Stopped in the order they started, the last one
    used to put back the second one's handler, whose closure held a stopped
    server and its engine (on the card: the arenas and, through the engine,
    the model, until the process ended)."""
    prev = signal.getsignal(signal.SIGTERM)
    servers = [tinference.serve(ContinuousBatchingEngine(
        models[1], device="cpu", role=role, **ENGINE), port=0, block=False,
        supervise=False) for role in ("colocated", "prefill", "decode")]
    installed = signal.getsignal(signal.SIGTERM)
    assert installed is not prev
    engines = [weakref.ref(s.engine) for s in servers]
    for srv in servers:
        srv.stop()
    assert signal.getsignal(signal.SIGTERM) is prev
    del servers, srv, installed
    gc.collect()
    assert [e() for e in engines] == [None, None, None]
