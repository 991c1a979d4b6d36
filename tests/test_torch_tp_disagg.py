"""Tensor-parallel engines in the disaggregated roles: the port's tp
prefill and decode workers against the JAX package's on the CPU.

The handoff's wire carries whole kv heads whatever the degree: a tp
prefill engine joins its ranks' rows into whole heads before the copy to
the host, a tp decode engine lands each rank's head block in its arena.
Tiny Llamas on shared weights (the reference's state dict), float32,
paged, page_size 8, the port's ranks on `devices=["cpu"] * 2`:

- the port's tp-2 export against the reference tp-2 prefill role's on the
  same prompt: the same keys, version, dtype, geometry and prompt_len,
  rows within 1e-5 + 1e-5 |ref| (K carries RoPE, computed apart by each
  package); and against the port's own tp-1 export within that tolerance;
- tp-2 -> tp-1, tp-1 -> tp-2 and tp-2 -> tp-2 pairs, through JSON, give
  the reference's tokens for the same pairs, with compile counts frozen;
- over int8 pages a tp-2 -> tp-1 and a tp-1 -> tp-2 pair ship the scale
  rows and give the reference int8 engine's tokens;
- the helpers that join and split kv heads are inverse, K, V and scales;
- `replica.py --tp 2 --devices cpu,cpu --role prefill` parses, and its
  engine serves `/prefill` in process; its payload continues on a tp-1
  decode engine;
- an autoscaler role pool at `tp_max` 2 spawns `--tp 2 --role decode`
  workers and reaps them;
- the router's pipeline over a tp-2 prefill and a tp-1 decode server
  gives the reference engine's tokens.
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8)
PAIRS = [(2, 1), (1, 2), (2, 2)]
NEW = 7


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


PROMPTS = [_prompt(13, 50), _prompt(9, 51)]


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    """tp engines install both packages' global meshes and record the mesh
    gauges: put the meshes, the gauges and paddle_tpu's generator back."""
    state = paddle.get_rng_state()
    saved = pmesh.get_mesh(), tmesh.get_mesh()
    yield
    pmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])
    profiler.reset_mesh()
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean():
    profiler.reset_disagg()


@pytest.fixture(scope="module")
def state():
    paddle.seed(49)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _jax_model(state, tp):
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(tensor_parallel_degree=tp))
    jm.set_state_dict(state)
    return jm


def _port_model(state, tp):
    cfg = tllama.LlamaConfig.tiny(tensor_parallel_degree=tp)
    return load_reference_state(tllama.LlamaForCausalLM(cfg, device="cpu"), state)


def _port(model, tp, role="colocated", **kw):
    extra = dict(tp=tp, devices=["cpu"] * tp) if tp > 1 else {}
    return ContinuousBatchingEngine(model, device="cpu", role=role, **extra,
                                    **{**ENGINE, **kw}).warmup()


def _export(engine, p):
    """The prefill engine's handoff payload for prompt p, through JSON."""
    h = engine.submit(p, max_new_tokens=1, export_kv=True)
    engine.run_until_idle()
    h.wait(60)
    return json.loads(json.dumps(h.kv_export))


def _import(engine, p, payload, n=NEW):
    req = engine.submit(p, max_new_tokens=n, handoff=payload)
    engine.run_until_idle()
    return req.wait(60).tolist()


@pytest.fixture(scope="module")
def ref(state):
    """The reference's prefill and decode engines at tp 1 and 2, and per
    (prefill tp, decode tp) pair its tokens on PROMPTS, and its tp-2
    export of PROMPTS[0]."""
    models = {tp: _jax_model(state, tp) for tp in (1, 2)}
    eng = {(tp, role): JaxEngine(models[tp], tp=tp, role=role, **ENGINE)
           for tp in (1, 2) for role in ("prefill", "decode")}
    tokens = {(a, b): [_import(eng[(b, "decode")], p, _export(eng[(a, "prefill")], p))
                       for p in PROMPTS]
              for a, b in PAIRS}
    co8 = JaxEngine(models[1], kv_quant="int8", **ENGINE)
    int8 = [co8.generate(p, max_new_tokens=NEW).tolist() for p in PROMPTS]
    return dict(tokens=tokens, export2=_export(eng[(2, "prefill")], PROMPTS[0]),
                int8=int8)


@pytest.fixture(scope="module")
def port(state):
    """The port's tp-1 and tp-2 models and their warmed prefill and decode
    engines, with their compile counts after warmup."""
    models = {tp: _port_model(state, tp) for tp in (1, 2)}
    eng = {(tp, role): _port(models[tp], tp, role)
           for tp in (1, 2) for role in ("prefill", "decode")}
    return dict(models=models, engines=eng,
                warm={k: dict(e.compile_counts()) for k, e in eng.items()})


GEO = ("none", 4, 16, 2, "float32")  # the tiny Llama's whole kv heads


def _rows_close(got, want):
    for a, b in zip(got, want):
        for n in ("k", "v"):
            x, y = np.asarray(a[n]), np.asarray(b[n])
            # K carries RoPE, computed apart by each package: 1e-5 + 1e-5 |ref|
            assert np.all(np.abs(x - y) <= 1e-5 + 1e-5 * np.abs(y)), n


def test_the_tp2_export_is_the_references_tp2_export(port, ref):
    got = _export(port["engines"][(2, "prefill")], PROMPTS[0])
    want = ref["export2"]
    assert sorted(got) == sorted(want)
    meta = [k for k in want if k != "layers"]
    assert {k: got[k] for k in meta} == {k: want[k] for k in meta}
    assert got["kv_heads"] == 4 and got["prompt_len"] == PROMPTS[0].size
    g, L = jpaging.deserialize_kv_handoff(got, *GEO)
    w, _ = jpaging.deserialize_kv_handoff(want, *GEO)
    assert L == PROMPTS[0].size
    assert [{n: a.shape for n, a in ly.items()} for ly in g] == \
        [{n: a.shape for n, a in ly.items()} for ly in w]
    _rows_close(g, w)


def test_the_tp2_export_equals_the_tp1_export(port):
    e = port["engines"]
    one, two = (_export(e[(tp, "prefill")], PROMPTS[1]) for tp in (1, 2))
    assert {k: v for k, v in one.items() if k != "layers"} == \
        {k: v for k, v in two.items() if k != "layers"}
    _rows_close(tpaging.deserialize_kv_handoff(two, *GEO)[0],
                tpaging.deserialize_kv_handoff(one, *GEO)[0])


@pytest.mark.parametrize("pair", PAIRS, ids=[f"tp{a}-to-tp{b}" for a, b in PAIRS])
def test_a_mixed_degree_pair_gives_the_references_tokens(port, ref, pair):
    a, b = pair
    e = port["engines"]
    pre, dec = e[(a, "prefill")], e[(b, "decode")]
    got = [_import(dec, p, _export(pre, p)) for p in PROMPTS]
    assert got == ref["tokens"][pair]
    for key in ((a, "prefill"), (b, "decode")):
        assert dict(e[key].compile_counts()) == port["warm"][key]
    g = profiler.disagg_summary()
    assert g["exports"] == g["imports"] == len(PROMPTS)
    # whole kv heads on the wire: tp 1's bytes per prompt token
    assert g["handoff_bytes"] == sum(2 * 2 * p.size * 4 * 16 * 4 for p in PROMPTS)
    assert dec.healthz()["tp"] == b and pre.healthz()["tp"] == a


@pytest.mark.parametrize("pair", [(2, 1), (1, 2)], ids=["tp2-to-tp1", "tp1-to-tp2"])
def test_an_int8_pair_ships_the_scales_and_gives_the_references_tokens(port, ref, pair):
    a, b = pair
    models = port["models"]
    pre = _port(models[a], a, "prefill", kv_quant="int8")
    dec = _port(models[b], b, "decode", kv_quant="int8")
    got = []
    for p in PROMPTS:
        payload = _export(pre, p)
        assert payload["quant"] == "int8"
        ly = tpaging.deserialize_kv_handoff(payload, "int8", 4, 16, 2, "float32")[0][0]
        assert ly["k_scale"].shape == (p.size, 4, 1) and ly["k"].dtype == torch.int8
        got.append(_import(dec, p, payload))
    assert got == ref["int8"]


def test_join_and_split_kv_heads_are_inverse():
    g = torch.Generator().manual_seed(0)
    k = torch.randn(2, 16, 4, 8, generator=g)
    scale = torch.rand(2, 16, 4, 1, generator=g)
    for t in (k, scale, k.to(torch.int8)):
        parts = tpaging.split_kv_heads(t, 2)
        assert [p.shape[2] for p in parts] == [2, 2]
        assert torch.equal(parts[1], t[:, :, 2:])
        assert torch.equal(tpaging.join_kv_heads(parts), t)
    assert tpaging.join_kv_heads([k]) is k
    with pytest.raises(ValueError, match="do not split"):
        tpaging.split_kv_heads(k, 3)


def test_a_tp2_prefill_replica_worker_serves_prefill(monkeypatch):
    """`replica.py --tp 2 --devices cpu,cpu --role prefill` builds a tp-2
    prefill engine; behind serve() its /prefill answers whole kv heads,
    /healthz carries the role, tp and mesh, and the payload continues on a
    tp-1 decode engine over the same seeded weights to a colocated
    engine's tokens."""
    from paddle_tpu_torch.serving import replica

    built = []
    monkeypatch.setattr(tinference, "serve", lambda eng, **kw: built.append(eng))
    argv = ["--port", "1", "--device", "cpu", "--tp", "2", "--devices", "cpu,cpu",
            "--role", "prefill"]
    assert replica.main(argv) == 0
    (eng,) = built
    assert (eng.tp, eng.role, eng.paged) == (2, "prefill", True)
    monkeypatch.undo()
    srv = tinference.serve(eng, port=0, block=False, supervise=False,
                           handle_signals=False)
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    p = _prompt(11, 60)
    try:
        req = urllib.request.Request(url + "/prefill", method="POST",
                                     data=json.dumps({"input_ids": p.tolist()}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
    finally:
        srv.stop()
        srv.server_close()
    assert body["prompt_len"] == p.size and body["handoff"]["kv_heads"] == 4
    assert (health["role"], health["tp"], health["mesh_shape"]) == \
        ("prefill", 2, {"mp": 2})
    one = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu", seed=1234)
    want = _port(one, 1).generate(p, max_new_tokens=5).tolist()
    dec = _port(one, 1, "decode")
    assert _import(dec, p, body["handoff"], n=5) == want


class _FakeProcess:
    spawned = []

    def __init__(self, index, port, log_dir, extra_args=()):
        self.url = f"http://127.0.0.1:{port}"
        self.extra_args = list(extra_args)
        self.up = True
        _FakeProcess.spawned.append(self)

    def start(self):
        return self

    def alive(self):
        return self.up

    def terminate(self):
        self.up = False


def test_an_autoscaler_role_pool_spawns_and_reaps_tp_role_replicas(monkeypatch):
    from paddle_tpu_torch.serving import Replica, Router
    from paddle_tpu_torch.serving import autoscaler as tautoscaler

    monkeypatch.setattr(tautoscaler, "ReplicaProcess", _FakeProcess)
    _FakeProcess.spawned.clear()
    seed = Replica("d0", "http://127.0.0.1:9")
    seed._note_healthz({"status": "ready", "role": "decode", "queue_depth": 9})
    router = Router([seed], probe_interval=3600)
    asc = tautoscaler.Autoscaler(router, role="decode", min_replicas=1,
                                 max_replicas=3, up_ticks=1, tp_max=2,
                                 devices_total=4, interval=3600)
    assert asc.tick(now=10.0)["action"] == "up"
    (proc,) = _FakeProcess.spawned
    assert proc.extra_args == ["--tp", "2", "--role", "decode"]
    assert asc._claimed[router.replicas[-1].rid] == 2
    proc.up = False  # the worker died: the next tick reaps it
    asc.tick(now=10.5)
    assert len(router.replicas) == 1 and sum(asc._claimed.values()) == 1
    router.stop()


def test_the_router_pairs_a_tp2_prefill_with_a_tp1_decode_server(port, ref):
    from paddle_tpu_torch.serving import Router

    e = port["engines"]
    servers = [tinference.serve(e[key], port=0, block=False, supervise=False,
                                handle_signals=False)
               for key in ((2, "prefill"), (1, "decode"))]
    router = Router([f"http://127.0.0.1:{s.server_address[1]}" for s in servers],
                    probe_interval=3600, retry_backoff=0.01)
    try:
        router.probe_once()
        assert router.healthz()["roles"] == {"prefill": 1, "decode": 1}
        for p, want in zip(PROMPTS, ref["tokens"][(2, 1)]):
            status, body, _ = router.handle_generate(
                {"input_ids": p.tolist(), "max_new_tokens": NEW})
            assert status == 200, body
            assert body["tokens"] == want
        g = profiler.disagg_summary()
        assert (g["pair_picks"], g["exports"], g["imports"]) == (2, 2, 2)
    finally:
        router.stop()
        for s in servers:
            s.stop()
            s.server_close()
