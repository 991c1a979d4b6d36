"""The port's LoRA serving paths against the JAX package on the CPU:
arena-full parking, per-adapter prefix isolation, speculation over mixed
adapters, warm-restart residency, and `POST /generate` with `adapter` on
both packages' servers (the reference's terminal 404 for an unknown name).

Tiny Llamas on shared weights (`load_reference_state`), the same adapter
dicts registered in both packages, float32, page_size 8.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu import lora as jlora
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import lora as tlora
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import metrics as tmetrics

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(44)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture
def invariants():
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    yield
    tcore.set_flags({"FLAGS_serve_debug_invariants": False})


def _registries(models, n, rank=4, scale=0.1):
    jm, tm = models
    jreg, treg = jlora.AdapterRegistry(jm.config), tlora.AdapterRegistry(tm.config)
    for i in range(1, n + 1):
        a = jlora.make_random(jreg, f"a{i}", rank=rank, seed=i, scale=scale)
        treg.register(a.name, a.weights, a.rank, alpha=a.scale * a.rank)
    return jreg, treg


def _engine(tm, treg, capacity=4, rank_max=8, **kw):
    return ContinuousBatchingEngine(
        tm, device="cpu", lora=tlora.AdapterArena(treg, capacity=capacity,
                                                  rank_max=rank_max, device="cpu"),
        **{**ENGINE, **kw})


def test_full_arena_parks_admission_until_a_slot_frees(models, invariants):
    _, tm = models
    _, treg = _registries(models, 3, rank=2)
    eng = _engine(tm, treg, capacity=2, rank_max=4)
    reqs = [eng.submit(_prompt(10, i), max_new_tokens=4, adapter=f"a{i}")
            for i in (1, 2, 3)]
    eng.step()
    # two adapters bound, the third request parked (not failed) at the head
    assert eng.active_slots == 2 and eng.pending == 1
    assert not reqs[2].finished.is_set() and reqs[2].state == "queued"
    eng.run_until_idle()
    outs = [r.wait(1) for r in reqs]
    assert all(o.size == 10 + 4 for o in outs)
    assert eng.healthz()["lora"]["resident"] == 2
    # the parked request's tokens are its adapter's, as if it never waited
    alone = _engine(tm, treg, capacity=2, rank_max=4)
    assert alone.generate(_prompt(10, 3), max_new_tokens=4,
                          adapter="a3").tolist() == outs[2].tolist()


def test_prefix_cache_is_isolated_per_adapter(models, invariants):
    jm, tm = models
    jreg, treg = _registries(models, 2)
    base = _prompt(12, 42)
    traffic = [(43, "a1"), (44, "a2"), (45, "a1"), (46, None), (47, "a2")]
    outs = []
    for eng in (JaxEngine(jm, lora=jlora.AdapterArena(jreg, capacity=4), **ENGINE),
                _engine(tm, treg)):
        got = []
        for tail, adapter in traffic:
            p = np.concatenate([base, _prompt(4, tail)]).astype(np.int32)
            req = eng.submit(p, max_new_tokens=3, adapter=adapter)
            eng.run_until_idle()
            got.append(req.wait(1).tolist())
        outs.append(got)
    assert outs[1] == outs[0]
    # the same tokens under another adapter (or none) never share pages:
    # each first request of an adapter commits its own chain
    eng = _engine(tm, treg)
    profiler.reset_paging()
    for tail, adapter in traffic:
        eng.generate(np.concatenate([base, _prompt(4, tail)]).astype(np.int32),
                     max_new_tokens=2, adapter=adapter)
    assert profiler.paging_summary()["prefix_hits"] == 2  # the 2nd a1, 2nd a2
    roots = {e.key[0] for e in eng._prefix.entries() if e.parent_key in
             ((), ("__lora__", 1), ("__lora__", 2))}
    assert roots == {(), ("__lora__", 1), ("__lora__", 2)}


def test_speculation_over_mixed_adapters_matches_the_reference(models, invariants):
    jm, tm = models
    jreg, treg = _registries(models, 2)
    # repetitive prompts give the prompt-lookup drafter something to accept
    prompts = [np.tile(_prompt(5, 6), 3), np.tile(_prompt(4, 7), 3),
               np.tile(_prompt(6, 8), 2)]
    adapters = ["a1", "a2", None]

    def serve_all(eng):
        reqs = [eng.submit(p, max_new_tokens=10, adapter=a)
                for p, a in zip(prompts, adapters)]
        eng.run_until_idle()
        return [r.wait(1).tolist() for r in reqs]

    ref = serve_all(JaxEngine(jm, lora=jlora.AdapterArena(jreg, capacity=3),
                              spec_k=3, **ENGINE))
    eng = _engine(tm, treg, capacity=3, spec_k=3)
    eng.warmup()
    warm = eng.compile_counts()
    assert warm["verify"] == 1
    profiler.reset_speculation()
    got = serve_all(eng)
    assert got == ref
    assert eng.compile_counts() == warm
    assert profiler.speculation_summary()["proposed"] > 0
    # speculation's greedy tokens are plain decode's, adapter by adapter
    assert serve_all(_engine(tm, treg, capacity=3)) == got


def test_warm_restart_keeps_adapters_resident(models, invariants):
    _, tm = models
    _, treg = _registries(models, 2)
    eng = _engine(tm, treg)
    eng.warmup()
    warm = eng.compile_counts()
    first = eng.generate(_prompt(10, 6), max_new_tokens=3, adapter="a1").tolist()
    eng.generate(_prompt(10, 7), max_new_tokens=3, adapter="a2")
    before = eng._lora.resident()
    profiler.reset_lora()
    # a request in flight holds a binding: the restart resolves it and
    # drops the binding, a queued one binds again at its re-admission, and
    # the residency stays
    cut = eng.submit(_prompt(10, 7), max_new_tokens=3, adapter="a2")
    eng.step()
    assert eng._slot_adapter.any()
    queued = eng.submit(_prompt(10, 6), max_new_tokens=3, adapter="a1")
    eng.restart(reason="drill")
    assert cut.finish_reason == "restarted"
    assert eng._lora.resident() == before and not eng._slot_adapter.any()
    eng._check_invariants()
    eng.run_until_idle()
    assert queued.wait(1).tolist() == first
    assert eng.generate(_prompt(10, 6), max_new_tokens=3,
                        adapter="a1").tolist() == first
    assert profiler.lora_summary()["loads"] == 0  # no re-upload
    assert eng.compile_counts() == warm


def _post(url, body):
    req = urllib.request.Request(url + "/generate", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return r.read().decode()


def test_serve_adapter_field_and_unknown_404_as_the_reference(models):
    jm, tm = models
    jreg, treg = _registries(models, 1)
    ref = jinference.serve(JaxEngine(jm, lora=jlora.AdapterArena(jreg, capacity=2),
                                     **ENGINE),
                           port=0, block=False, supervise=False, handle_signals=False)
    port = tinference.serve(_engine(tm, treg, capacity=2), port=0, block=False)
    urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in (ref, port)]
    try:
        answers = []
        for body in ({"input_ids": _prompt(8).tolist(), "max_new_tokens": 3,
                      "adapter": "a1"},
                     {"input_ids": _prompt(8).tolist(), "max_new_tokens": 3,
                      "adapter": "ghost"},
                     {"input_ids": _prompt(8).tolist(), "max_new_tokens": 3,
                      "adapter": 1}):
            got = [_post(u, body) for u in urls]
            for _, payload in got:
                payload.pop("trace_id", None)
            assert got[1] == got[0]
            answers.append(got[1])
        (ok, body), (miss, err), (by_id, body_id) = answers
        assert ok == 200 and len(body["tokens"]) == 8 + 3
        assert by_id == 200 and body_id == body  # the stable id resolves too
        assert miss == 404 and err["type"] == "AdapterUnknown"
        assert err["retriable"] is False and "ghost" in err["error"]
        health = json.loads(_get(urls[1], "/healthz"))
        assert health["lora"]["adapters"] == ["a1"]
        assert health["lora"]["capacity"] == 2
        text = _get(urls[1], "/metrics")
        values = dict(line.rsplit(" ", 1) for line in text.splitlines()
                      if line.startswith("paddle_lora_") and "{" in line)
        loads = [float(v) for k, v in values.items()
                 if k.startswith("paddle_lora_loads_total")]
        assert loads and loads[0] >= 1
        assert "paddle_lora_residency_hits_total" in text
        assert tmetrics.render().count("paddle_lora_resident") >= 1
    finally:
        ref.engine.stop()
        ref.shutdown()
        ref.server_close()
        port.stop()
