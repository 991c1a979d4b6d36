"""The port's paged engine against the JAX engine, on shared weights, on the
CPU: greedy tokens must be identical over mixed-length traffic.

Both engines run paged, page_size 8, buckets [8, 16], no prefix cache.  The
JAX model is built after `paddle.seed`; its state goes through numpy into
the port.  Sampled paths are not compared token by token (JAX keys and
torch generators draw different numbers): temperature -> 0 must equal
greedy instead.
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed.sharding import ShardingError
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.engine import (
    ContextOverflow,
    ContinuousBatchingEngine,
    QueueFull,
)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

LENS = [5, 12, 9, 15, 3, 11]  # test_paged_kv.py's mixed traffic
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8, prefix_cache=False)


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
    paddle.seed(33)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


def _engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def _run(eng, prompts, news, **kw):
    reqs = [eng.submit(p, max_new_tokens=n, **kw) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs], reqs


@pytest.fixture(scope="module")
def reference_tokens(models):
    """The JAX engine's greedy outputs on the mixed traffic plus one
    over-bucket prompt (20 tokens grows a 32 bucket) and one EOS stop."""
    jm, _ = models
    prompts = [_prompt(n, seed=50 + i) for i, n in enumerate(LENS)] + [_prompt(20, seed=90)]
    news = [4 + (i % 5) for i in range(len(LENS))] + [6]
    eng = JaxEngine(jm, **ENGINE)
    outs, _ = _run(eng, prompts, news)
    return prompts, news, outs


def test_greedy_tokens_identical_to_jax_engine(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm)
    eng.warmup()
    profiler.reset_serving()
    outs, reqs = _run(eng, prompts, news)
    assert outs == ref
    assert 32 in eng.prefill_buckets  # the over-bucket prompt grew one
    assert all(r.finish_reason == "length" for r in reqs)
    assert eng._pool.free_count() == eng._pool.usable_pages  # no page leaks
    summary = profiler.serving_summary()
    assert summary["requests"] == len(prompts)
    assert summary["tokens"] == sum(news)
    assert 0 < summary["occupancy_mean"] <= 1.0


def test_gather_kernel_gives_the_same_tokens(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    outs, _ = _run(_engine(tm, decode_kernel="gather"), prompts, news)
    assert outs == ref


def test_eos_stops_and_recycles_like_jax_engine(models, reference_tokens):
    jm, tm = models
    prompts, news, ref = reference_tokens
    p = prompts[1]
    eos = ref[1][p.size + 1]  # the second generated token
    j = JaxEngine(jm, **ENGINE).generate(p, max_new_tokens=8, eos_token_id=eos)
    eng = _engine(tm)
    req = eng.submit(p, max_new_tokens=8, eos_token_id=eos)
    eng.run_until_idle()
    out = req.wait(1)
    assert out.tolist() == j.tolist()
    assert req.finish_reason == "eos" and out[-1] == eos
    assert eng.active_slots == 0


def test_temperature_to_zero_equals_greedy(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    outs, _ = _run(_engine(tm, seed=5), prompts, news, temperature=1e-6)
    assert outs == ref


def test_sampling_is_seeded(models):
    _, tm = models
    prompts = [_prompt(n, seed=70 + i) for i, n in enumerate(LENS)]
    news = [8] * len(prompts)
    a, _ = _run(_engine(tm, seed=3), prompts, news, temperature=1.0)
    b, _ = _run(_engine(tm, seed=3), prompts, news, temperature=1.0)
    assert a == b


def test_page_pressure_defers_admission_in_fifo_order(models, reference_tokens):
    """A pool that fits one request at a time still serves every request,
    with the same tokens."""
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm, pool_pages=4)  # 3 usable pages = 24 rows
    outs, _ = _run(eng, prompts[:4], news[:4])
    assert outs == ref[:4]
    assert eng._pool.free_count() == 3


def test_submit_rejects_what_cannot_fit(models):
    _, tm = models
    eng = _engine(tm, pool_pages=3, queue_depth=1)
    with pytest.raises(QueueFull, match="pages"):
        eng.submit(_prompt(12), max_new_tokens=20)  # span 32 -> 4 pages > 2
    with pytest.raises(ContextOverflow):
        eng.submit(_prompt(64), max_new_tokens=1)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=1)
    eng.submit(_prompt(4), max_new_tokens=2)
    with pytest.raises(QueueFull, match="queue full"):
        eng.submit(_prompt(4), max_new_tokens=2)


@pytest.mark.parametrize(
    "knob,item,error",
    [
        # ids as they were when the prefix cache and int8 KV (since ported)
        # were the first and third cases.  Speculation and context
        # parallelism are ported too: their cases now hold the typed
        # refusals left of them (the reference's ValueErrors)
        pytest.param(dict(spec_k=-1), "spec_k must be >= 0", ValueError,
                     id="knob1-speculative"),
        # tensor parallelism is ported (the tp engines of
        # test_torch_tp_serving.py): its cases hold the typed ShardingErrors
        # left of it.  Without a device list the 'mp' ranks take the visible
        # CUDA devices, each once: none here
        pytest.param(dict(tp=2), "needs 2 devices", ShardingError,
                     id="knob3-tensor-parallel"),
        pytest.param(dict(cp=2, paged=False), "requires the paged engine",
                     ValueError, id="knob4-context-parallel"),
        # the dense slot pool at tp 2 over a model built without
        # tensor_parallel_degree: nothing for the mesh to shard
        pytest.param(dict(paged=False, tp=2, devices=["cpu"] * 2),
                     "tensor_parallel_degree", ShardingError,
                     id="knob5-dense slot-pool"),
        # LoRA at tp 4: 2 kv heads do not split over 4 ranks (checked
        # before the arena)
        pytest.param(dict(lora=object(), tp=4, devices=["cpu"] * 4),
                     r"num_key_value_heads \(2\)", ShardingError,
                     id="knob6-LoRA"),
        # disaggregated roles are ported: the dense pool refuses them with
        # the reference's ValueError
        pytest.param(dict(role="decode", paged=False), "requires the paged engine",
                     ValueError, id="knob7-disaggregated"),
    ],
)
def test_unported_knobs_raise_naming_the_roadmap_item(models, knob, item, error):
    _, tm = models
    with pytest.raises(error, match=item):
        _engine(tm, **knob)


def test_scheduler_thread_serves_concurrent_submits(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm).start()
    try:
        reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
        outs = [r.wait(60).tolist() for r in reqs]
    finally:
        eng.stop()
    assert outs == ref
    assert eng.healthz()["status"] == "live"


def test_concurrent_submitters_resolve_every_request_exactly_once(models,
                                                                  reference_tokens):
    """12 submitter threads (more than the cores) race the scheduler thread
    with a short switch interval: every request resolves once, with the
    reference's greedy tokens, and every page returns to the pool."""
    import sys

    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm, queue_depth=64).start()
    outs, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def worker(w):
        try:
            for i in range(3):
                j = (w + i) % len(prompts)
                outs[(w, i)] = (j, eng.submit(prompts[j], max_new_tokens=news[j]))
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    try:
        threads = [threading.Thread(target=worker, args=(w,)) for w in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads) and errors == []
        got = {key: (j, req.wait(120).tolist()) for key, (j, req) in outs.items()}
    finally:
        sys.setswitchinterval(old)
        eng.stop()
    assert len(got) == 36
    assert all(toks == ref[j] for j, toks in got.values())
    assert all(req.finish_reason == "length" for _, req in outs.values())
    assert eng._pool.free_count() == eng._pool.usable_pages


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        return resp.status, json.loads(resp.read())


def test_serve_generate_healthz_and_queue_full(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm, pool_pages=4)
    server = serve(eng, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        results = [None] * 3

        def client(i):
            results[i] = _post(base + "/generate", {
                "input_ids": prompts[i].tolist(), "max_new_tokens": news[i]})

        threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert [r[0] for r in results] == [200] * 3
        assert [r[1]["tokens"] for r in results] == ref[:3]
        with urllib.request.urlopen(base + "/healthz", timeout=10) as resp:
            health = json.loads(resp.read())
        assert health["status"] == "ready" and health["queue_depth"] == 0
        with pytest.raises(urllib.error.HTTPError) as ei:  # 5 pages > 3 usable
            _post(base + "/generate", {"input_ids": list(range(1, 30)),
                                       "max_new_tokens": 8})
        assert ei.value.code == 503 and ei.value.headers["Retry-After"] == "1"
    finally:
        server.stop()
    assert eng._thread is None


@pytest.mark.parametrize(
    "bad_ids",
    [[5, 256, 7], [-1, 3], [2**31 + 5], [1.5, 2.0], [2**70]],
    ids=["past_vocab", "negative", "past_int32", "float", "past_int64"],
)
def test_serve_rejects_token_ids_outside_the_vocab_and_keeps_serving(
        models, reference_tokens, bad_ids):
    """An id outside [0, vocab_size) answers 400 before it reaches the
    embedding (on the card it would be a device-side assert that poisons
    the context); the next valid request is served with the greedy
    tokens."""
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm)
    server = serve(eng, port=0, block=False)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(base + "/generate", {"input_ids": bad_ids, "max_new_tokens": 2})
        assert ei.value.code == 400
        assert json.loads(ei.value.read())["type"] == "ValueError"
        status, body = _post(base + "/generate", {
            "input_ids": prompts[0].tolist(), "max_new_tokens": news[0]})
        assert status == 200 and body["tokens"] == ref[0]
    finally:
        server.stop()
    assert eng.pending == 0 and eng.active_slots == 0


def test_engine_rejects_a_model_on_another_device(models):
    _, tm = models
    with pytest.raises(ValueError, match="lives on"):
        ContinuousBatchingEngine(tm, device="meta", **ENGINE)
