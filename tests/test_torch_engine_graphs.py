"""The port's compiled steps and in-flight decode against the JAX engine,
on shared weights, on the CPU (`tests/test_torch_engine.py`'s tiny Llama
and mixed traffic).

- `compile_counts()` equals the JAX engine's after `warmup()` and after
  traffic, for the paged, dense, prefix-cached and speculative (spec_k 2)
  engines, and traffic adds no trace.
- The deferred fetch flushes where the reference's does: the same number
  of `_flush_pending_locked` calls as the JAX engine's on the same traffic,
  with and without an EOS watch and an `on_token` consumer, and the greedy
  tokens identical.
- A long run with no EOS watch (12 new tokens on 2 slots) keeps its steps
  in flight and still gives the greedy tokens: a pending entry that aliased
  the decode step's static outputs would give the last step's tokens.
- One slot's non-finite logits error that request alone (NonFiniteLogits,
  HTTP 500 through serve()); the co-batched slot's tokens stay the JAX
  engine's.
- Temperature -> 0 is greedy, and a seeded sampled run repeats itself on
  the static-buffer path.

On the CPU a step runs its body eagerly on the static buffers; on the card
the same bodies are CUDA graphs (chip_smoke.py holds replay against eager
there).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    NonFiniteLogits,
)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

LENS = [5, 12, 9, 15, 3, 11]  # test_torch_engine.py's mixed traffic
BASE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=32,
            seed=0, page_size=8)
CONFIGS = {
    "paged": dict(paged=True, prefix_cache=False),
    "dense": dict(paged=False),
    "prefix": dict(paged=True, prefix_cache=True),
    "spec": dict(paged=True, prefix_cache=False, spec_k=2),
}


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _traffic(config):
    """(prompts, max_new_tokens, batches): each batch is submitted after the
    previous one finished.  The prefix config's first request commits a
    12-token system prompt (a full page and a 4-row tail) that the others
    share (chunk prefills and COW copies); the spec config repeats a
    pattern that prompt lookup drafts from.  One prompt of 20 grows a 32
    bucket."""
    if config == "prefix":
        system = _prompt(12, seed=7)
        prompts = [np.concatenate([system, _prompt(n, seed=30 + n)])
                   for n in (3, 5, 7, 2)] + [_prompt(20, seed=90)]
        return prompts, [5, 4, 6, 3, 4], [[0], [1, 2, 3, 4]]
    if config == "spec":
        pat = _prompt(6, seed=7)
        prompts = [np.tile(pat, 4)[:20].astype(np.int32), _prompt(9, seed=3),
                   _prompt(13, seed=6)]
        return prompts, [12, 6, 8], [[0, 1, 2]]
    prompts = [_prompt(n, seed=50 + i) for i, n in enumerate(LENS)] + [_prompt(20, seed=90)]
    news = [4 + (i % 5) for i in range(len(LENS))] + [6]
    return prompts, news, [list(range(len(prompts)))]


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


class _Flushes:
    """Counts an engine's `_flush_pending_locked` calls (instance wrap)."""

    def __init__(self, eng):
        self.n = 0
        real = eng._flush_pending_locked

        def counted():
            self.n += 1
            return real()

        eng._flush_pending_locked = counted


def _serve(eng, config, **submit_kw):
    prompts, news, batches = _traffic(config)
    outs = [None] * len(prompts)
    for batch in batches:
        reqs = {i: eng.submit(prompts[i], max_new_tokens=news[i], **submit_kw)
                for i in batch}
        eng.run_until_idle()
        for i, r in reqs.items():
            outs[i] = r.wait(1).tolist()
    return outs


@pytest.fixture(scope="module")
def engines(models):
    """Per config: the JAX engine and the port's, each warmed, with their
    compile counts right after warmup and their flush counters."""
    jm, tm = models
    out = {}
    for name, kw in CONFIGS.items():
        j = JaxEngine(jm, **BASE, **kw)
        j.warmup()
        t = ContinuousBatchingEngine(tm, device="cpu", **BASE, **kw)
        t.warmup()
        out[name] = dict(jax=j, port=t, jax_warm=j.compile_counts(),
                         port_warm=t.compile_counts(), jax_flush=_Flushes(j),
                         port_flush=_Flushes(t))
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_compile_counts_equal_the_jax_engines(engines, config):
    e = engines[config]
    assert e["port_warm"] == e["jax_warm"]
    j_out = _serve(e["jax"], config)
    t_out = _serve(e["port"], config)
    assert t_out == j_out
    after = e["port"].compile_counts()
    assert after == e["jax"].compile_counts()
    # the over-bucket prompt traced its new bucket's fresh prefill (prefill
    # == buckets used); nothing else traced under traffic
    assert 32 in e["port"].prefill_buckets
    assert after == dict(e["port_warm"], prefill=len(e["port"].prefill_buckets))
    # a second pass over the same traffic traces nothing at all
    assert _serve(e["port"], config) == j_out
    assert e["port"].compile_counts() == after


@pytest.mark.parametrize("watch", ["none", "eos", "on_token"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_flush_points_equal_the_jax_engines(engines, config, watch):
    e = engines[config]
    plain = _serve(e["jax"], config)
    kw = {}
    if watch == "eos":
        prompts, _, _ = _traffic(config)
        kw["eos_token_id"] = plain[1][prompts[1].size + 1]  # 2nd new token
    streamed = {"jax": [], "port": []}
    counts = {}
    outs = {}
    for side in ("jax", "port"):
        if watch == "on_token":
            kw["on_token"] = streamed[side].append
        flush = e[side + "_flush"]
        flush.n = 0
        outs[side] = _serve(e[side], config, **kw)
        counts[side] = flush.n
    assert outs["port"] == outs["jax"]
    assert counts["port"] == counts["jax"] > 0
    if watch == "eos":
        assert outs["port"][1][-1] == kw["eos_token_id"]
        assert outs["port"] != plain
    if watch == "on_token":
        assert streamed["port"] == streamed["jax"]
        assert len(streamed["port"]) == sum(len(o) - p.size for o, p in
                                            zip(outs["port"], _traffic(config)[0]))


def test_long_run_keeps_steps_in_flight_and_gives_greedy(engines):
    e = engines["paged"]
    prompts = [_prompt(5, seed=61), _prompt(9, seed=62)]
    jreqs = [e["jax"].submit(p, max_new_tokens=12) for p in prompts]
    e["jax"].run_until_idle()
    eng = e["port"]
    e["port_flush"].n = 0
    profiler.reset_serving()
    reqs = [eng.submit(p, max_new_tokens=12) for p in prompts]
    eng.run_until_idle()
    summary = profiler.serving_summary()
    assert [r.wait(1).tolist() for r in reqs] == [r.wait(1).tolist() for r in jreqs]
    assert summary["decode_steps"] == 11
    # two admissions flush (nothing pending), and the one decode step whose
    # slots reach their length bound: every other step stayed in flight
    assert e["port_flush"].n == 3
    assert summary["host_fetches"] == 1
    assert summary["decode_window_s"] > 0
    assert eng._pending_fetch == []


def test_nonfinite_logits_error_one_slot_alone(models, engines):
    jm, tm = models
    prompts = [_prompt(5, seed=71), _prompt(9, seed=72)]
    j = engines["paged"]["jax"]
    jreqs = [j.submit(p, max_new_tokens=8) for p in prompts]
    j.run_until_idle()
    eng = ContinuousBatchingEngine(tm, device="cpu", **BASE, **CONFIGS["paged"])
    seen = {"decode": 0}

    def poison(module, args, out):
        if out.shape[0] != eng.slots:  # a prefill's single row
            return out
        seen["decode"] += 1
        if seen["decode"] == 3:
            out = out.clone()
            out[1, 7] = float("nan")  # slot 1, third decode step
        return out

    hook = tm.lm_head.register_forward_hook(poison)
    try:
        reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
        eng.run_until_idle()
    finally:
        hook.remove()
    assert reqs[0].wait(1).tolist() == jreqs[0].wait(1).tolist()
    assert reqs[1].finish_reason == "error"
    assert isinstance(reqs[1].error, NonFiniteLogits)
    assert len(reqs[1].tokens) == 3  # the first token and two decode steps
    with pytest.raises(NonFiniteLogits, match="slot 1"):
        reqs[1].wait(1)
    assert eng._pool.free_count() == eng._pool.usable_pages
    assert eng.active_slots == 0


def test_serve_answers_500_for_nonfinite_logits(models):
    _, tm = models
    eng = ContinuousBatchingEngine(tm, device="cpu", **BASE, **CONFIGS["paged"])

    def poison(module, args, out):
        return torch.full_like(out, float("nan")) if out.shape[0] == eng.slots else out

    hook = tm.lm_head.register_forward_hook(poison)
    server = serve(eng, port=0, block=False)
    try:
        body = json.dumps({"input_ids": _prompt(6).tolist(),
                           "max_new_tokens": 4}).encode()
        req = urllib.request.Request(
            f"http://127.0.0.1:{server.server_address[1]}/generate", data=body,
            headers={"Content-Type": "application/json"})
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=60)
    finally:
        server.stop()
        hook.remove()
    assert ei.value.code == 500
    err = json.loads(ei.value.read())
    assert err["type"] == "NonFiniteLogits" and err["retriable"] is False


def test_temperature_to_zero_equals_greedy(engines):
    e = engines["paged"]
    greedy = _serve(e["jax"], "paged")
    assert _serve(e["port"], "paged", temperature=1e-6) == greedy


def test_seeded_sampling_repeats_on_the_static_buffers(models):
    _, tm = models

    def sampled(seed):
        eng = ContinuousBatchingEngine(tm, device="cpu", **{**BASE, "seed": seed},
                                       **CONFIGS["paged"])
        eng.warmup()
        return _serve(eng, "paged", temperature=1.0)

    a, b, c = sampled(3), sampled(3), sampled(4)
    assert a == b
    assert a != c  # the draw depends on the seed: it samples
