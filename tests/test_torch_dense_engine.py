"""The port's dense slot-pool engine (`paged=False`) against the JAX
package's dense engine, on shared weights, on the CPU.

Both engines run `slots=2, max_len=64`, buckets [8, 16], over the mixed
traffic of `test_torch_engine.py` plus an over-bucket prompt.  Greedy
tokens must be identical, the engine must equal lock-step `generate`
(reference `test_serving_engine.py:60`), a recycled slot must leak nothing,
and temperature -> 0 must equal greedy (sampled tokens are not compared:
JAX keys and torch generators draw different numbers).
"""

import json
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.inference.paging import QuantConfigError
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa

LENS = [5, 12, 9, 15, 3, 11]  # test_paged_kv.py's mixed traffic
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=False)


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
    """The JAX dense engine's greedy outputs on the mixed traffic plus one
    over-bucket prompt (20 tokens grows a 32 bucket)."""
    jm, _ = models
    prompts = [_prompt(n, seed=50 + i) for i, n in enumerate(LENS)] + [_prompt(20, seed=90)]
    news = [4 + (i % 5) for i in range(len(LENS))] + [6]
    outs, _ = _run(JaxEngine(jm, **ENGINE), prompts, news)
    return prompts, news, outs


def test_greedy_tokens_identical_to_jax_dense_engine(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm)
    assert not eng.paged and eng._pool is None and eng._prefix is None
    assert eng._caches[0].k.shape == (2, 64, 2, 16)
    eng.warmup()
    profiler.reset_serving()
    pfa.reset_launch_counts()
    outs, reqs = _run(eng, prompts, news)
    assert outs == ref
    assert 32 in eng.prefill_buckets  # the over-bucket prompt grew one
    assert all(r.finish_reason == "length" for r in reqs)
    summary = profiler.serving_summary()
    assert summary["requests"] == len(prompts)
    assert summary["tokens"] == sum(news)
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)  # CPU


def test_engine_matches_lockstep_generate(models):
    """Reference test_serving_engine.py:60, on the port alone, and the
    JAX package's lock-step tokens."""
    jm, tm = models
    p = _prompt(5, seed=7)
    out = _engine(tm).generate(p, max_new_tokens=6)
    ref = tm.generate(torch.from_numpy(p[None]), max_new_tokens=6).numpy()[0]
    np.testing.assert_array_equal(out, ref)
    jref = jm.generate(paddle.to_tensor(p[None]), max_new_tokens=6).numpy()[0]
    np.testing.assert_array_equal(out, jref)


def test_slot_recycling_no_leakage(models):
    """A slot recycled from finished request A gives request B the tokens a
    fresh engine and lock-step generation give: the stale rows A left past
    B's prefill are never attended (decode writes row pos before masking
    j <= pos)."""
    _, tm = models
    pa, pb = _prompt(14, seed=1), _prompt(5, seed=2)
    dirty = _engine(tm, slots=1)  # one slot: B must reuse A's row
    ra = dirty.submit(pa, max_new_tokens=20)  # long: fills rows past B's
    dirty.run_until_idle()
    ra.wait(1)
    out_dirty = dirty.generate(pb, max_new_tokens=8)
    assert dirty.active_slots == 0 and dirty._slot_req == [None]
    assert dirty._pos.tolist() == [0] and dirty._temps.tolist() == [0.0]
    out_fresh = _engine(tm, slots=1).generate(pb, max_new_tokens=8)
    np.testing.assert_array_equal(out_dirty, out_fresh)
    ref = tm.generate(torch.from_numpy(pb[None]), max_new_tokens=8).numpy()[0]
    np.testing.assert_array_equal(out_dirty, ref)


def test_temperature_to_zero_equals_greedy(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    outs, _ = _run(_engine(tm), prompts[:3], news[:3], temperature=1e-7)
    assert outs == ref[:3]


def test_per_slot_temperature_is_data(models, reference_tokens):
    """A sampled request decoding beside a greedy one leaves the greedy
    tokens as they were."""
    _, tm = models
    prompts, news, ref = reference_tokens
    eng = _engine(tm)
    rg = eng.submit(prompts[0], max_new_tokens=news[0])
    rs = eng.submit(prompts[1], max_new_tokens=6, temperature=0.9)
    eng.run_until_idle()
    assert rg.wait(1).tolist() == ref[0]
    assert len(rs.wait(1)) == prompts[1].size + 6


def test_eos_stops_and_recycles_like_jax(models, reference_tokens):
    jm, tm = models
    prompts, _, ref = reference_tokens
    p = prompts[1]
    eos = ref[1][p.size + 1]  # the second generated token
    j = JaxEngine(jm, **ENGINE).generate(p, max_new_tokens=8, eos_token_id=eos)
    eng = _engine(tm)
    req = eng.submit(p, max_new_tokens=8, eos_token_id=eos)
    eng.run_until_idle()
    assert req.wait(1).tolist() == j.tolist()
    assert req.finish_reason == "eos" and eng.active_slots == 0


def test_serves_over_http(models, reference_tokens):
    _, tm = models
    prompts, news, ref = reference_tokens
    server = serve(_engine(tm), port=0, block=False)
    port = server.server_address[1]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            json.dumps({"input_ids": prompts[2].tolist(),
                        "max_new_tokens": news[2]}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            assert json.loads(r.read())["tokens"] == ref[2]
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
            h = json.loads(r.read())
        assert h["status"] == "ready" and h["page_free_frac"] == 1.0
        assert h["prefix_cache_size"] == 0 and h["kv_quant"] == "none"
    finally:
        server.stop()


def test_knobs_as_in_the_reference(models):
    """int8 pages need the paged engine (QuantConfigError) and so does LoRA
    (ValueError); speculation and the prefix cache are simply off."""
    _, tm = models
    with pytest.raises(QuantConfigError, match="paged"):
        _engine(tm, kv_quant="int8")
    with pytest.raises(ValueError, match="paged engine"):
        _engine(tm, lora=object())
    eng = _engine(tm, spec_k=2, prefix_cache=True)
    assert eng._prefix is None
    p = _prompt(9, seed=4)
    np.testing.assert_array_equal(
        eng.generate(p, max_new_tokens=3),
        tm.generate(torch.from_numpy(p[None]), max_new_tokens=3).numpy()[0])
