"""Lock-step generation of the port's GPT (`GPTForCausalLM.generate` over
static KV caches, `GenerationPredictor` behind `serve()`) against the JAX
package, on shared weights, on the CPU.

Tiny float32 GPTs, dense and with an MoE layer on layer 1, are built by
the JAX package after `paddle.seed`; their state goes through numpy into
the port.  Greedy and beam-search tokens must be identical.  Sampled paths
are held by top_k=1 equalling greedy and by seeded repeatability (JAX keys
and torch generators draw different numbers).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationPredictor as JaxPredictor
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.inference import GenerationPredictor, serve
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _build(moe):
    paddle.seed(43)
    cfg = dict(moe_num_experts=4 if moe else 0)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture(scope="module")
def dense():
    return _build(False)


@pytest.fixture(scope="module")
def moe():
    return _build(True)


@pytest.fixture(params=["dense", "moe"])
def models(request):
    return request.getfixturevalue(request.param)


def _jax(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _port(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


@pytest.mark.parametrize("s0", [8, 70])
def test_greedy_tokens_identical_to_jax(models, s0):
    """8 tokens: the dense math on both sides; 70 (>= 64, a 128-row cache):
    the port's prefill takes `dense_decode` where the reference takes its
    Pallas kernel, run in interpret mode for the second comparison."""
    jm, tm = models
    ids = _ids(2, s0, seed=s0)
    pfa.reset_launch_counts()
    got = _port(tm, ids, max_new_tokens=8)
    assert got.shape == (2, s0 + 8) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(jm, ids, max_new_tokens=8))
    if s0 >= 64:
        saved = jfa._FORCE_INTERPRET
        jfa._FORCE_INTERPRET = True
        try:
            np.testing.assert_array_equal(got, _jax(jm, ids, max_new_tokens=8))
        finally:
            jfa._FORCE_INTERPRET = saved
    assert pfa.launch_counts["dense_decode"] == 0  # CPU: the plain version


def test_compiled_decode_traces_once(dense):
    """The reference's `TestGPTDecode` on the port: greedy's last token is
    the argmax of the full forward over what came before it, the prefill
    and decode shapes trace once (`trace_count` 2), and a repeat call
    traces nothing and gives the same tokens."""
    _, tm = dense
    tm._gen_cache_key = None  # a fresh geometry registry
    ids = torch.from_numpy(_ids(2, 8, seed=2))
    out = tm.generate(ids, max_new_tokens=5)
    assert out.shape == (2, 13)
    assert tm._gen_fns["greedy"].trace_count == 2
    with torch.no_grad():
        full = tm(out[:, :-1])
    np.testing.assert_array_equal(full[:, -1].argmax(-1).numpy(), out[:, -1].numpy())
    again = tm.generate(ids, max_new_tokens=5)
    assert torch.equal(out, again)
    assert tm._gen_fns["greedy"].trace_count == 2


def test_prefill_takes_dense_decode_at_64_rows(moe, monkeypatch):
    _, tm = moe
    calls = []
    real = pfa.dense_decode
    monkeypatch.setattr("paddle_tpu_torch.ops.flash_attention.dense_decode",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    tm.generate(torch.from_numpy(_ids(1, 70, 3)), max_new_tokens=3)
    assert calls == [(1, 70, 4, 16)] * tm.config.num_hidden_layers
    calls.clear()
    tm.generate(torch.from_numpy(_ids(1, 20, 3)), max_new_tokens=3)
    assert calls == []


@pytest.mark.parametrize("nb", [2, 3])
def test_beam_search_identical_to_jax(models, nb):
    jm, tm = models
    ids = _ids(2, 9, seed=nb)
    ref = _jax(jm, ids, max_new_tokens=6, num_beams=nb)
    np.testing.assert_array_equal(_port(tm, ids, max_new_tokens=6, num_beams=nb), ref)


def test_greedy_eos_identical_to_jax(moe):
    jm, tm = moe
    ids = _ids(2, 6, seed=11)
    plain = _port(tm, ids, max_new_tokens=8)
    eos = int(plain[1, 6 + 2])
    np.testing.assert_array_equal(_port(tm, ids, max_new_tokens=8, eos_token_id=eos),
                                  _jax(jm, ids, max_new_tokens=8, eos_token_id=eos))


def test_top_k_1_sampling_equals_greedy(models):
    _, tm = models
    ids = _ids(2, 7, seed=21)
    greedy = _port(tm, ids, max_new_tokens=8)
    sampled = _port(tm, ids, max_new_tokens=8, temperature=0.7, top_k=1, seed=3)
    np.testing.assert_array_equal(sampled, greedy)


def test_sampling_is_seeded(moe):
    _, tm = moe
    ids = _ids(1, 7, seed=22)
    kw = dict(max_new_tokens=12, temperature=1.5, top_k=50, top_p=0.95)
    a = _port(tm, ids, seed=7, **kw)
    np.testing.assert_array_equal(a, _port(tm, ids, seed=7, **kw))
    assert not np.array_equal(a, _port(tm, ids, seed=8, **kw))


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_predictor_over_http_matches_direct_and_jax(moe):
    jm, tm = moe
    pred = GenerationPredictor(tm, max_new_tokens=5).warmup(prompt_len=12)
    server = serve(pred, port=0, block=False)
    port = server.server_address[1]
    try:
        traces = tm._gen_fns["greedy"].trace_count
        for seed in (31, 32, 33):
            p = _ids(1, 12, seed=seed)[0]
            code, body = _post(port, {"input_ids": p.tolist()})
            assert code == 200
            assert body["tokens"] == pred.generate(p).tolist()
            assert body["tokens"] == JaxPredictor(jm, max_new_tokens=5).generate(p).tolist()
        assert tm._gen_fns["greedy"].trace_count == traces  # warmed: no trace
        assert _post(port, {"input_ids": [1, 2, 999]})[0] == 400  # out of vocab
    finally:
        server.stop()
