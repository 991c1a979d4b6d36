"""Lock-step generation of the port (`LlamaForCausalLM.generate` over static
KV caches, `GenerationPredictor` behind `serve()`) against the JAX package,
on shared weights, on the CPU.

A tiny float32 Llama (GQA, 2 kv heads) is built by the JAX package after
`paddle.seed`; its state goes through numpy into the port.  Greedy and
beam-search tokens must be identical.  Sampled paths are held by top_k=1
equalling greedy and by seeded repeatability (JAX keys and torch
generators draw different numbers).
"""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import GenerationPredictor as JaxPredictor
from paddle_tpu.models import _utils as jutils
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.framework import core as pcore
from paddle_tpu_torch.inference import GenerationPredictor, serve
from paddle_tpu_torch.models import _utils as putils
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa


def _ids(b, s, seed):
    return np.random.RandomState(seed).randint(1, 250, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(41)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


def _jax(jm, ids, **kw):
    return np.asarray(jm.generate(paddle.to_tensor(ids), **kw).numpy())


def _port(tm, ids, **kw):
    return tm.generate(torch.from_numpy(ids), **kw).numpy()


@pytest.mark.parametrize("s0", [8, 70])
def test_greedy_tokens_identical_to_jax(models, s0):
    """8 tokens: the dense path on both sides; 70 (>= 64, a 128-row cache):
    the port's prefill takes `dense_decode` where the reference takes its
    Pallas kernel, run in interpret mode for the second comparison."""
    jm, tm = models
    ids = _ids(2, s0, seed=s0)
    pfa.reset_launch_counts()
    got = _port(tm, ids, max_new_tokens=10)
    assert got.shape == (2, s0 + 10) and got.dtype == np.int32
    np.testing.assert_array_equal(got, _jax(jm, ids, max_new_tokens=10))
    if s0 >= 64:
        saved = jfa._FORCE_INTERPRET
        jfa._FORCE_INTERPRET = True
        try:
            np.testing.assert_array_equal(got, _jax(jm, ids, max_new_tokens=10))
        finally:
            jfa._FORCE_INTERPRET = saved
    assert pfa.launch_counts["dense_decode"] == 0  # CPU: the plain version


def test_prefill_takes_dense_decode_at_64_rows(models, monkeypatch):
    _, tm = models
    calls = []
    real = pfa.dense_decode
    monkeypatch.setattr(pfa, "dense_decode",
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


def test_beam_search_with_eos_and_length_penalty_identical_to_jax(models):
    jm, tm = models
    ids = _ids(2, 9, seed=5)
    plain = _jax(jm, ids, max_new_tokens=8, num_beams=3)
    eos = int(plain[0, 9 + 1])  # a token the beams reach early
    kw = dict(max_new_tokens=8, num_beams=3, eos_token_id=eos, length_penalty=1.0)
    ref = _jax(jm, ids, **kw)
    np.testing.assert_array_equal(_port(tm, ids, **kw), ref)


def test_greedy_eos_stops_and_trims_like_jax(models):
    jm, tm = models
    ids = _ids(2, 6, seed=11)
    plain = _port(tm, ids, max_new_tokens=8)
    eos = int(plain[1, 6 + 2])
    ref = _jax(jm, ids, max_new_tokens=8, eos_token_id=eos)
    got = _port(tm, ids, max_new_tokens=8, eos_token_id=eos)
    np.testing.assert_array_equal(got, ref)
    first = 6 + int(np.argmax(got[1, 6:] == eos))
    assert (got[1, first:] == eos).all()  # a finished row emits eos
    one = _port(tm, ids[1:], max_new_tokens=8, eos_token_id=eos)  # trimmed
    np.testing.assert_array_equal(one, got[1:, :first + 1])


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (5, 1.0), (0, 0.8), (7, 0.6)])
def test_filter_logits_equals_reference(top_k, top_p):
    import jax.numpy as jnp

    lg = np.random.RandomState(top_k).randn(3, 50).astype(np.float32) * 3
    ref = np.asarray(jutils._filter_logits_array(jnp.asarray(lg), top_k, top_p))
    got = putils._filter_logits(torch.from_numpy(lg), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, ref)


def test_top_k_1_sampling_equals_greedy(models):
    _, tm = models
    ids = _ids(2, 7, seed=21)
    greedy = _port(tm, ids, max_new_tokens=8)
    sampled = _port(tm, ids, max_new_tokens=8, temperature=0.7, top_k=1, seed=3)
    np.testing.assert_array_equal(sampled, greedy)


def test_sampling_is_seeded(models):
    _, tm = models
    ids = _ids(1, 7, seed=22)
    kw = dict(max_new_tokens=12, temperature=1.5, top_k=50, top_p=0.95)
    a = _port(tm, ids, seed=7, **kw)
    np.testing.assert_array_equal(a, _port(tm, ids, seed=7, **kw))
    assert not np.array_equal(a, _port(tm, ids, seed=8, **kw))


def test_over_long_prompt_returns_its_input(models):
    _, tm = models
    ids = torch.from_numpy(_ids(1, tm.config.max_position_embeddings, seed=1))
    assert tm.generate(ids, max_new_tokens=4) is ids


@pytest.mark.parametrize("kw,match", [
    (dict(decode_strategy="nucleus"), "decode_strategy"),
    (dict(decode_strategy="beam_search"), "num_beams > 1"),
    (dict(decode_strategy="sampling"), "temperature > 0"),
])
def test_strategy_errors(models, kw, match):
    _, tm = models
    with pytest.raises(ValueError, match=match):
        tm.generate(torch.from_numpy(_ids(1, 4, 0)), max_new_tokens=2, **kw)


def test_out_of_vocab_ids_raise(models):
    _, tm = models
    with pytest.raises(ValueError, match="vocabulary"):
        tm.generate(torch.tensor([[1, 2, 300]], dtype=torch.int32))


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/generate", json.dumps(body).encode(),
        {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture
def predictor_server(models):
    _, tm = models
    pred = GenerationPredictor(tm, max_new_tokens=5).warmup()
    server = serve(pred, port=0, block=False)
    yield pred, server.server_address[1]
    server.stop()


def test_predictor_over_http_matches_direct_and_jax(models, predictor_server):
    jm, _ = models
    pred, port = predictor_server
    p = _ids(1, 12, seed=31)[0]
    code, body = _post(port, {"input_ids": p.tolist()})
    assert code == 200
    direct = pred.generate(p)
    assert body["tokens"] == direct.tolist()
    assert body["tokens"] == JaxPredictor(jm, max_new_tokens=5).generate(p).tolist()
    # eos is forwarded: the reply stops at it
    eos = direct[0, 12 + 1]
    code, body = _post(port, {"input_ids": p.tolist(), "max_new_tokens": 5,
                              "eos_token_id": int(eos)})
    assert code == 200 and body["tokens"] == [direct[0, :14].tolist()]
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz") as r:
        assert json.loads(r.read()) == {"status": "ready"}


def test_predictor_bad_body_is_400(predictor_server):
    _, port = predictor_server
    assert _post(port, {"prompt": [1, 2]})[0] == 400
    assert _post(port, {"input_ids": [1, 2, 999]})[0] == 400  # out of vocab


def test_predictor_busy_gate_answers_503(models, monkeypatch):
    """Past FLAGS_serve_queue_depth running or waiting requests the server
    sheds with 503; requests to the one model run one at a time."""
    _, tm = models
    monkeypatch.setitem(pcore._flags, "FLAGS_serve_queue_depth", 1)
    entered, release = threading.Event(), threading.Event()
    pred = GenerationPredictor(tm, max_new_tokens=2)
    real = pred.generate

    def slow(*a, **kw):
        entered.set()
        release.wait(60)
        return real(*a, **kw)

    pred.generate = slow
    server = serve(pred, port=0, block=False)
    port = server.server_address[1]
    try:
        first = []
        t = threading.Thread(target=lambda: first.append(
            _post(port, {"input_ids": [1, 2, 3]})))
        t.start()
        assert entered.wait(60)  # the first request holds the gate
        code, body = _post(port, {"input_ids": [4, 5]})
        assert code == 503 and body["retriable"] is True
        release.set()
        t.join(60)
        assert first[0][0] == 200 and len(first[0][1]["tokens"][0]) == 5
    finally:
        release.set()
        server.stop()
