"""The port's `/generate`, `/health` and `/healthz` contract against the
reference's `serve()` on the CPU.

Tiny Llamas on shared weights (`load_reference_state`) behind both servers;
the same bodies go to each, and the status codes, `Retry-After` headers and
JSON bodies must be equal (their `trace_id`s aside: each server mints its
own):

- a batched body `[a, b]`, a ragged pair and a flat prompt: one token row
  per input row, a flat answer to a flat body;
- an engine refusal partway through a batch (`QueueFull`: 503 with
  Retry-After) and a prompt past the context (`ContextOverflow`: typed 400
  with the capacity geometry);
- bodies that fail inside the engine or before it: 400 with "Type: message";
- `GET /health`;
- `/healthz` at cp=1 and cp=2 (`mesh_shape` keeps the axes larger than 1,
  `tp`), and `tokens_per_step` after a speculative run against the JAX spec
  engine's.

The servers' engines run on their own threads, one request at a time where
the order of scheduling steps matters (the tokens-per-step EWMA).
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

# 7 pages of 8 rows, 6 usable: a 40-token prompt with 16 new tokens needs 7
# and is refused at admission, a 5-token one needs 3
ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8, pool_pages=7)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32).tolist()


def _cycle_prompt(n=20, period=6, seed=7):
    """A repetitive prompt, on which prompt-lookup drafting accepts."""
    return (_prompt(period, seed=seed) * -(-n // period))[:n]


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


class _Pair:
    """The reference's and the port's servers over engines of the same
    configuration on the same weights."""

    def __init__(self, models, **kw):
        jm, tm = models
        self.ref = jinference.serve(JaxEngine(jm, **{**ENGINE, **kw}), port=0,
                                    block=False, supervise=False,
                                    handle_signals=False)
        self.port = tinference.serve(
            ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw}),
            port=0, block=False)

    def close(self):
        self.ref.engine.stop()
        self.ref.shutdown()
        self.ref.server_close()
        self.port.stop()

    @staticmethod
    def _call(server, path, body):
        url = f"http://127.0.0.1:{server.server_address[1]}{path}"
        data = None if body is None else (
            body if isinstance(body, bytes) else json.dumps(body).encode())
        req = urllib.request.Request(url, data=data,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                return resp.status, resp.headers.get("Retry-After"), json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, e.headers.get("Retry-After"), json.loads(e.read())

    def both(self, path, body=None):
        """(reference answer, port answer) to the same request, each as
        (status, Retry-After header, JSON body less trace_id)."""
        out = []
        for server in (self.ref, self.port):
            code, retry, payload = self._call(server, path, body)
            payload.pop("trace_id", None)
            out.append((code, retry, payload))
        return tuple(out)


@pytest.fixture(scope="module")
def pair(models):
    p = _Pair(models)
    yield p
    p.close()


def test_refusal_partway_through_a_batch_answers_503_as_the_reference(pair):
    # first in the file: on fresh engines both drain estimates are 0
    ref, port = pair.both("/generate", {"input_ids": [_prompt(5, 1), _prompt(40, 2)],
                                        "max_new_tokens": 16})
    assert port == ref
    code, retry, body = port
    assert code == 503 and retry == "1"
    assert body["type"] == "QueueFull" and body["retriable"] is True
    assert body["retry_after_s"] == 0


@pytest.mark.parametrize("ids", [
    [_prompt(6, 3), _prompt(6, 4)],        # [a, b]
    [_prompt(9, 5), _prompt(4, 6)],        # a ragged pair
    _prompt(7, 7),                         # a flat prompt
], ids=["batch", "ragged-pair", "flat"])
def test_generate_answers_one_row_per_input_row(pair, ids):
    ref, port = pair.both("/generate", {"input_ids": ids, "max_new_tokens": 5})
    assert port == ref
    code, _, body = port
    assert code == 200
    if isinstance(ids[0], list):
        assert [len(r) for r in body["tokens"]] == [len(r) + 5 for r in ids]
        assert [r[:len(p)] for r, p in zip(body["tokens"], ids)] == ids
    else:
        assert len(body["tokens"]) == len(ids) + 5


@pytest.mark.parametrize("body", [
    {"input_ids": [_prompt(4, 8), []]},                   # an empty row
    {"input_ids": _prompt(4, 9), "temperature": "hot"},    # not a float
    {"max_new_tokens": 3},                                 # no input_ids
    b"{not json",
], ids=["empty-row", "bad-temperature", "no-ids", "not-json"])
def test_bad_bodies_answer_400_with_type_and_message(pair, body):
    ref, port = pair.both("/generate", body)
    code, retry, payload = port
    assert code == 400 and retry is None
    assert payload["error"].startswith(payload["type"] + ": ")
    assert payload["retriable"] is False and payload["retry_after_s"] == 0
    assert port == ref


def test_context_overflow_answers_typed_400_with_capacity(pair):
    ref, port = pair.both("/generate", {"input_ids": _prompt(64, 10)})
    assert port == ref
    code, _, body = port
    assert code == 400 and body["type"] == "ContextOverflow"
    assert body["capacity"]["max_len"] == 64 and body["retry_after_s"] == 0


def test_health_answers_ok(pair):
    ref, port = pair.both("/health")
    assert port == ref == (200, None, {"status": "ok"})


def _mesh_fields(h):
    return {k: h[k] for k in ("mesh_shape", "tp", "cp", "tokens_per_step")}


def test_healthz_mesh_at_cp1_matches_reference(pair):
    ref, port = pair.both("/healthz")
    assert port[0] == ref[0] == 200
    assert _mesh_fields(port[2]) == _mesh_fields(ref[2])
    assert port[2]["mesh_shape"] == {} and port[2]["tp"] == 1
    assert port[2]["tokens_per_step"] == 1.0


def test_healthz_mesh_at_cp2_matches_reference(models):
    p = _Pair(models, cp=2, pool_pages=None)
    try:
        ref, port = p.both("/healthz")
    finally:
        p.close()
    assert _mesh_fields(port[2]) == _mesh_fields(ref[2])
    assert port[2]["mesh_shape"] == {"cp": 2} and port[2]["cp"] == 2


def test_tokens_per_step_after_a_spec_run_matches_the_jax_spec_engine(models):
    p = _Pair(models, spec_k=2, pool_pages=None)
    try:
        # one request at a time: every verify step holds one slot, so both
        # engines update the EWMA over the same accepted runs
        for ids, new in ((_cycle_prompt(), 16), (_cycle_prompt(14, 4, seed=5), 12)):
            ref, port = p.both("/generate", {"input_ids": ids, "max_new_tokens": new})
            assert port == ref and port[0] == 200
        ref, port = p.both("/healthz")
    finally:
        p.close()
    assert port[2]["tokens_per_step"] == ref[2]["tokens_per_step"]
    assert port[2]["tokens_per_step"] > 1.0  # drafts were accepted
