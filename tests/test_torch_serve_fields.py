"""The request fields and headers of `/generate` beyond the five the port
generates with, against the reference's `serve()` on the CPU.

Tiny Llamas on shared weights (`load_reference_state`) behind both servers,
as in `test_torch_serve_contract.py`:

- a spent deadline (`X-Deadline-Ms: 0`, `deadline_s` 0 or -1) answers 504
  DeadlineExceeded, not retriable, and admits nothing; `adapter` on an
  engine without a LoRA arena answers the reference's 400 ValueError: status
  and body equal to the reference's (less its `trace_id`);
- a live deadline (`deadline_s`, `X-Deadline-Ms`, the body's over the
  header's) is served as the reference serves it: the same status and
  tokens, every row admitted;
- `session_id` is served as the reference serves it (both engines keep
  sessions on their prefix cache): 200 and the same tokens, turn after
  turn;
- `handoff` and `reservation` are served as the reference serves them on
  a colocated engine: a handoff answers the reference's 400 ValueError
  (the role), an unknown reservation is a no-op (200, the same tokens); a
  decode-role engine answers a bad handoff with 400 HandoffFormatError;
- `X-Idempotency-Key`: a key posted twice generates once and replays the
  same body with `X-Idempotency-Replay: hit` (admissions counted at
  `submit`, on both servers); two concurrent posts of one key admit once
  and the second joins the first (`X-Idempotency-Replay: join`); a
  retriable 503 is not cached, so its keyed retry executes again.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch import profiler as tprofiler
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

# 7 pages of 8 rows, 6 usable: a 40-token prompt with 16 new tokens needs 7
# and is refused at submit (a retriable 503)
ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8, pool_pages=7)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32).tolist()


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _count_submits(engine):
    """Wrap `engine.submit` to count admissions; returns the list it
    appends to."""
    calls = []
    real = engine.submit

    def submit(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    engine.submit = submit
    return calls


class _Pair:
    def __init__(self, models):
        np.random.seed(1234)
        jm, tm = models
        self.ref = jinference.serve(JaxEngine(jm, **ENGINE), port=0, block=False,
                                    supervise=False, handle_signals=False)
        self.port = tinference.serve(
            ContinuousBatchingEngine(tm, device="cpu", **ENGINE), port=0,
            block=False)
        self.submits = {"ref": _count_submits(self.ref.engine),
                        "port": _count_submits(self.port.engine)}

    def close(self):
        self.ref.engine.stop()
        self.ref.shutdown()
        self.ref.server_close()
        self.port.stop()

    @staticmethod
    def call(server, body, headers=None):
        """(status, X-Idempotency-Replay header, JSON body less trace_id)."""
        url = f"http://127.0.0.1:{server.server_address[1]}/generate"
        req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={
            "Content-Type": "application/json", **(headers or {})})
        try:
            with urllib.request.urlopen(req, timeout=300) as resp:
                out = resp.status, resp.headers, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            out = e.code, e.headers, json.loads(e.read())
        out[2].pop("trace_id", None)
        return out[0], out[1].get("X-Idempotency-Replay"), out[2]

    def both(self, body, headers=None):
        return (self.call(self.ref, body, headers),
                self.call(self.port, body, headers))

    def admissions(self):
        return {k: len(v) for k, v in self.submits.items()}


@pytest.fixture(scope="module")
def pair():
    paddle.seed(47)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    p = _Pair((jm, load_reference_state(tm, state)))
    yield p
    p.close()


@pytest.mark.parametrize("body,headers", [
    ({"input_ids": _prompt(5, 1)}, {"X-Deadline-Ms": "0"}),
    ({"input_ids": _prompt(5, 2), "deadline_s": 0}, None),
    ({"input_ids": _prompt(5, 3), "deadline_s": -1}, None),
    ({"input_ids": [_prompt(5, 4), _prompt(6, 5)]}, {"X-Deadline-Ms": "-20"}),
], ids=["header-0", "body-0", "body-negative", "batch-header-negative"])
def test_spent_deadline_answers_504_before_admission(pair, body, headers):
    before = pair.admissions()
    ref, port = pair.both(body, headers)
    assert port == ref
    code, _, payload = port
    assert code == 504 and payload == {
        "error": "deadline exhausted before admission", "type": "DeadlineExceeded",
        "retriable": False, "retry_after_s": 0}
    assert pair.admissions() == before  # nothing reached submit


@pytest.mark.parametrize("adapter", ["tenant-a", 3])
def test_adapter_without_a_lora_arena_answers_the_references_400(pair, adapter):
    ref, port = pair.both({"input_ids": _prompt(5, 6), "adapter": adapter})
    assert port == ref
    code, _, payload = port
    assert code == 400 and payload["type"] == "ValueError"
    assert payload["retriable"] is False and "no LoRA arena" in payload["error"]


def test_adapter_0_is_the_base_model_as_in_the_reference(pair):
    ref, port = pair.both({"input_ids": _prompt(5, 7), "adapter": 0,
                           "max_new_tokens": 4})
    assert port == ref and port[0] == 200


@pytest.mark.parametrize("body,headers", [
    ({"input_ids": _prompt(5, 14), "max_new_tokens": 4, "deadline_s": 30.0}, None),
    ({"input_ids": _prompt(6, 15), "max_new_tokens": 4}, {"X-Deadline-Ms": "30000"}),
    ({"input_ids": [_prompt(5, 16), _prompt(7, 17)], "max_new_tokens": 3,
      "deadline_s": 60}, {"X-Deadline-Ms": "1"}),
], ids=["body", "header", "batch-body-over-header"])
def test_a_live_deadline_is_served_as_the_reference_serves_it(pair, body, headers):
    before = pair.admissions()
    ref, port = pair.both(body, headers)
    assert port == ref
    assert port[0] == 200 and port[1] is None
    rows = len(body["input_ids"]) if isinstance(body["input_ids"][0], list) else 1
    after = pair.admissions()
    assert {k: after[k] - before[k] for k in after} == {"ref": rows, "port": rows}


def test_session_id_is_served_as_the_reference_serves_it(pair):
    before = pair.admissions()
    conv = _prompt(9, 18)
    for turn in range(2):
        ref, port = pair.both({"input_ids": conv, "max_new_tokens": 4,
                               "session_id": "chat-7"})
        assert port == ref and port[0] == 200
        conv = port[2]["tokens"] + _prompt(2, 19 + turn)
    after = pair.admissions()
    assert {k: after[k] - before[k] for k in after} == {"ref": 2, "port": 2}
    assert pair.port.engine._sessions.get("chat-7")["turns"] == 2


@pytest.mark.parametrize("field,value", [
    ("handoff", {"prompt_len": 5}),
    ("reservation", "r-1"),
], ids=["handoff-value0-disaggregated prefill/decode",
        "reservation-r-1-disaggregated prefill/decode"])
def test_unported_fields_answer_a_typed_400_naming_their_item(pair, field, value):
    """The disaggregation fields, ported: on the pair's colocated engines
    both servers answer alike (a handoff is refused inside `submit` with
    the reference's ValueError, an unknown reservation is a no-op); a
    decode-role engine answers the bad handoff with a typed 400
    HandoffFormatError."""
    before = pair.admissions()
    body = {"input_ids": _prompt(5, 8), "max_new_tokens": 4, field: value}
    ref, port = pair.both(body)
    assert port == ref
    after = pair.admissions()
    assert {k: after[k] - before[k] for k in after} == {"ref": 1, "port": 1}
    code, _, payload = port
    if field == "reservation":
        assert code == 200 and len(payload["tokens"]) == 9
        return
    assert code == 400 and payload["type"] == "ValueError"
    assert payload["retriable"] is False and "'decode' role" in payload["error"]
    dec = tinference.serve(ContinuousBatchingEngine(
        pair.port.engine.model, device="cpu", role="decode", **ENGINE),
        port=0, block=False)
    try:
        code, _, payload = pair.call(dec, body)
    finally:
        dec.stop()
    assert code == 400 and payload["type"] == "HandoffFormatError"
    assert payload["retriable"] is False and payload["retry_after_s"] == 0
    assert payload["error"].startswith("HandoffFormatError: handoff version")


def test_a_key_posted_twice_generates_once(pair):
    body = {"input_ids": [_prompt(6, 9), _prompt(4, 10)], "max_new_tokens": 5}
    key = {"X-Idempotency-Key": "key-twice"}
    before = pair.admissions()
    first = pair.both(body, key)
    again = pair.both(body, key)
    for (code, replay, payload), (code2, replay2, payload2) in zip(first, again):
        assert code == code2 == 200 and replay is None and replay2 == "hit"
        assert payload2 == payload
    assert first[0][2] == first[1][2]  # the port answers the reference's tokens
    after = pair.admissions()
    assert {k: after[k] - before[k] for k in after} == {"ref": 2, "port": 2}


def test_concurrent_posts_of_one_key_admit_once_and_join(pair):
    """The first post holds inside `submit` until the second has joined it
    (counted in `idem_joins`); the second then gets the first's response."""
    engine = pair.port.engine
    counted = engine.submit
    joined = []

    def held(*a, **kw):
        deadline = time.time() + 60
        while tprofiler.router_summary()["idem_joins"] == 0 and time.time() < deadline:
            time.sleep(0.01)
        joined.append(tprofiler.router_summary()["idem_joins"])
        return counted(*a, **kw)

    tprofiler.reset_router()
    engine.submit = held
    before = pair.admissions()["port"]
    body = {"input_ids": _prompt(7, 11), "max_new_tokens": 6}
    key = {"X-Idempotency-Key": "key-concurrent"}
    answers = []
    try:
        threads = [threading.Thread(target=lambda: answers.append(
            pair.call(pair.port, body, key))) for _ in range(2)]
        for t in threads:
            t.start()
            time.sleep(0.2)  # the first reaches submit before the second posts
        for t in threads:
            t.join(120)
    finally:
        engine.submit = counted
    assert joined == [1]
    assert pair.admissions()["port"] == before + 1
    assert sorted(a[1] or "" for a in answers) == ["", "join"]
    assert answers[0][0] == answers[1][0] == 200 and answers[0][2] == answers[1][2]
    # a kind counted beside ROUTER_KEYS earlier in this process (a session
    # pin) stays in the family at 0 after the reset, as in the reference
    counts = {k: v for k, v in tprofiler.router_summary().items() if k != "replica_states"}
    assert counts == {**dict.fromkeys(counts, 0), **dict.fromkeys(tprofiler.ROUTER_KEYS, 0),
                      "idem_joins": 1}


def test_a_retriable_503_is_not_cached(pair):
    """A batch whose second row needs more pages than the pool holds is
    refused with a retriable 503 (its first row still completes): the keyed
    retry executes again, on both servers."""
    body = {"input_ids": [_prompt(5, 12), _prompt(40, 13)], "max_new_tokens": 16}
    key = {"X-Idempotency-Key": "key-shed"}
    before = pair.admissions()
    for _ in range(2):
        ref, port = pair.both(body, key)
        for code, replay, payload in (ref, port):
            assert code == 503 and replay is None
            assert payload["type"] == "QueueFull" and payload["retriable"] is True
    after = pair.admissions()
    assert {k: after[k] - before[k] for k in after} == {"ref": 4, "port": 4}
    # and the same key answers 200 once the request fits
    fits = {"input_ids": [_prompt(5, 12)], "max_new_tokens": 4}
    assert pair.call(pair.port, fits, key)[0] == 200
    assert pair.call(pair.port, fits, key)[:2] == (200, "hit")


def test_cache_keeps_a_response_for_its_ttl_only():
    """`IdempotencyCache` on its own clock: a completed key replays until
    its TTL has passed, then executes again; an abandoned key wakes its
    joiners with no response."""
    from paddle_tpu_torch.serving.journal import IdempotencyCache

    cache = IdempotencyCache(ttl_s=10.0)
    assert cache.begin("k", now=100.0) == ("new", None)
    assert cache.complete("k", 200, {"tokens": [1]}, now=100.0) is True
    assert cache.begin("k", now=109.0) == ("done", (200, {"tokens": [1]}, {}))
    assert cache.begin("k", now=111.0) == ("new", None)  # past the TTL
    verdict, entry = cache.begin("k", now=111.0)
    assert verdict == "join"
    cache.abandon("k")
    assert cache.wait(entry, timeout=1) is None
    assert cache.begin("k", now=112.0) == ("new", None)
