"""The port's serving fault domain over HTTP, against the reference's
`serve()` on the CPU: `/generate`'s answers to each fault, `/healthz`,
drain (programmatic and by SIGTERM) and the SIGTERM handler's lifetime.

Tiny Llamas on shared weights (`load_reference_state`) behind both
servers, as in `test_torch_serve_contract.py`.  Each fault is produced
the same way on both engines (the same fault point armed in each
package's registry, the same seeded step time, or `fail_all`), and the
answers must agree: status, `Retry-After`, and the JSON body less the
reference's `trace_id`, with request ids masked where the message names
one (the two engines number requests apart):

- a deadline the queue-drain estimate cannot meet: 504
  DeadlineUnattainable, retriable, Retry-After from the estimate;
- a deadline that passes in flight: 504 DeadlineExceeded, not retriable;
- a NaN-poisoned decode step: 500 NonFiniteLogits;
- a request in flight when the engine dies: 503 EngineRestarted;
- a dead engine: 503 EngineUnavailable.

Then the reference's HTTP drills on the port: `/healthz` of a fresh
engine (beside the reference's), SIGTERM drain, a supervised prefill hang
answered 200 with the reference model's tokens, `server.drain()` with
requests in flight.  The SIGTERM handler serve() installs stays out of
forked children (they start with SIG_DFL) and goes back to the previous
handler when the server stops.  Hangs are fractions of a second; every
wait is bounded.
"""

import json
import os
import re
import signal
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import inference as jinference
from paddle_tpu.fault import injection as jinj
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import inference as tinference
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    EngineUnavailable,
)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0)
WAIT_S = 30


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
    paddle.seed(4321)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


def _arm(spec, hang_sec=None):
    """Arm `spec` in both packages' registries."""
    for inj, set_flags in ((jinj, paddle.set_flags), (tinj, tcore.set_flags)):
        if hang_sec is not None:
            set_flags({"FLAGS_fault_hang_sec": hang_sec})
        inj.arm(spec)


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    for inj, set_flags in ((jinj, paddle.set_flags), (tinj, tcore.set_flags)):
        inj.disarm()
        set_flags({"FLAGS_fault_hang_sec": 3600.0,
                   "FLAGS_serve_step_timeout_sec": 0.0})


def _call(port, path, body=None, headers=None, timeout=120):
    """(status, Retry-After header, JSON body less trace_id)."""
    url = f"http://127.0.0.1:{port}{path}"
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        "Content-Type": "application/json", **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            out = resp.status, resp.headers.get("Retry-After"), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        out = e.code, e.headers.get("Retry-After"), json.loads(e.read())
    out[2].pop("trace_id", None)
    return out


def _masked(answer):
    code, retry, body = answer
    if "error" in body:
        body = dict(body, error=re.sub(r"request \d+", "request N", body["error"]))
    return code, retry, body


def _until(cond, timeout=10.0):
    t_end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > t_end:
            raise TimeoutError("condition not reached")
        time.sleep(0.005)


class _Pair:
    def __init__(self, models):
        jm, tm = models
        self.engines = (JaxEngine(jm, **ENGINE),
                        ContinuousBatchingEngine(tm, device="cpu", **ENGINE))
        for e in self.engines:
            e.warmup()
        self.servers = (
            jinference.serve(self.engines[0], port=0, block=False,
                             supervise=False, handle_signals=False),
            tinference.serve(self.engines[1], port=0, block=False,
                             supervise=False, handle_signals=False),
        )

    def ports(self):
        return [s.server_address[1] for s in self.servers]

    def both(self, body, headers=None):
        """Post `body` to both servers at once; (reference, port) answers."""
        out = [None, None]

        def post(i, port):
            out[i] = _call(port, "/generate", body, headers)

        threads = [threading.Thread(target=post, args=(i, p))
                   for i, p in enumerate(self.ports())]
        for t in threads:
            t.start()
        return threads, out

    def close(self):
        self.engines[0].stop()
        self.servers[0].shutdown()
        self.servers[0].server_close()
        self.servers[1].stop()


@pytest.fixture(scope="module")
def pair(models):
    p = _Pair(models)
    yield p
    p.close()


def _join(threads):
    for t in threads:
        t.join(WAIT_S)
    assert not any(t.is_alive() for t in threads)


def _unattainable(pair):
    """Both schedulers hang in the prefill of one request while a second
    waits with 20 tokens owed; at 0.5 s a step the drain estimate is
    ceil(20 / 3) x 0.5 = 3.5 s, past the POST's 2 s deadline."""
    _arm("serve.prefill.hang", hang_sec=1.0)
    held = [e.submit(_prompt(5, 1), max_new_tokens=4) for e in pair.engines]
    _until(lambda: all(e._admitting is r for e, r in zip(pair.engines, held)))
    queued = [e.submit(_prompt(5, 2), max_new_tokens=20) for e in pair.engines]
    for e in pair.engines:
        e._step_ewma_s = 0.5
    threads, out = pair.both({"input_ids": _prompt(6, 3).tolist(),
                              "deadline_s": 2.0})
    _join(threads)
    for r in held + queued:
        r.wait(WAIT_S)
    return out


def _exceeded_in_flight(pair):
    """The prefill hangs past the 0.3 s deadline: the request lands, emits
    its first token, decodes one step, and the next step evicts it."""
    _arm("serve.prefill.hang", hang_sec=0.5)
    threads, out = pair.both({"input_ids": _prompt(5, 4).tolist(),
                              "max_new_tokens": 50, "deadline_s": 0.3})
    _join(threads)
    return out


def _nonfinite(pair):
    _arm("serve.decode.nan")
    threads, out = pair.both({"input_ids": _prompt(7, 5).tolist(),
                              "max_new_tokens": 6})
    _join(threads)
    return out


def _restarted(pair):
    """The engine dies (fail_all) while the request hangs in its prefill."""
    _arm("serve.prefill.hang", hang_sec=1.0)
    threads, out = pair.both({"input_ids": _prompt(5, 6).tolist(),
                              "max_new_tokens": 6})
    _until(lambda: all(e._admitting is not None for e in pair.engines))
    for e in pair.engines:
        e.fail_all("drill")
    _join(threads)
    return out


def _dead(pair):
    threads, out = pair.both({"input_ids": _prompt(5, 7).tolist()})
    _join(threads)
    return out


# in this order: the last two kill the pair's engines
@pytest.mark.parametrize("fault,status,err_type,retriable", [
    (_unattainable, 504, "DeadlineUnattainable", True),
    (_exceeded_in_flight, 504, "DeadlineExceeded", False),
    (_nonfinite, 500, "NonFiniteLogits", False),
    (_restarted, 503, "EngineRestarted", True),
    (_dead, 503, "EngineUnavailable", True),
], ids=["unattainable", "exceeded-in-flight", "nonfinite", "restarted", "dead"])
def test_each_fault_answers_the_references_status_and_body(pair, fault, status,
                                                           err_type, retriable):
    ref, port = (_masked(a) for a in fault(pair))
    assert port == ref
    code, retry, body = port
    assert code == status and body["type"] == err_type
    assert body["retriable"] is retriable
    assert (retry is not None) == retriable  # every retriable answer says when


def test_healthz_reports_engine_state(models):
    p = _Pair(models)
    try:
        (rc, _, ref), (pc, _, port) = (_call(q, "/healthz") for q in p.ports())
    finally:
        p.close()
    keys = ("status", "slots", "active_slots", "queue_depth", "restarts",
            "drain_estimate_s", "decode_ewma_ms", "deadline_miss_rate")
    assert pc == rc == 200
    assert {k: port[k] for k in keys} == {k: ref[k] for k in keys}
    assert port["status"] == "ready" and port["restarts"] == 0


def test_sigterm_drain_finishes_inflight_and_sheds_new(models):
    """SIGTERM -> drain: /healthz reads draining, a new POST sheds with 503
    and Retry-After, the in-flight request finishes within the grace, the
    engine stops; stop() then puts the previous handler back."""
    prev = signal.getsignal(signal.SIGTERM)
    eng = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE)
    eng.warmup()
    eng._step_ewma_s = 0.01  # evidence for a nonzero Retry-After estimate
    srv = tinference.serve(eng, port=0, block=False, supervise=False,
                           handle_signals=True)
    port = srv.server_address[1]
    try:
        r = eng.submit(_prompt(5, 11), max_new_tokens=50)
        signal.raise_signal(signal.SIGTERM)
        code, _, body = _call(port, "/healthz")
        assert code == 503 and body["status"] == "draining"
        code, retry, body = _call(port, "/generate", {
            "input_ids": _prompt(4).tolist(), "max_new_tokens": 2})
        assert code == 503 and body["type"] == "Draining" and int(retry) >= 1
        with pytest.raises(EngineUnavailable):
            eng.submit(_prompt(4), max_new_tokens=2)
        th = srv.drain()  # idempotent: hands back the worker
        th.join(WAIT_S)
        assert not th.is_alive()
        out = r.wait(1)
        assert len(out) == 5 + 50 and r.finish_reason == "length"
        assert eng._thread is None
    finally:
        srv.stop()
    assert signal.getsignal(signal.SIGTERM) is prev


def test_http_chaos_drill_end_to_end(models):
    """serve() under supervision, a prefill hang injected: the POST comes
    back 200 with the reference model's tokens, /healthz reports one
    restart, nothing retraced."""
    jm, tm = models
    tcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.1})
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    eng.warmup()
    warm = eng.compile_counts()
    p = _prompt(5, seed=21)
    ref = jm.generate(paddle.to_tensor(p[None]), max_new_tokens=6).numpy()[0]
    srv = tinference.serve(eng, port=0, block=False, supervise=True,
                           handle_signals=False)
    srv.supervisor.poll_interval = 0.02
    srv.supervisor.backoff = 0.0
    port = srv.server_address[1]
    try:
        tcore.set_flags({"FLAGS_fault_hang_sec": 0.5})
        tinj.arm("serve.prefill.hang")
        code, _, body = _call(port, "/generate", {"input_ids": p.tolist(),
                                                  "max_new_tokens": 6})
        assert code == 200 and body["tokens"] == ref.tolist()
        code, _, body = _call(port, "/healthz")
        assert code == 200 and body["restarts"] == 1
        assert eng.compile_counts() == warm
    finally:
        srv.stop()


def test_drain_lets_inflight_posts_finish_and_sheds_new_ones(models):
    """server.drain() with POSTs in flight: they answer 200 in full, a new
    POST answers 503 with Retry-After, /healthz reads draining."""
    eng = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE)
    eng.warmup()
    srv = tinference.serve(eng, port=0, block=False, supervise=True,
                           handle_signals=False)
    port = srv.server_address[1]
    answers = {}

    def post(i):
        answers[i] = _call(port, "/generate", {
            "input_ids": _prompt(5 + i, 40 + i).tolist(), "max_new_tokens": 40})

    threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
    try:
        for t in threads:
            t.start()
        _until(lambda: eng.active_slots == 2)
        th = srv.drain(grace=WAIT_S)
        code, retry, body = _call(port, "/generate", {
            "input_ids": _prompt(4).tolist(), "max_new_tokens": 2})
        assert code == 503 and retry is not None and int(retry) >= 1
        code, _, body = _call(port, "/healthz")
        assert code == 503 and body["status"] == "draining"
        _join(threads)
        th.join(WAIT_S)
        assert not th.is_alive()
    finally:
        srv.stop()
    for i in range(2):
        code, _, body = answers[i]
        assert code == 200 and len(body["tokens"]) == 5 + i + 40


def test_sigterm_handler_stays_out_of_forked_children_and_goes_back_at_stop(models):
    """The guard against a forked child that inherits the drain handler and
    then ignores its parent's SIGTERM: a child forked while the server
    runs starts with SIG_DFL, and stopping the server restores the handler
    that was there before."""
    prev = signal.getsignal(signal.SIGTERM)
    eng = ContinuousBatchingEngine(models[1], device="cpu", **ENGINE)
    srv = tinference.serve(eng, port=0, block=False, supervise=False,
                           handle_signals=True)
    try:
        installed = signal.getsignal(signal.SIGTERM)
        assert callable(installed) and installed is not prev
        pid = os.fork()
        if pid == 0:  # the child: report its handler through the exit code
            os._exit(0 if signal.getsignal(signal.SIGTERM) == signal.SIG_DFL else 1)
        t_end = time.monotonic() + WAIT_S
        done, status = os.waitpid(pid, os.WNOHANG)
        while not done and time.monotonic() < t_end:
            time.sleep(0.01)
            done, status = os.waitpid(pid, os.WNOHANG)
        if not done:  # never leave a stuck child holding the run's pipes
            os.kill(pid, signal.SIGKILL)
            os.waitpid(pid, 0)
        assert done, "forked child did not exit"
        assert os.waitstatus_to_exitcode(status) == 0
        assert signal.getsignal(signal.SIGTERM) is installed  # the parent keeps it
    finally:
        srv.stop()
    assert signal.getsignal(signal.SIGTERM) is prev
