"""The port's serving fault domain on the engine, against the reference on
the CPU: one counterpart of each of `tests/test_serving_fault.py`'s tests
(the HTTP ones are in `test_torch_serving_fault_http.py`), then the parts
the port adds because its steps are CUDA graphs replayed with decode in
flight.

A tiny Llama built by the JAX package, its weights crossing into the port
by `load_reference_state`; every greedy stream the port's engine finishes
after a restart, an eviction or a NaN poison equals the reference model's
lock-step `generate` on the same prompt, token for token.  Faults are
armed through the port's own `fault.injection` registry; hangs and
watchdog deadlines are fractions of a second and every wait is bounded.

Beyond the reference's tests:

- the generation fence: a scheduler thread that wakes from
  `serve.prefill.hang` after the restart replays nothing (the graphs'
  replay counts do not move once the new life is idle) and ends;
- restart() waits out a capture in progress (a StepGraph tracing) and
  gives up on the launch lock after a second otherwise;
- fail_all() resolves every request while another thread holds `_mu` (a
  fetch wedged on the card);
- the poison input of the verify step under speculation, and the poison
  buffer back to all-False on the device after the poisoned step;
- the per-step deadline check flushes nothing without a victim;
- the drain estimate reads the flushed step time (not the dispatch time);
- a restart keeps the prefix cache.
"""

import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.engine import DeadlineUnattainable as JaxUnattainable
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.fault import EngineSupervisor
from paddle_tpu_torch.fault import injection as finj
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    DeadlineExceeded,
    DeadlineUnattainable,
    EngineRestarted,
    EngineUnavailable,
    NonFiniteLogits,
    RequestCancelled,
)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

WAIT_S = 30  # bound of every wait on a request


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture
def model(models):
    return models[1]


@pytest.fixture(autouse=True)
def _clean_fault_state():
    yield
    finj.disarm()
    tcore.set_flags({
        "FLAGS_serve_step_timeout_sec": 0.0,
        "FLAGS_fault_hang_sec": 3600.0,
        "FLAGS_serve_debug_invariants": False,
    })


_refs = {}


@pytest.fixture
def ref(models):
    """The reference model's greedy lock-step tokens: prompt + n."""
    jm = models[0]

    def run(p, n):
        key = (tuple(p.tolist()), n)
        if key not in _refs:
            _refs[key] = jm.generate(paddle.to_tensor(p[None]),
                                     max_new_tokens=n).numpy()[0]
        return _refs[key]

    return run


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _engine(model, **kw):
    kw.setdefault("slots", 3)
    kw.setdefault("max_len", 64)
    kw.setdefault("prefill_buckets", [8, 16])
    kw.setdefault("queue_depth", 16)
    kw.setdefault("seed", 0)
    return ContinuousBatchingEngine(model, device="cpu", **kw)


def _replays(eng):
    return sum(g.replay_count for g in eng.step_graphs().values())


# -- request lifecycle: wait timeouts, cancellation, deadlines ----------------


def test_wait_timeout_names_request_and_state(model):
    eng = _engine(model)
    r = eng.submit(_prompt(4), max_new_tokens=8)
    with pytest.raises(TimeoutError) as ei:
        r.wait(0.01)  # no scheduler: stays queued
    assert f"request {r.id}" in str(ei.value)
    assert "state=queued" in str(ei.value) and "0/8 tokens" in str(ei.value)
    eng.step()  # admit + first decode: now decoding
    with pytest.raises(TimeoutError) as ei:
        r.wait(0.01)
    assert "state=decoding" in str(ei.value)
    eng.run_until_idle()
    assert len(r.wait(1)) == 4 + 8


def test_cancel_queued_resolves_without_slot(model):
    eng = _engine(model)
    warm = eng.compile_counts()
    r = eng.submit(_prompt(4), max_new_tokens=8)
    r.cancel()
    eng.run_until_idle()
    with pytest.raises(RequestCancelled) as ei:
        r.wait(1)
    assert r.finish_reason == "cancelled" and ei.value.tokens_done == 0
    assert eng.compile_counts() == warm  # never prefilled: nothing traced


def test_cancel_slotted_recycles_slot_for_next_request(model, ref):
    pa, pb = _prompt(5, seed=1), _prompt(5, seed=2)
    eng = _engine(model, slots=1)  # one slot: B must reuse A's
    ra = eng.submit(pa, max_new_tokens=40)
    rb = eng.submit(pb, max_new_tokens=6)
    eng.step()
    ra.cancel()
    eng.run_until_idle()
    with pytest.raises(RequestCancelled):
        ra.wait(1)
    assert ra.finish_reason == "cancelled" and 0 < len(ra.tokens) < 40
    assert np.array_equal(rb.wait(1), ref(pb, 6))


def test_deadline_eviction_zero_recompiles(model, ref):
    """A co-batched slot's deadline passes mid-flight: the flush emits its
    dispatched tokens, the slot is recycled for the queued request, the
    other slot's stream is the reference's, and nothing retraces."""
    profiler.reset_serving()
    eng = _engine(model, slots=2)
    eng.warmup()
    warm = eng.compile_counts()
    pa, pb, pc = _prompt(5, seed=3), _prompt(5, seed=4), _prompt(9, seed=5)
    ra = eng.submit(pa, max_new_tokens=59, deadline_s=0.05)
    rb = eng.submit(pb, max_new_tokens=6)
    rc = eng.submit(pc, max_new_tokens=6)  # queued behind the two slots
    eng.step()
    eng.step()  # a decode step in flight for both
    time.sleep(0.1)
    eng.step()  # the eviction: A's slot goes to C
    assert eng._slot_req[0] is rc
    eng.run_until_idle()
    with pytest.raises(DeadlineExceeded) as ei:
        ra.wait(1)
    assert ra.finish_reason == "timeout" and f"request {ra.id}" in str(ei.value)
    assert ei.value.tokens_done == len(ra.tokens) >= 2
    assert np.array_equal(rb.wait(1), ref(pb, 6))
    assert np.array_equal(rc.wait(1), ref(pc, 6))
    assert eng.compile_counts() == warm
    summary = profiler.serving_summary()
    assert summary["faults"]["deadline_miss"] == 1
    assert 0 < summary["deadline_miss_rate"] == eng._miss_ewma
    assert eng.healthz()["deadline_miss_rate"] == round(eng._miss_ewma, 4)


def test_deadline_aware_admission(models):
    """The same submissions against the reference engine and the port's,
    with the same seeded step time: the same admissions and refusals, the
    same Retry-After estimate."""
    jm, tm = models
    profiler.reset_serving()
    kw = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=8, seed=0)
    eng = ContinuousBatchingEngine(tm, device="cpu", **kw)
    jeng = JaxEngine(jm, **kw)
    for e in (eng, jeng):
        r0 = e.submit(_prompt(4), max_new_tokens=4, deadline_s=0.001)
        assert r0.state == "queued"  # no evidence yet: admitted
        e._step_ewma_s = 0.5
        e.submit(_prompt(4), max_new_tokens=20)
    with pytest.raises(DeadlineUnattainable) as ei:
        eng.submit(_prompt(4), max_new_tokens=4, deadline_s=2.0)
    with pytest.raises(JaxUnattainable) as ej:
        jeng.submit(_prompt(4), max_new_tokens=4, deadline_s=2.0)
    assert ei.value.retry_after_s == ej.value.retry_after_s > 2.0
    assert str(ei.value) == str(ej.value)
    assert eng.estimate_drain_s() == jeng.estimate_drain_s()
    assert eng.submit(_prompt(4), max_new_tokens=4, deadline_s=60.0).state == "queued"
    assert profiler.serving_summary()["faults"]["rejected_deadline"] == 1


# -- chaos drills: hang -> watchdog -> warm restart, NaN, loop crash ------------


def test_prefill_hang_watchdog_restart_bit_identical(model, ref):
    """The injected prefill hang trips the watchdog, the supervisor makes
    one warm restart, the hung request is requeued and both finish with
    the reference's tokens, with no new trace.  The hung thread wakes after
    the restart and replays nothing: the graphs' replay counts do not move
    once the new life is idle, and the thread ends."""
    profiler.reset_serving()
    eng = _engine(model, slots=2)
    eng.warmup()
    warm = eng.compile_counts()
    pa, pb = _prompt(5, seed=7), _prompt(9, seed=8)
    tcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.1,
                     "FLAGS_fault_hang_sec": 0.6})  # the watchdog ends it
    finj.arm("serve.prefill.hang")
    sup = EngineSupervisor(eng, poll_interval=0.02, max_restarts=3, backoff=0.0)
    eng.start()
    first = eng._thread
    sup.start()
    try:
        ra = eng.submit(pa, max_new_tokens=6)
        rb = eng.submit(pb, max_new_tokens=6)
        out_a, out_b = ra.wait(WAIT_S), rb.wait(WAIT_S)
        replays = _replays(eng)
        first.join(WAIT_S)  # the stale thread wakes, meets the fence, ends
        assert not first.is_alive() and eng._thread is not first
        assert _replays(eng) == replays
    finally:
        sup.stop()
        eng.stop(timeout=5)
    assert np.array_equal(out_a, ref(pa, 6)) and np.array_equal(out_b, ref(pb, 6))
    assert ra.finish_reason == rb.finish_reason == "length"
    assert eng.restart_count == 1 and sup.restarts == 1
    assert eng.compile_counts() == warm
    assert profiler.serving_summary()["faults"]["restarts"] == 1


@pytest.mark.parametrize("spec_k", [0, 2], ids=["decode", "verify"])
def test_decode_nan_poisons_only_target_slot(model, ref, spec_k):
    """serve.decode.nan poisons one slot's logits through the step's
    static `poison` input: only that request errors, the co-batched one is
    the reference's stream, nothing retraces, and the input reads
    all-False again after the poisoned step."""
    profiler.reset_serving()
    eng = _engine(model, slots=2, spec_k=spec_k)
    eng.warmup()
    warm = eng.compile_counts()
    pa, pb = _prompt(5, seed=1), _prompt(9, seed=2)
    ra = eng.submit(pa, max_new_tokens=6)
    rb = eng.submit(pb, max_new_tokens=6)
    eng.step()  # both admitted (slots 0, 1), one clean step
    finj.arm("serve.decode.nan")  # the next step poisons slot 0 (ra)
    eng.run_until_idle()
    with pytest.raises(NonFiniteLogits) as ei:
        ra.wait(1)
    assert ra.finish_reason == "error" and f"request {ra.id}" in str(ei.value)
    assert np.array_equal(rb.wait(1), ref(pb, 6))
    assert eng.compile_counts() == warm
    assert profiler.serving_summary()["faults"]["nonfinite"] == 1
    step = eng._verify_g if spec_k else eng._decode_g
    assert not step.inputs(None)["poison"].any()


def test_loop_crash_supervisor_restarts_thread(model, ref):
    eng = _engine(model, slots=2)
    eng.warmup()
    warm = eng.compile_counts()
    p = _prompt(5, seed=9)
    finj.arm("serve.loop.crash")  # one shot: the scheduler thread dies
    sup = EngineSupervisor(eng, poll_interval=0.02, max_restarts=3, backoff=0.0)
    eng.start()
    sup.start()
    try:
        out = eng.submit(p, max_new_tokens=5).wait(timeout=WAIT_S)
    finally:
        sup.stop()
        eng.stop(timeout=5)
    assert np.array_equal(out, ref(p, 5))
    assert eng.restart_count == 1 and eng.compile_counts() == warm


def test_restart_budget_exhausted_fails_all_typed(model):
    """Past the budget the engine is dead: every pending request resolves
    once with EngineRestarted, new submits raise EngineUnavailable."""
    eng = _engine(model, slots=2)
    finj.arm("serve.loop.crash:*")  # every scheduler life dies at once
    sup = EngineSupervisor(eng, poll_interval=0.01, max_restarts=2, backoff=0.0)
    eng.start()
    sup.start()
    try:
        reqs = [eng.submit(_prompt(4, seed=i), max_new_tokens=4) for i in range(3)]
        for r in reqs:
            with pytest.raises(EngineRestarted):
                r.wait(timeout=WAIT_S)
    finally:
        sup.stop()
        eng.stop(timeout=5)
    assert all(r.finish_reason == "restarted" for r in reqs)
    assert sup.dead and eng.restart_count == 2
    assert eng.healthz()["status"] == "dead"
    with pytest.raises(EngineUnavailable):
        eng.submit(_prompt(4), max_new_tokens=2)


# -- the invariant checker (FLAGS_serve_debug_invariants) ---------------------


def test_invariant_checker_clean_traffic_passes(model):
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    eng = _engine(model, slots=2)
    reqs = [eng.submit(_prompt(3 + 2 * i, seed=50 + i), max_new_tokens=2 + i)
            for i in range(4)]
    eng.run_until_idle()  # every step checks
    for r in reqs:
        assert r.wait(1) is not None


def test_invariant_checker_catches_corruption(model):
    eng = _engine(model, slots=2)
    eng._pos[0] = 7  # a free slot left unrecycled: a would-be slot leak
    with pytest.raises(AssertionError, match="free but not recycled"):
        eng._check_invariants()
    eng._pos[0] = 0
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    eng.step()  # clean again


# -- stop() and the lifecycle ------------------------------------------------------


def test_stop_flushes_pending_token_fetches(model):
    eng = _engine(model, slots=1)
    r = eng.submit(_prompt(4), max_new_tokens=30)
    for _ in range(5):
        eng.step()  # 1 prefill token + 4 decode steps in flight
    assert len(r.tokens) == 1
    eng.stop()
    assert len(r.tokens) == 6


def test_engine_context_manager_joins_thread(model):
    stream = []
    with _engine(model) as eng:
        eng.start()
        t = eng._thread
        r = eng.submit(_prompt(4), max_new_tokens=5, on_token=stream.append)
        r.wait(timeout=WAIT_S)
    assert eng._thread is None and not t.is_alive()
    assert stream == list(r.tokens)


# -- what graph replay adds to the reference's contract ---------------------------


def test_restart_waits_out_a_capture_and_not_a_wedged_launch(model):
    """While a StepGraph traces (on the card: captures), restart() waits
    for the launch lock however long the capture takes; with no capture in
    progress it gives up after a second and fences by generation alone."""
    eng = _engine(model, slots=2)
    holder_done = threading.Event()

    def hold(seconds):
        with eng._launch_mu:
            holder_done.wait(seconds)

    eng._decode_g.tracing = True
    t = threading.Thread(target=hold, args=(1.6,))
    t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    eng.restart("capture drill")
    waited = time.monotonic() - t0
    t.join(5)
    eng._decode_g.tracing = False
    assert waited >= 1.4 and eng.restart_count == 1

    holder_done.clear()
    t = threading.Thread(target=hold, args=(5.0,))
    t.start()
    time.sleep(0.05)
    gen = eng._generation
    t0 = time.monotonic()
    eng.restart("wedged launch drill")
    waited = time.monotonic() - t0
    holder_done.set()
    t.join(5)
    assert 0.9 <= waited < 3.0 and eng._generation == gen + 1


def test_fail_all_resolves_while_a_wedged_fetch_holds_the_lock(model):
    """fail_all() takes `_mu` with a bound: a thread stuck in a fetch
    holding it cannot keep the pending requests from resolving."""
    eng = _engine(model, slots=2)
    slotted = eng.submit(_prompt(5, seed=3), max_new_tokens=20)
    eng.step()
    queued = [eng.submit(_prompt(4, seed=i), max_new_tokens=4) for i in range(2)]
    release = threading.Event()
    held = threading.Event()

    def wedged_fetch():
        with eng._mu:
            held.set()
            release.wait(10)

    t = threading.Thread(target=wedged_fetch)
    t.start()
    held.wait(5)
    t0 = time.monotonic()
    try:
        n = eng.fail_all("wedged card drill")
    finally:
        release.set()
        t.join(5)
    assert time.monotonic() - t0 < 3.0 and n == 3
    for r in [slotted, *queued]:
        with pytest.raises(EngineRestarted):
            r.wait(1)
        assert r.finish_reason == "restarted"


def test_deadline_check_flushes_nothing_without_a_victim(model):
    """The per-step deadline check reads the host clock only: requests
    whose deadlines are far off leave decode in flight exactly as requests
    without one."""
    def flushes(deadline_s):
        eng = _engine(model, slots=2)
        calls = []
        real = eng._flush_pending_locked

        def spy():
            calls.append(len(eng._pending_fetch))
            return real()

        eng._flush_pending_locked = spy
        reqs = [eng.submit(_prompt(5, seed=i), max_new_tokens=12,
                           deadline_s=deadline_s) for i in range(2)]
        eng.run_until_idle()
        for r in reqs:
            r.wait(1)
        return calls

    assert flushes(600.0) == flushes(None)


def test_drain_estimate_reads_the_flushed_step_time(model):
    """With decode in flight the dispatch time `record_serving_tick` keeps
    is not a step's wall time; the EWMA comes from the flushes, and the
    estimate prices queued work with it."""
    eng = _engine(model, slots=1)
    r = eng.submit(_prompt(5), max_new_tokens=10)
    eng.run_until_idle()
    r.wait(1)
    ew = eng._step_ewma_s
    assert ew is not None and ew > 0
    eng.submit(_prompt(5), max_new_tokens=10)
    assert eng.estimate_drain_s() == pytest.approx(10 * ew)
    assert eng.healthz()["drain_estimate_s"] == round(10 * ew, 3)


def test_restart_keeps_the_prefix_cache_and_the_graphs(model, ref):
    """A restart fails the slotted request that had streamed tokens
    (EngineRestarted), keeps the queued one, the prefix cache and every
    executable: the queued request then hits the cache and finishes with
    the reference's tokens, with no new trace."""
    eng = _engine(model, slots=2, page_size=8)
    eng.warmup()
    warm = eng.compile_counts()
    p = _prompt(13, seed=30)
    eng.generate(p, max_new_tokens=4)  # commits the prompt's pages
    streaming = eng.submit(_prompt(6, seed=31), max_new_tokens=20)
    eng.step()
    hit = eng.submit(p, max_new_tokens=6)
    cached = eng.healthz()["prefix_cache_size"]
    assert cached > 0
    eng.restart("drill")  # no scheduler thread: nothing to start
    with pytest.raises(EngineRestarted) as ei:
        streaming.wait(1)
    assert streaming.finish_reason == "restarted" and "drill" in str(ei.value)
    assert eng.healthz()["prefix_cache_size"] == cached
    profiler.reset_paging()
    eng.run_until_idle()
    assert np.array_equal(hit.wait(1), ref(p, 6))
    assert profiler.paging_summary()["prefix_hits"] == 1
    assert eng.compile_counts() == warm and eng.healthz()["restarts"] == 1


# -- the fault layer itself -----------------------------------------------------


def test_fault_points_follow_the_references_grammar():
    """`name`, `name:N` and `name:*` against the reference's registry on
    the same specs: the same shots fired and the same hit counts."""
    from paddle_tpu.fault import injection as jinj

    for spec, reach in (("serve.loop.crash", 3), ("serve.loop.crash:2", 4),
                        ("serve.loop.crash:*", 3)):
        fired = []
        for inj in (jinj, finj):
            inj.arm(spec)
            fired.append([inj.should_fire("serve.loop.crash") for _ in range(reach)])
            fired.append(inj.hits("serve.loop.crash"))
            inj.disarm()
        assert fired[:2] == fired[2:]
    finj.arm("serve.loop.crash")
    with pytest.raises(finj.InjectedFault, match="serve.loop.crash"):
        finj.inject("serve.loop.crash", context="drill")
    finj.inject("serve.loop.crash")  # spent: passes through
    with pytest.raises(ValueError, match="count must be"):
        finj.arm("serve.loop.crash:x")
    assert {"serve.prefill.hang", "serve.decode.nan",
            "serve.loop.crash"} <= set(finj.fault_points())


def test_watchdog_raises_after_an_overrun_and_dumps_the_stacks(capsys):
    from paddle_tpu_torch.fault import Watchdog, WatchdogTimeout

    wd = Watchdog()
    with pytest.raises(WatchdogTimeout) as ei:
        with wd.arm("drill.region", timeout=0.05, context="a test"):
            time.sleep(0.3)
    assert ei.value.region == "drill.region"
    err = capsys.readouterr().err
    assert "region 'drill.region' exceeded" in err and "--- thread" in err
    with wd.arm("drill.region", timeout=0):  # disabled: a passthrough
        time.sleep(0.01)
    assert finj.recent_events()[-1]["kind"] == "watchdog"


def test_a_tripped_watchdog_keeps_no_engine_alive(model):
    """The monitor thread holds nothing of a region after firing it: an
    engine whose watchdog tripped is freed once its owner drops it (on the
    card it holds the arena, the graphs' pool and the model)."""
    import gc
    import weakref

    eng = _engine(model, slots=1)
    tcore.set_flags({"FLAGS_serve_step_timeout_sec": 0.05,
                     "FLAGS_fault_hang_sec": 0.3})
    finj.arm("serve.prefill.hang")
    r = eng.submit(_prompt(4), max_new_tokens=2)
    eng.run_until_idle()  # the hang trips the watchdog, then the step ends
    r.wait(1)
    assert eng._watchdog_trip is not None
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None
