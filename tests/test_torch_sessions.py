"""The port's multi-turn KV sessions (`SessionStore` and `submit(session_id=)`)
against the JAX package on the CPU.

- `SessionStore` over a real `PrefixCache`: pins, rebinding, LRU capacity
  eviction and release observed step for step as the reference's store
  keeps them; `check` names a pin drift.
- A 20-turn conversation through a session engine: every turn's tokens
  identical to the port's stateless engine (no prefix cache) and to the
  reference's session engine on shared weights, >= 90% of the prompt
  tokens of turns 2-20 reused, no new trace after warmup.
- A small pool: sessionless traffic evicts the idle session whole, and its
  next turn answers as a fresh engine does; a warm restart keeps the
  session; a session under a LoRA adapter pins its chain under that
  adapter's root; `/metrics` and the flight header carry the session
  families.

Tiny Llamas in float32, page_size 8.
"""

import json

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import lora as jlora
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import lora as tlora
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import flight, metrics

ENGINE = dict(slots=2, max_len=192, prefill_buckets=[8, 128], queue_depth=16,
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
    paddle.seed(45)
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


def _engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def _turn(eng, prompt, n=3, sid=None, adapter=None):
    req = eng.submit(np.asarray(prompt, np.int32), max_new_tokens=n,
                     session_id=sid, adapter=adapter)
    eng.run_until_idle()
    return req, req.wait(1).tolist()


# ---------------------------------------------------------------------------
# the store over a real cache
# ---------------------------------------------------------------------------


def _committed_chain(paging, pool, cache, tokens):
    pages = [pool.alloc() for _ in range(-(-len(tokens) // cache.page_size))]
    cache.commit(np.asarray(tokens, np.int32), pages, pool)
    for p in pages:  # the slot mapping these stood in for is gone
        pool.decref(p)
    entries, covered = cache.chain(np.asarray(tokens, np.int32))
    assert covered == len(tokens)
    return entries


def _store_script(paging):
    """Bind, rebind, evict by capacity and release over a 16-page pool;
    everything observable after each move."""
    pool, cache = paging.PagePool(16), paging.PrefixCache(8)
    store = paging.SessionStore(capacity=2)
    seen = []

    def note(what):
        seen.append((what, store.stats(), pool.refs.tolist(),
                     sorted(e.pinned for e in cache.entries()), len(store)))

    seq_a = list(range(1, 17))
    assert store.bind("a", seq_a, _committed_chain(paging, pool, cache, seq_a)) == []
    note("bind a")
    assert cache.evict_one(pool) is None  # pinned entries never evict
    seq_a2 = seq_a + list(range(17, 22))  # a longer chain with a tail
    entries2 = _committed_chain(paging, pool, cache, seq_a2)
    store.bind("a", seq_a2, entries2)
    assert all(e.pinned == 1 for e in entries2) and store.get("a")["turns"] == 2
    note("rebind a")
    seq_b = list(range(30, 46))
    store.bind("b", seq_b, _committed_chain(paging, pool, cache, seq_b))
    store.touch("a")  # b becomes the LRU
    seq_c = list(range(50, 66))
    assert store.bind("c", seq_c, _committed_chain(paging, pool, cache, seq_c)) == ["b"]
    store.check(cache, pool)
    note("bind c evicts b")
    assert "a" in store and "b" not in store
    assert store.tokens("a").tolist() == seq_a2
    store.release("a")
    store.release("c")
    assert store.pages_pinned() == 0 and not store.release("zz")
    victim = cache.evict_one(pool)
    note(("evict after release", victim.page))
    # clear() drops pins first
    seq_d = list(range(70, 86))
    store.bind("d", seq_d, _committed_chain(paging, pool, cache, seq_d))
    cleared = cache.clear(pool)
    note(("clear", cleared))
    return seen


def test_session_store_matches_the_reference_step_for_step():
    assert _store_script(tpaging) == _store_script(jpaging)


def test_session_check_catches_pin_drift():
    pool, cache = tpaging.PagePool(8), tpaging.PrefixCache(8)
    store = tpaging.SessionStore()
    entries = _committed_chain(tpaging, pool, cache, list(range(1, 9)))
    store.bind("s", list(range(1, 9)), entries)
    store.check(cache, pool)
    entries[0].pinned += 1  # a leak the audit must name
    with pytest.raises(AssertionError, match="session invariant.*pinned=2"):
        store.check(cache, pool)
    entries[0].pinned -= 1
    cache._full.clear()  # an entry the cache dropped under a live session
    cache._tails.clear()
    with pytest.raises(AssertionError, match="whose cache entry was removed"):
        store.check(cache, pool)


def test_chain_and_roots_match_the_reference():
    """`chain` (full links plus an exact tail) and the per-adapter roots of
    `lookup` / `commit`, on both packages."""
    out = []
    for paging in (tpaging, jpaging):
        pool, cache = paging.PagePool(32), paging.PrefixCache(4)
        seq = np.arange(1, 11, dtype=np.int32)
        got = []
        for adapter in (0, 3):
            pages = [pool.alloc() for _ in range(3)]
            cache.commit(seq, pages, pool, adapter=adapter)
            entries, covered = cache.chain(seq, adapter=adapter)
            got.append(([e.page for e in entries], covered))
            got.append(cache.chain(seq[:7], adapter=adapter)[1])  # no exact tail
            got.append(cache.lookup(np.concatenate([seq, [99]]), adapter=adapter)[:2])
        got.append(cache.lookup(np.concatenate([seq, [99]]), adapter=5)[:2])
        out.append(got)
    assert out[0] == out[1]
    assert out[0][0][1] == 10 and out[0][1] == 4 and out[0][-1] == (0, [])


# ---------------------------------------------------------------------------
# engines
# ---------------------------------------------------------------------------


def test_20_turn_replay_identical_to_stateless_and_reference(models):
    jm, tm = models
    sess = _engine(tm)
    sess.warmup()
    warm = sess.compile_counts()
    stateless = _engine(tm, prefix_cache=False)
    ref = JaxEngine(jm, **ENGINE)
    conv = _prompt(12, 10).tolist()
    total_prompt = saved = 0
    for t in range(20):
        req, out = _turn(sess, conv, sid="conv-0")
        _, plain = _turn(stateless, conv)
        _, jout = _turn(ref, conv, sid="conv-0")
        assert out == plain, f"turn {t} diverged from the stateless replay"
        assert out == jout, f"turn {t} diverged from the reference's session"
        if t > 0:
            total_prompt += len(conv)
            saved += req.session_reused_tokens
        conv = out + _prompt(2, 100 + t).tolist()
    assert saved / total_prompt >= 0.90
    assert sess.compile_counts() == warm  # positions and tables are data
    st = sess._sessions.stats()
    assert st == ref._sessions.stats()
    assert st["sessions_resident"] == 1 and st["session_binds_total"] == 20
    assert st["session_prefill_tokens_saved_total"] == saved
    with sess._mu:
        sess._check_page_invariants_locked()


def test_eviction_under_page_pressure_falls_back_stateless(models, invariants):
    _, tm = models
    small = dict(max_len=64, prefill_buckets=[8, 64])
    eng = _engine(tm, pool_pages=6, **small)  # 5 usable pages
    _, out1 = _turn(eng, _prompt(14, 20).tolist(), sid="victim")
    assert eng._sessions.stats()["sessions_resident"] == 1
    assert eng._sessions.pages_pinned() == 2  # 16 committed rows
    # sessionless prompts of 4 pages each: with 3 unpinned pages in the
    # pool, admission counts the pinned chain as reachable and the
    # allocator evicts the session whole
    profiler.reset_paging()
    for i in range(3):
        _turn(eng, _prompt(26, 30 + i).tolist(), n=4)
    st = eng._sessions.stats()
    assert st["sessions_resident"] == 0 and st["session_evictions_total"] == 1
    assert profiler.metrics_snapshot()["paging"]["session_evictions"] == 1
    conv = out1 + _prompt(2, 21).tolist()
    req, out2 = _turn(eng, conv, sid="victim")
    assert req.session_reused_tokens == 0  # a stateless re-prefill
    _, fresh = _turn(_engine(tm, prefix_cache=False, **small), conv)
    assert out2 == fresh


def test_sessions_survive_a_warm_restart(models, invariants):
    _, tm = models
    eng = _engine(tm)
    eng.warmup()
    warm = eng.compile_counts()
    _, out1 = _turn(eng, _prompt(16, 40).tolist(), sid="s")
    eng.restart(reason="drill")
    assert eng.healthz()["sessions"]["sessions_resident"] == 1
    conv2 = out1 + _prompt(2, 41).tolist()
    req, out2 = _turn(eng, conv2, sid="s")
    # everything but the last emitted token (whose K/V was never written)
    # came from the session's pages
    assert req.session_reused_tokens == len(out1) - 1
    _, fresh = _turn(_engine(tm, prefix_cache=False), conv2)
    assert out2 == fresh
    assert eng.compile_counts() == warm


def test_a_session_under_an_adapter(models, invariants):
    jm, tm = models
    jreg, treg = jlora.AdapterRegistry(jm.config), tlora.AdapterRegistry(tm.config)
    a = jlora.make_random(jreg, "a1", rank=4, seed=1, scale=0.1)
    treg.register(a.name, a.weights, a.rank, alpha=a.scale * a.rank)
    eng = _engine(tm, lora=tlora.AdapterArena(treg, capacity=2, device="cpu"))
    ref = JaxEngine(jm, lora=jlora.AdapterArena(jreg, capacity=2), **ENGINE)
    stateless = _engine(tm, prefix_cache=False,
                        lora=tlora.AdapterArena(treg, capacity=2, device="cpu"))
    conv = _prompt(12, 50).tolist()
    for t in range(4):
        req, out = _turn(eng, conv, sid="tenant-chat", adapter="a1")
        assert out == _turn(ref, conv, sid="tenant-chat", adapter="a1")[1]
        assert out == _turn(stateless, conv, adapter="a1")[1]
        if t:
            assert req.session_reused_tokens == len(conv) - 3
        conv = out + _prompt(2, 60 + t).tolist()
    rec = eng._sessions.get("tenant-chat")
    assert rec["adapter"] == 1 and rec["turns"] == 4
    # the pinned chain hangs from the adapter's root, not the base model's
    root = rec["entries"][0].parent_key
    assert root == ("__lora__", 1)
    # the same transcript without the adapter shares nothing with it
    req, _ = _turn(eng, conv[:20], n=2)
    assert req.session_reused_tokens == 0


def test_session_id_without_a_prefix_cache_replays_statelessly(models):
    _, tm = models
    eng = _engine(tm, prefix_cache=False)
    assert eng._sessions is None and "sessions" not in eng.healthz()
    conv = _prompt(12, 80).tolist()
    req, out = _turn(eng, conv, sid="s")
    assert req.session_id == "s" and req.session_reused_tokens == 0
    assert out == _turn(eng, conv)[1]


def test_session_max_bounds_the_resident_sessions(models):
    _, tm = models
    eng = _engine(tm, session_max=2)
    for i in range(3):
        _turn(eng, _prompt(10, 90 + i).tolist(), sid=f"s{i}")
    st = eng.healthz()["sessions"]
    assert st["sessions_resident"] == 2 and st["session_evictions_total"] == 1
    assert "s0" not in eng._sessions and "s2" in eng._sessions


def test_session_families_in_metrics_and_the_flight_header(models, tmp_path):
    _, tm = models
    eng = _engine(tm)
    conv = _prompt(12, 70).tolist()
    _, out = _turn(eng, conv, sid="m1")
    _turn(eng, out + _prompt(2, 71).tolist(), sid="m1")
    snap = profiler.metrics_snapshot()["sessions"]
    assert snap["sessions_resident"] == 1 and snap["session_binds_total"] >= 2
    assert snap["session_prefill_tokens_saved_total"] > 0
    text = metrics.render()
    values = {}
    for line in text.splitlines():
        if line.startswith("paddle_session_"):
            name, v = line.rsplit(" ", 1)
            values[name.split("{")[0]] = float(v)
    assert values["paddle_session_resident"] == 1
    assert values["paddle_session_binds_total"] >= 2
    assert values["paddle_session_prefill_tokens_saved_total"] > 0
    assert values["paddle_session_pages_pinned"] >= 1
    assert values["paddle_session_pin_hits_total"] == 0  # the router's
    path = flight.dump("test", path=str(tmp_path / "f.jsonl"))
    with open(path) as f:
        header = json.loads(f.readline())
    assert header["sessions"]["sessions_resident"] == 1
    kinds = [json.loads(line) for line in open(path).read().splitlines()[1:]]
    binds = [k for k in kinds if k["kind"] == "session" and k["detail"] == "bind"]
    assert binds and binds[-1]["sid"] == "m1" and binds[-1]["turns"] == 2
