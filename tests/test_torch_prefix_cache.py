"""The port's prefix-cached paged serving against the JAX package on the CPU.

- `PrefixCache` / `PagePool`: one sequence of lookups, commits and
  evictions gives the same matches, refcounts and victims in both packages.
- K2's plain version at more than 64 rows of one GQA group x window (the
  chunk prefill of a long suffix) against the reference's Pallas kernel in
  interpret mode, within 2e-5 in float32.
- The chunk-prefill cache write (`_rope_page_scatter` with `start`).
- Engines on shared weights, prefix cache on, full precision: greedy tokens
  identical to the JAX engine's, with a copy-on-write tail, a full-page hit
  and a pool small enough to evict, and the same paging counters.

The tiny config runs in float32 with page_size 8.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu import profiler as jprofiler
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=2e-5, rtol=2e-5)
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8, prefix_cache=True)
# a pool of 7 pages (6 usable) cannot keep every committed prompt: the
# traffic below evicts
SMALL_POOL = 7


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _traffic():
    """Prompts sharing a 12-token base (one full page + a 4-row tail, so a
    hit copies the tail), one extending another by a full page (a
    full-page hit), an unrelated prompt, and a too-short overlap (below
    min_prefix_match); run one at a time so each commits before the next
    looks up."""
    base = _prompt(12, 70)
    a = np.concatenate([base, _prompt(4, 71)])
    prompts = [
        base,
        a,
        np.concatenate([base, _prompt(5, 72)]),
        _prompt(9, 3),
        np.concatenate([base[:6], _prompt(7, 4)]),
        np.concatenate([a, _prompt(3, 9)]),
        np.concatenate([base, _prompt(5, 72)]),
    ]
    return [p.astype(np.int32) for p in prompts], [3, 6, 5, 4, 5, 6, 4]


def _serve_one_by_one(eng, prompts, news):
    outs = []
    for p, n in zip(prompts, news):
        req = eng.submit(p, max_new_tokens=n)
        eng.run_until_idle()
        outs.append(req.wait(1).tolist())
    return outs


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


@pytest.fixture(scope="module")
def reference(models):
    """The JAX engine's greedy tokens and paging counters over the traffic,
    with the auto pool and with the small one."""
    jm, _ = models
    prompts, news = _traffic()
    out = {}
    for pool in (None, SMALL_POOL):
        jprofiler.reset_paging()
        eng = JaxEngine(jm, pool_pages=pool, **ENGINE)
        out[pool] = (_serve_one_by_one(eng, prompts, news),
                     jprofiler.paging_summary(), len(eng._prefix))
    return prompts, news, out


# ---------------------------------------------------------------------------
# host bookkeeping
# ---------------------------------------------------------------------------


def _cache_script(paging, ps=4):
    """Drive one package's PagePool + PrefixCache through commits, lookups
    and evictions; return everything observable."""
    pool = paging.PagePool(12)
    cache = paging.PrefixCache(ps)
    seen = []
    prompts = [
        np.arange(1, 11, dtype=np.int32),                 # 2 full pages + 2-row tail
        np.concatenate([np.arange(1, 9), [40, 41, 42]]).astype(np.int32),
        np.arange(1, 6, dtype=np.int32),                  # 1 full page + 1 row
        np.array([7, 7, 7, 7, 7, 7], np.int32),
    ]
    for p in prompts:
        seen.append(("lookup", cache.lookup(p)))
        need = -(-p.size // ps)
        pages = [pool.alloc() for _ in range(need)]
        seen.append(("commit", cache.commit(p, pages, pool)))
        for pg in pages:  # the request finishes: its own holds drop
            pool.decref(pg)
        seen.append(("refs", pool.refs.tolist(), len(cache)))
    seen.append(("lookup", cache.lookup(np.arange(1, 14, dtype=np.int32))))
    victims = []
    while (e := cache.evict_one(pool)) is not None:
        victims.append((e.page, e.rows, e.tokens))
        seen.append(("refs", pool.refs.tolist(), len(cache), pool.free_count()))
    seen.append(("victims", victims))
    return seen


def test_prefix_cache_and_pool_match_reference():
    assert _cache_script(tpaging) == _cache_script(jpaging)


def test_lookup_is_capped_one_token_short_and_clear_releases_every_hold():
    pool = tpaging.PagePool(6)
    cache = tpaging.PrefixCache(4)
    p = np.arange(1, 9, dtype=np.int32)  # exactly two full pages
    pages = [pool.alloc(), pool.alloc()]
    assert cache.commit(p, pages, pool) == 2
    m, fulls, tail, rows = cache.lookup(p)
    assert (m, fulls, tail, rows) == (4, [pages[0]], None, 0)  # L - 1 cap
    for pg in pages:
        pool.decref(pg)
    assert pool.used_count() == 2  # the cache's holds
    assert cache.clear(pool) == 2 and pool.used_count() == 0


def test_pool_refcounts_reject_scratch_and_dead_pages():
    pool = tpaging.PagePool(3)
    p = pool.alloc()
    pool.incref(p)
    assert pool.refs[p] == 2 and not pool.decref(p) and pool.decref(p)
    with pytest.raises(ValueError, match="scratch or dead"):
        pool.incref(0)
    with pytest.raises(ValueError, match="scratch or dead"):
        pool.incref(p)


# ---------------------------------------------------------------------------
# K2 beyond one 64-row tile, and the chunk-prefill write
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


@pytest.mark.parametrize(
    "b,sq,h,hk,pos",
    [
        (1, 80, 2, 2, [9]),        # rep 1 x sq 80: a chunk of 80 suffix rows
        (2, 36, 4, 2, [20, 0]),    # rep 2 x sq 36 = 72 rows, GQA
    ],
)
def test_paged_decode_plain_beyond_64_rows_matches_reference_kernel(b, sq, h, hk, pos):
    rng = np.random.default_rng(sq + h)
    d, ps, P = 16, 8, 16
    pages = 1 + b * P
    ak = rng.standard_normal((pages, ps, hk, d)).astype(np.float32)
    av = rng.standard_normal((pages, ps, hk, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, pages)).astype(np.int32).reshape(b, P)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    pos = np.asarray(pos, np.int32)
    max_len = 120
    ref = np.asarray(fa._fused_paged_decode_forward(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av), jnp.asarray(tables),
        jnp.asarray(pos), max_len, 1.0 / np.sqrt(d), interpret=True))
    out = pfa.paged_decode_fused(*(torch.from_numpy(x) for x in (q, ak, av, tables, pos)),
                                 max_len)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("start", [None, 5, 50])
def test_rope_page_scatter_with_start_matches_reference(start):
    """Row i of a chunk at `start` lands at global position start + i,
    rotated there; padding rows and table overruns go to scratch (start 50
    runs past the rope table of 56 rows, which both sides clamp)."""
    from paddle_tpu import to_tensor

    rng = np.random.default_rng(7)
    s, hk, h, d, ps = 8, 2, 4, 16, 4
    cos, sin = (np.cos(rng.standard_normal((56, d))).astype(np.float32),
                np.sin(rng.standard_normal((56, d))).astype(np.float32))
    q = rng.standard_normal((1, s, h, d)).astype(np.float32)
    k = rng.standard_normal((1, s, hk, d)).astype(np.float32)
    v = rng.standard_normal((1, s, hk, d)).astype(np.float32)
    table = np.array([3, 1, 4, 2, 5, 6], np.int32)
    arena = np.zeros((7, ps, hk, d), np.float32)
    true_len = 6
    st = None if start is None else np.full(1, start, np.int32)
    jq, _, jak, jav = jllama._rope_page_scatter(
        to_tensor(arena), to_tensor(arena), to_tensor(q), to_tensor(k),
        to_tensor(v), to_tensor(cos), to_tensor(sin), to_tensor(table),
        to_tensor(np.int32(true_len)), None if st is None else to_tensor(st))
    tak, tav = torch.from_numpy(arena.copy()), torch.from_numpy(arena.copy())
    tq, _ = tllama._rope_page_scatter(
        tak, tav, *(torch.from_numpy(x) for x in (q, k, v, cos, sin, table)),
        true_len, None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq.numpy()), **TOL)
    # scratch page 0 takes the redirected rows of both: compare the rest
    np.testing.assert_allclose(tak.numpy()[1:], np.asarray(jak.numpy())[1:], **TOL)
    np.testing.assert_array_equal(tav.numpy()[1:], np.asarray(jav.numpy())[1:])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pool", [None, SMALL_POOL], ids=["auto_pool", "evicting_pool"])
def test_greedy_tokens_identical_to_jax_engine(models, reference, pool):
    _, tm = models
    prompts, news, out = reference
    ref_outs, ref_paging, ref_size = out[pool]
    eng = ContinuousBatchingEngine(tm, device="cpu", pool_pages=pool, **ENGINE)
    eng.warmup()
    profiler.reset_paging()
    outs = _serve_one_by_one(eng, prompts, news)
    assert outs == ref_outs
    paging = profiler.paging_summary()
    for key in ("prefix_hits", "cow_copies", "prefill_tokens_saved",
                "cache_commits", "cache_evictions"):
        assert paging.get(key, 0) == ref_paging.get(key, 0), key
    assert paging["prefix_hits"] >= 3 and paging["cow_copies"] >= 1
    if pool == SMALL_POOL:
        assert paging["cache_evictions"] > 0
    assert eng.healthz()["prefix_cache_size"] == len(eng._prefix) == ref_size


def test_concurrent_prefix_traffic_matches_serial_tokens(models, reference):
    """Shared-prefix requests admitted together (after the first commits)
    give the tokens they give one at a time, and every page is accounted
    for afterwards: free + held only by the cache = usable."""
    _, tm = models
    prompts, news, out = reference
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    first = eng.submit(prompts[0], max_new_tokens=news[0])
    eng.run_until_idle()
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts[1:], news[1:])]
    eng.run_until_idle()
    outs = [first.wait(1).tolist()] + [r.wait(1).tolist() for r in reqs]
    assert outs == out[None][0]
    pool = eng._pool
    cache_only = sum(1 for e in eng._prefix.entries() if pool.refs[e.page] == 1)
    assert pool.free_count() + cache_only == pool.usable_pages
    eng.stop()
    assert eng._prefix.clear(pool) == cache_only
    assert pool.free_count() == pool.usable_pages


def test_prefix_cache_is_on_by_default_and_reported(models):
    _, tm = models
    assert tcore.flag("FLAGS_serve_prefix_cache") is True
    eng = ContinuousBatchingEngine(tm, device="cpu", max_len=64,
                                   prefill_buckets=[8, 16], page_size=8)
    assert eng._prefix is not None and eng.min_prefix_match == 8
    eng.generate(_prompt(12, 5), max_new_tokens=2)
    health = eng.healthz()
    assert health["prefix_cache_size"] == 2 and health["kv_quant"] == "none"
    off = ContinuousBatchingEngine(tm, device="cpu", max_len=64,
                                   prefill_buckets=[8, 16], page_size=8,
                                   prefix_cache=False)
    assert off.healthz()["prefix_cache_size"] == 0
