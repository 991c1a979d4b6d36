"""The port's context-parallel paged decode (K5) against the JAX package on
the CPU, float32, tolerance 2e-5 unless stated.

- `cp_softmax_combine` against the reference's, a fully masked shard
  included (1e-6).
- K5's plain version (`paged_decode_partials` on CPU tensors) against the
  reference's `_fused_paged_decode_partials_forward` in interpret mode,
  shard by shard on the reference's cp arena layout (tests/
  test_cp_decode.py `_cp_arena`): sq 1 and 3 (a verify window), GQA rep 2,
  full precision and int8; acc, m and l on every row that sees a key, m on
  the rows that see none (their l and acc are garbage in the reference's
  kernel until the combine's e^(m - m*) removes them).
- `paged_decode_attention(cp=2)` against the reference's
  `paged_decode_attention_array` under a cp=2 mesh in interpret mode, and
  an indivisible pool or table raising ValueError.
- `PagePool(10, shards=2)` in the reference's state.
- Engines on shared weights (tiny Llama, page_size 8): cp=2 greedy tokens
  identical to the JAX cp=2 engine's and to the port's cp=1 engine's on
  ragged traffic; the same with decode_kernel="fused" and spec_k=2; int8
  cp=2 spec_k=2 tokens identical to the JAX int8 cp=2 engine's; the page
  audit across a prefix hit; `ContextOverflow.body()` equal to the JAX
  engine's with no page taken; the 400 body over HTTP.

Launch counts read 0 here (CPU tensors run the plain versions); the
engine tests count K5 calls through a spy on `paged_decode_partials`, one
per shard, so cp times the reference's `_log_pallas_call` count.
"""

import contextlib
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu import profiler as jprofiler
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.inference.engine import ContextOverflow as JaxContextOverflow
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference.paging import PagePool as JaxPagePool
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.engine import ContextOverflow, ContinuousBatchingEngine
from paddle_tpu_torch.inference.paging import PagePool
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=2e-5, rtol=2e-5)
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8)
LENS = [6, 13, 9]  # the reference's ragged traffic


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


@pytest.fixture(scope="module", autouse=True)
def _rng_and_mesh_neutral():
    """The JAX model draws from paddle_tpu's global generator and cp
    engines install a global mesh: restore both for later modules."""
    state = paddle.get_rng_state()
    prev = jmesh.get_mesh()
    yield
    jmesh.set_mesh(prev)
    paddle.set_rng_state(state)


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


@contextlib.contextmanager
def _cp_mesh(cp):
    prev = jmesh.get_mesh()
    jmesh.serving_mesh(1, cp=cp)
    try:
        yield
    finally:
        jmesh.set_mesh(prev)


# ---------------------------------------------------------------------------
# the combine and K5's plain version
# ---------------------------------------------------------------------------


def test_cp_softmax_combine_matches_reference():
    """Disjoint key sets per shard, the third seeing none (m = -inf, l = 0,
    acc = 0), and a row masked on one shard only (m = -1e30 with garbage
    l and acc, as the kernel leaves it)."""
    r = np.random.RandomState(7)
    rows, n, d = 6, 24, 8
    s = r.randn(rows, n).astype(np.float32) * 3
    v = r.randn(n, d).astype(np.float32)
    parts = []
    for lo, hi in ((0, 9), (9, 24), (24, 24)):
        if hi > lo:
            m = s[:, lo:hi].max(-1, keepdims=True)
            e = np.exp(s[:, lo:hi] - m)
            parts.append((e @ v[lo:hi], m, e.sum(-1, keepdims=True)))
        else:
            parts.append((np.zeros((rows, d), np.float32),
                          np.full((rows, 1), -np.inf, np.float32),
                          np.zeros((rows, 1), np.float32)))
    acc, m, l = (np.stack(x) for x in zip(*parts))
    m[0, 2], l[0, 2], acc[0, 2] = -1e30, 5.0, 7.0  # row 2 masked on shard 0
    ref = np.asarray(fa.cp_softmax_combine(jnp.asarray(acc), jnp.asarray(m),
                                           jnp.asarray(l)))
    got = pfa.cp_softmax_combine(_t(acc), _t(m), _t(l)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got).all()


def _cp_arena(cp=2, num_pages=16, ps=8, hk=2, d=16, b=3, P=4, seed=0,
              quant=False):
    """The reference's global arena and tables in the cp layout (tests/
    test_cp_decode.py): sequence page j on shard j % cp, shard s owning
    pages [s*per_shard, (s+1)*per_shard) with its scratch page (zero)
    first.  numpy arrays; int8 values and float32 scales under quant."""
    r = np.random.RandomState(seed)
    per = num_pages // cp
    k = r.randn(num_pages, ps, hk, d).astype(np.float32)
    v = r.randn(num_pages, ps, hk, d).astype(np.float32)
    for s in range(cp):
        k[s * per] = v[s * per] = 0.0
    nxt = [s * per + 1 for s in range(cp)]
    tables = np.zeros((b, P), np.int32)
    for i in range(b):
        for j in range(P):
            tables[i, j] = nxt[j % cp]
            nxt[j % cp] += 1
    if not quant:
        return k, v, tables, None, None
    (kq, ks), (vq, vs) = (
        (np.asarray(a) for a in jllama._quantize_kv_rows(jnp.asarray(x)))
        for x in (k, v))
    return kq, vq, tables, ks, vs


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sq", [1, 3])  # a decode step and a verify window
def test_k5_plain_matches_reference_kernel_per_shard(sq, quant):
    cp, per, ps = 2, 8, 8
    k, v, tables, ks, vs = _cp_arena(seed=1 if quant else 0, quant=quant)
    q = np.random.RandomState(5).randn(3, sq, 4, 16).astype(np.float32)  # rep 2
    # slot 1 at pos 5 < page_size: shard 1 (sequence pages 1, 3) sees no key
    pos = np.asarray([29, 5, 17 + sq], np.int32)
    local = pfa.cp_local_tables(_t(tables), cp, per, ps)
    R = 2 * sq
    seen_rows = masked_rows = 0
    for s, (loc, base) in enumerate(local):
        # the reference's derivation (flash_attention.py:1451-1457)
        cols = s + cp * np.arange(tables.shape[1] // cp)
        g = tables[:, cols] - s * per
        np.testing.assert_array_equal(loc.numpy(), np.where((g > 0) & (g < per), g, 0))
        np.testing.assert_array_equal(base.numpy(), cols * ps)
        sl = slice(s * per, (s + 1) * per)
        scales = (ks[sl], vs[sl]) if quant else (None, None)
        ref = fa._fused_paged_decode_partials_forward(
            jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]),
            jnp.asarray(loc.numpy()), jnp.asarray(base.numpy()), jnp.asarray(pos),
            32, 0.25, interpret=True,
            k_scale=None if not quant else jnp.asarray(scales[0]),
            v_scale=None if not quant else jnp.asarray(scales[1]))
        r_acc, r_m, r_l = (np.asarray(x)[:, :, :R] for x in ref)
        got = pfa.paged_decode_partials(
            _t(q), _t(k[sl]), _t(v[sl]), loc, base, _t(pos), 32, 0.25,
            *(None if x is None else _t(x) for x in scales))
        g_acc, g_m, g_l = (x.numpy() for x in got)
        assert g_acc.shape == (3, 2, R, 16) and g_m.shape == (3, 2, R, 1)
        seen = (r_m > -1e29)[..., 0]
        np.testing.assert_allclose(g_m, r_m, **TOL)  # masked rows: -1e30
        np.testing.assert_allclose(g_l[seen], r_l[seen], **TOL)
        np.testing.assert_allclose(g_acc[seen], r_acc[seen], **TOL)
        seen_rows += int(seen.sum())
        masked_rows += int((~seen).sum())
    assert seen_rows and masked_rows  # both kinds of row were compared


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("sq", [1, 3])
def test_cp_attention_matches_reference_cp_dispatch(sq, quant):
    k, v, tables, ks, vs = _cp_arena(seed=1 if quant else 0, quant=quant)
    q = np.random.RandomState(6).randn(3, sq, 4, 16).astype(np.float32)
    pos = np.asarray([29, 11, 17 + sq], np.int32)
    scales = dict(k_scale=ks, v_scale=vs) if quant else {}
    with _interpret(), _cp_mesh(2):
        ref = fa.paged_decode_attention_array(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(tables),
            jnp.asarray(pos), max_len=32, kernel="fused",
            **{n: jnp.asarray(x) for n, x in scales.items()})
    got = pfa.paged_decode_attention(
        _t(q), _t(k), _t(v), _t(tables), _t(pos), 32, kernel="fused", cp=2,
        **{n: _t(x) for n, x in scales.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the merge over shards equals one walk over the global arena
    plain = (pfa.paged_decode_q8_plain(_t(q), _t(k), _t(v), _t(ks), _t(vs),
                                       _t(tables), _t(pos), 32, 0.25) if quant
             else pfa.paged_decode_plain(_t(q), _t(k), _t(v), _t(tables),
                                         _t(pos), 32, 0.25))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **TOL)


def test_cp_attention_rejects_what_does_not_divide_into_shards():
    r = np.random.RandomState(8)
    ka = _t(r.randn(7, 8, 2, 16).astype(np.float32))  # 7 pages, cp 2
    q = _t(r.randn(1, 1, 4, 16).astype(np.float32))
    pos = _t(np.asarray([10], np.int32))
    with pytest.raises(ValueError, match="cp=2"):
        pfa.paged_decode_attention(q, ka, ka, _t(np.asarray([[1, 2]], np.int32)),
                                   pos, 24, cp=2)
    ka = _t(r.randn(8, 8, 2, 16).astype(np.float32))
    with pytest.raises(ValueError, match="cp=2"):  # table width 3
        pfa.paged_decode_attention(q, ka, ka, _t(np.asarray([[1, 5, 2]], np.int32)),
                                   pos, 24, cp=2)


def test_page_pool_shards_match_reference():
    got, ref = PagePool(10, shards=2), JaxPagePool(10, shards=2)
    assert got.per_shard == ref.per_shard == 5
    assert got.scratch_pages == ref.scratch_pages == (0, 5)
    assert got.usable_pages == ref.usable_pages == 8
    assert [got.free_count(s) for s in (0, 1)] == [ref.free_count(s) for s in (0, 1)]
    pages = [(got.alloc(s), ref.alloc(s)) for s in (0, 1, 1, 0)]
    assert all(a == b for a, b in pages) and [p for p, _ in pages] == [1, 6, 7, 2]
    assert [got.shard_of(p) for p, _ in pages] == [0, 1, 1, 0]
    for p, _ in pages:
        got.decref(p)
        ref.decref(p)
    assert got._free == ref._free and np.array_equal(got.refs, ref.refs)
    assert all(got.is_scratch(p) and got.refs[p] == 1 for p in got.scratch_pages)
    with pytest.raises(ValueError, match="scratch"):
        got.incref(5)
    for bad in ((9, 2), (3, 2), (4, 0)):
        with pytest.raises(ValueError):
            PagePool(*bad)
    assert PagePool(5).scratch_pages == (0,) and PagePool(5).usable_pages == 4


# ---------------------------------------------------------------------------
# engines on shared weights
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    """The reference's cp-test model (tiny Llama from numpy seed 1234) and
    the port's model on its weights."""
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


def _serve(eng, specs):
    """Serve (prompt, max_new) pairs together; prompt + generated ids."""
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in specs]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs]


def _ragged():
    return [(_prompt(n, seed=40 + i), 4 + i) for i, n in enumerate(LENS)]


def _spec_traffic():
    cyc = np.tile(_prompt(6, seed=7), 4)[:20].astype(np.int32)
    return [(cyc, 10), (_prompt(7, seed=90), 5), (_prompt(12, seed=91), 5)]


@pytest.fixture(scope="module")
def reference(models):
    """The JAX cp=2 engines' tokens: the default kernel choice (the gather
    oracle on the CPU), then forced-fused with spec_k=2 and int8
    forced-fused with spec_k=2 (the cp Pallas kernels in interpret mode),
    with the counts of the Pallas kernels each dispatched."""
    jm, _ = models
    out = {}
    runs = (("plain", {}, _ragged(), False),
            ("fused_spec", dict(decode_kernel="fused", spec_k=2), _spec_traffic(),
             True),
            ("int8_spec", dict(decode_kernel="fused", spec_k=2, kv_quant="int8"),
             _spec_traffic(), True))
    for key, kw, specs, interpret in runs:
        jmesh.set_mesh(None)
        jprofiler.reset_flash_pallas()
        with _interpret() if interpret else contextlib.nullcontext():
            eng = JaxEngine(jm, cp=2, **ENGINE, **kw)
            out[key] = (_serve(eng, specs), jprofiler.flash_pallas_summary())
    jmesh.set_mesh(None)
    return out


@pytest.fixture
def k5_calls(monkeypatch):
    """Counts the K5 wrapper's calls by variant (one per shard)."""
    calls = {"paged_decode_fused_cp": 0, "paged_decode_fused_cp_q8": 0}
    real = pfa.paged_decode_partials

    def spy(*args, **kw):
        quant = (args[8] if len(args) > 8 else kw.get("k_scale")) is not None
        calls["paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(pfa, "paged_decode_partials", spy)
    return calls


def _engine(tm, **kw):
    return ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, **kw})


def test_cp2_greedy_identical_to_jax_cp2_and_to_cp1(models, reference, k5_calls):
    _, tm = models
    cp1 = _serve(_engine(tm, cp=1), _ragged())
    assert k5_calls["paged_decode_fused_cp"] == 0
    eng = _engine(tm, cp=2)
    assert eng.pages_per_seq == 8 and eng.pool_pages == 18  # 2 x (2 x 4 + 1)
    out = _serve(eng, _ragged())
    assert out == cp1 == reference["plain"][0]
    assert k5_calls["paged_decode_fused_cp"] > 0
    assert k5_calls["paged_decode_fused_cp"] % 2 == 0  # one per shard
    h = eng.healthz()
    assert h["cp"] == 2 and h["mesh_shape"] == {"cp": 2, "mp": 1}
    assert len(h["page_free_by_shard"]) == 2
    assert profiler.mesh_summary()["cp"] == 2
    assert eng._pool.per_shard * 2 == eng._pool.num_pages


def test_cp2_fused_spec_identical_to_jax_and_cp1(models, reference, k5_calls):
    _, tm = models
    kw = dict(decode_kernel="fused", spec_k=2)
    cp1 = _serve(_engine(tm, cp=1, **kw), _spec_traffic())
    profiler.reset_speculation()
    eng = _engine(tm, cp=2, **kw)
    eng.warmup()
    out = _serve(eng, _spec_traffic())
    assert out == cp1 == reference["fused_spec"][0]
    assert reference["fused_spec"][1].get("paged_decode_fused_cp", 0) >= 1
    assert k5_calls["paged_decode_fused_cp"] > 0
    assert profiler.speculation_summary()["accepted"] > 0


def test_int8_cp2_spec_identical_to_jax_int8_cp2(models, reference, k5_calls):
    _, tm = models
    eng = _engine(tm, cp=2, decode_kernel="fused", spec_k=2, kv_quant="int8")
    out = _serve(eng, _spec_traffic())
    assert out == reference["int8_spec"][0]
    assert reference["int8_spec"][1].get("paged_decode_fused_cp_q8", 0) >= 1
    assert k5_calls["paged_decode_fused_cp_q8"] > 0
    assert k5_calls["paged_decode_fused_cp"] == 0


def test_cp2_page_audit_across_a_prefix_hit(models, monkeypatch):
    _, tm = models
    monkeypatch.setitem(tcore._flags, "FLAGS_serve_debug_invariants", True)
    eng = _engine(tm, cp=2)
    base = _prompt(12, seed=55)
    eng.generate(base, max_new_tokens=3)
    hit = np.concatenate([base, _prompt(4, seed=56)]).astype(np.int32)
    fresh = _engine(tm, cp=2, prefix_cache=False).generate(hit, max_new_tokens=3)
    assert np.array_equal(eng.generate(hit, max_new_tokens=3), fresh)
    assert profiler.paging_summary()["cow_copies"] >= 1
    with eng._mu:
        eng._check_page_invariants_locked()
        # a sequence page on the wrong shard is caught
        eng._slot_req[0] = object()
        eng._pos[0] = 1
        eng._slot_pages[0] = [eng._pool.alloc(1)]
        eng._page_table[0, 0] = eng._slot_pages[0][0]
        with pytest.raises(AssertionError, match="shard"):
            eng._check_page_invariants_locked()


def test_cp2_eviction_reaches_pages_behind_another_shards_leaf(models, monkeypatch):
    """A cached chain alternates shards, so every cached page of one shard
    can be the parent of another shard's page.  A request that must evict
    on that shard evicts the other shard's leaf first (freeing a page
    there) to reach them, rather than fail its admission: the allocation
    the headroom check promised lands, and the tokens equal an uncached
    engine's."""
    _, tm = models
    monkeypatch.setitem(tcore._flags, "FLAGS_serve_debug_invariants", True)
    eng = _engine(tm, cp=2, pool_pages=10)  # 4 usable pages per shard
    eng.generate(_prompt(40, seed=60), max_new_tokens=3)
    # 5 committed full pages: shard 0 holds pages 0, 2, 4 of the chain,
    # shard 1 pages 1 and 3; only page 4 (shard 0) is a leaf
    assert eng._pool.free_count(0) == 1 and eng._pool.free_count(1) == 2
    # 33 positions: 3 fresh pages on shard 0, 2 on shard 1
    other = _prompt(30, seed=61)
    profiler.reset_paging()
    out = eng.generate(other, max_new_tokens=3)
    fresh = _engine(tm, cp=2, prefix_cache=False).generate(other, max_new_tokens=3)
    assert np.array_equal(out, fresh)
    assert profiler.paging_summary()["cache_evictions"] >= 3


def test_context_overflow_carries_per_shard_geometry(models):
    jm, tm = models
    jmesh.set_mesh(None)
    jeng = JaxEngine(jm, cp=2, **{**ENGINE, "max_len": 32})
    jmesh.set_mesh(None)
    eng = _engine(tm, cp=2, max_len=32)
    free = eng._pool.free_count()
    with pytest.raises(JaxContextOverflow) as ref:
        jeng.submit(_prompt(40, seed=77), max_new_tokens=4)
    with pytest.raises(ContextOverflow) as got:
        eng.submit(_prompt(40, seed=77), max_new_tokens=4)
    assert got.value.body() == ref.value.body()
    assert got.value.body()["tokens_per_shard"] == 16
    assert str(got.value) == str(ref.value)
    assert eng._pool.free_count() == free and eng.pending == 0


def test_serve_answers_context_overflow_400_with_capacity(models):
    _, tm = models
    eng = _engine(tm, cp=2, max_len=32, spec_k=2)
    server = serve(eng, port=0, block=False)
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"

    def post(body):
        req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        code, body = post({"input_ids": _prompt(40, seed=1).tolist()})
        assert code == 400 and body["type"] == "ContextOverflow"
        assert body["capacity"]["cp"] == 2 and body["capacity"]["pages_per_shard"] == 2
        p = _prompt(9, seed=2).tolist()
        code, body = post({"input_ids": p, "max_new_tokens": 5, "spec_k": 0})
        assert code == 200 and len(body["tokens"]) == 14
        code, body = post({"input_ids": p, "spec_k": -1})
        assert code == 400
    finally:
        server.stop()
