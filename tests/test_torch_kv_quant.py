"""The port's int8 KV pages against the JAX package on the CPU.

- `_quantize_kv_rows`, `_rope_page_scatter_quant` and
  `_page_decode_write_quant` leave int8 arenas and float32 scales equal bit
  for bit.
- K4's plain version (`paged_decode_fused_q8` on CPU tensors) against the
  reference's `_fused_paged_decode_quant_forward` in interpret mode, and the
  quantized gather oracle against the reference's, within 2e-5 in float32,
  on the reference's own arenas (tests/test_kv_quant.py): ragged GQA at
  sq 1 and 4, a scratch overrun, and shared pages read identically.
- `validate_kv_quant`, `kv_page_bytes`, `check_scale_arenas` and the int8
  pool's auto size give the reference's answers.
- Engines on shared weights, prefix cache on, int8: greedy tokens identical
  to the JAX engine's (copy-on-write tails, a full-page hit, evictions), at
  least 0.95 per position equal to the full-precision engine's, the COW
  copy isolating the scale rows, and prefix hits reproducing a fresh run.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu import profiler as jprofiler
from paddle_tpu import to_tensor
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=2e-5, rtol=2e-5)
ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8, prefix_cache=True)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(t):
    return np.asarray(t.numpy())


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


# ---------------------------------------------------------------------------
# the quantizing writes, bit for bit
# ---------------------------------------------------------------------------


def test_quantize_kv_rows_bit_equal_to_reference():
    r = np.random.RandomState(3)
    x = ((r.rand(5, 7, 16) - 0.5) * 4.0).astype(np.float32)
    x[0, 0] = 0.0  # a zero row: scale pinned to 1, dequantizes to exactly 0
    x[1, 0, :4] = [127.0, 2.5, -3.5, 0.5]  # scale 1: ties round half to even
    x[1, 0, 4:] = 0.0
    jq, js = jllama._quantize_kv_rows(jnp.asarray(x))
    tq, ts = tllama._quantize_kv_rows(_t(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert ts.shape == (5, 7, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[1, 0, :4].tolist() == [127, 2, -4, 0] and ts[0, 0].item() == 1.0
    # symmetric round to nearest: each element within half a step
    err = np.abs(x - tq.numpy().astype(np.float32) * ts.numpy())
    assert (err <= ts.numpy() * 0.5 + 1e-7).all()


def _quant_arenas(pages, ps, hk, d):
    return ([np.zeros((pages, ps, hk, d), np.int8) for _ in range(2)]
            + [np.zeros((pages, ps, hk, 1), np.float32) for _ in range(2)])


@pytest.mark.parametrize("start", [None, 5])
def test_rope_page_scatter_quant_bit_equal_to_reference(start):
    """XLA's CPU backend contracts RoPE's x*cos + rotate(x)*sin into one
    FMA, which PyTorch does not, so on general inputs the rotated rows
    differ by an ulp and a row on a rounding boundary would quantize one
    step apart.  Inputs on coarse grids (k in 1/64ths, cos and sin in
    1/8ths) make every product exact, so both roundings agree and the
    quantized rows, scales and addresses must match bit for bit."""
    rng = np.random.default_rng(17)
    s, hk, h, d, ps = 8, 2, 4, 16, 4

    def grid(x, step):
        return (np.round(x / step) * step).astype(np.float32)

    cos = grid(np.cos(rng.standard_normal((32, d))), 1 / 8)
    sin = grid(np.sin(rng.standard_normal((32, d))), 1 / 8)
    q = grid(rng.standard_normal((1, s, h, d)), 1 / 64)
    k = grid(rng.standard_normal((1, s, hk, d)), 1 / 64)
    v = rng.standard_normal((1, s, hk, d)).astype(np.float32)
    table = np.array([3, 1, 4, 2, 5], np.int32)
    arenas = _quant_arenas(6, ps, hk, d)
    st = None if start is None else np.full(1, start, np.int32)
    j = jllama._rope_page_scatter_quant(
        *(to_tensor(a) for a in arenas), to_tensor(q), to_tensor(k),
        to_tensor(v), to_tensor(cos), to_tensor(sin), to_tensor(table),
        to_tensor(np.int32(6)), None if st is None else to_tensor(st))
    t_arenas = [_t(a.copy()) for a in arenas]
    tq, tk = tllama._rope_page_scatter_quant(
        *t_arenas, *(_t(x) for x in (q, k, v, cos, sin, table)), 6,
        None if st is None else _t(st))
    np.testing.assert_array_equal(tq.numpy(), _np(j[0]))
    np.testing.assert_array_equal(tk.numpy(), _np(j[1]))
    # scratch page 0 takes the redirected rows of both: compare the rest.
    # int8 rows bit for bit
    for got, ref in zip(t_arenas[:2], j[2:4]):
        np.testing.assert_array_equal(got.numpy()[1:], _np(ref)[1:])
    assert (t_arenas[0].numpy()[1:] != 0).any()
    # scales: the reference's stated math (amax / 127, as its eager
    # `_quantize_kv_rows` computes it) bit for bit; inside the fused scatter
    # XLA's CPU compiler turns that division into a multiplication by 1/127,
    # which may land one ulp away
    rows = [((start or 0) + i) for i in range(6)]
    for got, ref, x in zip(t_arenas[2:], j[4:], (tk.numpy()[0], v[0])):
        stated = np.asarray(jllama._quantize_kv_rows(jnp.asarray(x))[1])
        for i, gidx in enumerate(rows):
            np.testing.assert_array_equal(
                got.numpy()[table[gidx // ps], gidx % ps], stated[i])
        np.testing.assert_allclose(got.numpy()[1:], _np(ref)[1:], rtol=1.2e-7, atol=0)


def test_page_decode_write_quant_bit_equal_to_reference():
    rng = np.random.default_rng(19)
    ps, hk, d = 4, 2, 16
    arena, _, scales, _ = _quant_arenas(5, ps, hk, d)
    new = rng.standard_normal((3, 1, hk, d)).astype(np.float32)
    new[2] = 0.0  # an inactive slot's zero row lands on scratch at scale 1
    tables = np.array([[1, 2], [3, 4], [0, 0]], np.int32)
    pos = np.array([5, 2, 0], np.int32)
    ja, js = jllama._page_decode_write_quant(
        to_tensor(arena), to_tensor(scales), to_tensor(new), to_tensor(tables),
        to_tensor(pos))
    ta, ts = _t(arena.copy()), _t(scales.copy())
    tllama._page_decode_write_quant(ta, ts, _t(new), _t(tables), _t(pos))
    np.testing.assert_array_equal(ta.numpy(), _np(ja))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    assert (ta.numpy()[2, 1] != 0).any() and ts.numpy()[0, 0, 0, 0] == 1.0


# ---------------------------------------------------------------------------
# K4 and the quantized oracle
# ---------------------------------------------------------------------------


def _quant_arena(num_pages=9, ps=8, hk=2, d=16, seed=0):
    """The reference test's arenas (tests/test_kv_quant.py:130): random int8
    rows, per-row scales, scratch page 0 all-zero with scale 1."""
    r = np.random.RandomState(seed)
    qk = r.randint(-127, 128, size=(num_pages, ps, hk, d)).astype(np.int8)
    qv = r.randint(-127, 128, size=(num_pages, ps, hk, d)).astype(np.int8)
    sk = (r.rand(num_pages, ps, hk, 1).astype(np.float32) * 0.02) + 1e-4
    sv = (r.rand(num_pages, ps, hk, 1).astype(np.float32) * 0.02) + 1e-4
    qk[0] = qv[0] = 0
    sk[0] = sv[0] = 1.0
    return qk, qv, sk, sv


def _both(q, ak, av, ks, vs, tables, pos, max_len):
    """(port K4 plain, reference Pallas K4 in interpret mode, port gather,
    reference gather) on one set of numpy inputs."""
    jin = [jnp.asarray(x) for x in (q, ak, av)]
    with _interpret():
        ref = fa.paged_decode_attention_array(
            *jin, jnp.asarray(tables), jnp.asarray(pos), max_len,
            kernel="fused", k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    ref_gather = fa.paged_decode_attention_array(
        *jin, jnp.asarray(tables), jnp.asarray(pos), max_len, kernel="gather",
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    pos_t = _t(np.broadcast_to(np.asarray(pos, np.int32), (q.shape[0],)).copy())
    tin = [_t(x) for x in (q, ak, av, ks, vs, tables)]
    pfa.reset_launch_counts()
    out = pfa.paged_decode_fused_q8(*tin, pos_t, max_len)
    gather = pfa.paged_decode_attention(
        tin[0], tin[1], tin[2], tin[5], pos_t, max_len, kernel="gather",
        k_scale=tin[3], v_scale=tin[4])
    assert pfa.launch_counts["paged_decode_fused_q8"] == 0  # CPU: plain version
    return out.numpy(), np.asarray(ref), gather.numpy(), np.asarray(ref_gather)


@pytest.mark.parametrize("sq", [1, 4])
def test_k4_plain_matches_reference_kernel_ragged_gqa(sq):
    ak, av, ks, vs = _quant_arena()
    q = (np.random.RandomState(7).rand(4, sq, 4, 16) - 0.5).astype(np.float32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 0, 0, 0], [8, 3, 5, 1]],
                      np.int32)
    pos = np.array([27, 11, 3, 20], np.int32)
    out, ref, gather, ref_gather = _both(q, ak, av, ks, vs, tables, pos, 28)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(gather, ref_gather, **TOL)
    np.testing.assert_allclose(out, gather, **TOL)


def test_k4_plain_scratch_overrun_stays_finite():
    ak, av, ks, vs = _quant_arena(seed=5)
    q = (np.random.RandomState(13).rand(3, 4, 4, 16) - 0.5).astype(np.float32)
    tables = np.array([[3, 5, 0, 0], [1, 2, 6, 7], [0, 0, 0, 0]], np.int32)
    pos = np.array([14, 9, 0], np.int32)
    out, ref, gather, ref_gather = _both(q, ak, av, ks, vs, tables, pos, 32)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_allclose(gather, ref_gather, **TOL)


def test_k4_plain_reads_shared_pages_identically():
    ak, av, ks, vs = _quant_arena(seed=3)
    q1 = (np.random.RandomState(11).rand(1, 1, 4, 16) - 0.5).astype(np.float32)
    q = np.concatenate([q1, q1])
    tables = np.array([[2, 4, 6, 0], [2, 4, 6, 0]], np.int32)
    out, ref, _, _ = _both(q, ak, av, ks, vs, tables, 17, 32)
    np.testing.assert_allclose(out, ref, **TOL)
    np.testing.assert_array_equal(out[0], out[1])


def test_k4_plain_keeps_q_dtype_and_checks_scales():
    ak, av, ks, vs = (_t(x) for x in _quant_arena())
    q = torch.zeros(1, 1, 4, 16, dtype=torch.bfloat16)
    t = torch.tensor([[1, 2, 0, 0]], dtype=torch.int32)
    out = pfa.paged_decode_attention(q, ak, av, t, 5, 32, k_scale=ks, v_scale=vs)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    with pytest.raises(ValueError, match="together"):
        pfa.paged_decode_attention(q, ak, av, t, 5, 32, v_scale=vs)
    with pytest.raises(ValueError, match="scales must be"):
        pfa.paged_decode_fused_q8(q, ak, av, ks[:, :4], vs, t, torch.tensor([5]).int(), 32)


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


def test_validate_kv_quant_and_page_bytes_match_reference():
    for mode in (None, "none", "INT8", " int8 "):
        assert tpaging.validate_kv_quant(mode) == jpaging.validate_kv_quant(mode)
    for bad, paged in (("int4", True), ("int8", False)):
        with pytest.raises(tpaging.QuantConfigError) as te:
            tpaging.validate_kv_quant(bad, paged=paged)
        with pytest.raises(jpaging.QuantConfigError) as je:
            jpaging.validate_kv_quant(bad, paged=paged)
        assert str(te.value) == str(je.value)
    for args in ((8, 2, 128, 2), (128, 32, 128, 2), (8, 2, 16, 4)):
        for quant in ("none", "int8"):
            assert (tpaging.kv_page_bytes(*args, quant)
                    == jpaging.kv_page_bytes(*args, quant))
    # bf16 at head_dim 128: int8 rows and their scales in ~1/1.94 the bytes
    full, q8 = (tpaging.kv_page_bytes(128, 32, 128, 2, m) for m in ("none", "int8"))
    assert 1.9 < full / q8 < 2.0


def test_paged_kv_cache_int8_layout_and_scale_check():
    c = tllama.PagedKVCache(4, 8, 2, 16, quant="int8", device="cpu")
    assert c.k.dtype == torch.int8 and tuple(c.k.shape) == (4, 8, 2, 16)
    assert tuple(c.k_scale.shape) == (4, 8, 2, 1) and c.k_scale.dtype == torch.float32
    assert not c.k.any() and not c.k_scale.any()  # zeros, as the reference's
    tpaging.check_scale_arenas([c], 4, 8)
    full = tllama.PagedKVCache(4, 8, 2, 16, device="cpu")
    assert full.quant == "none" and full.k_scale is None
    tpaging.check_scale_arenas([full], 4, 8)
    c.k_scale = None
    with pytest.raises(AssertionError, match="scale"):
        tpaging.check_scale_arenas([c], 4, 8)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


def _traffic():
    """Shared 12-token base (a full page + a 4-row tail: hits copy the
    tail), a full-page extension, unrelated prompts; served one at a time."""
    base = _prompt(12, 80)
    a = np.concatenate([base, _prompt(4, 81)])
    prompts = [base, a, np.concatenate([base, _prompt(6, 82)]), _prompt(10, 83),
               np.concatenate([a, _prompt(5, 84)]), _prompt(15, 85),
               np.concatenate([base, _prompt(3, 86)])]
    return [p.astype(np.int32) for p in prompts], [4, 6, 5, 6, 4, 5, 6]


def _serve_one_by_one(eng, prompts, news):
    outs = []
    for p, n in zip(prompts, news):
        req = eng.submit(p, max_new_tokens=n)
        eng.run_until_idle()
        outs.append(req.wait(1).tolist())
    return outs


@pytest.fixture(scope="module")
def reference(models):
    """The JAX int8 engine's tokens and paging counters, with the auto pool
    and an evicting one (7 pages), plus both engines' pool sizes."""
    jm, _ = models
    prompts, news = _traffic()
    out = {}
    for pool in (None, 7):
        jprofiler.reset_paging()
        eng = JaxEngine(jm, kv_quant="int8", pool_pages=pool, **ENGINE)
        out[pool] = (_serve_one_by_one(eng, prompts, news), jprofiler.paging_summary(),
                     eng.pool_pages)
    return prompts, news, out


@pytest.mark.parametrize("pool", [None, 7], ids=["auto_pool", "evicting_pool"])
def test_int8_greedy_tokens_identical_to_jax_engine(models, reference, pool):
    _, tm = models
    prompts, news, out = reference
    ref_outs, ref_paging, ref_pages = out[pool]
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant="int8",
                                   pool_pages=pool, **ENGINE)
    assert eng.pool_pages == ref_pages  # auto: the full-precision pool's bytes
    tpaging.check_scale_arenas(eng._arenas, eng.pool_pages, eng.page_size)
    eng.warmup()
    profiler.reset_paging()
    assert _serve_one_by_one(eng, prompts, news) == ref_outs
    paging = profiler.paging_summary()
    for key in ("prefix_hits", "cow_copies", "cache_commits", "cache_evictions"):
        assert paging.get(key, 0) == ref_paging.get(key, 0), key
    assert paging["prefix_hits"] >= 3 and paging["cow_copies"] >= 1
    if pool == 7:
        assert paging["cache_evictions"] > 0
    health = eng.healthz()
    assert health["kv_quant"] == "int8" and health["prefix_cache_size"] > 0
    summary = profiler.kv_quant_summary()
    assert summary["mode"] == "int8" and summary["scale_bytes"] > 0


def test_int8_matches_full_precision_per_position(models):
    """The reference's quality bar and traffic (tests/test_kv_quant.py
    test_tokens_match_full_precision): mixed ragged prompts, 2 slots, the
    int8 engine's greedy tokens equal to the full-precision engine's at
    >= 0.95 per position on average over the requests."""
    _, tm = models
    lens = [5, 12, 9, 15, 3]
    outs = {}
    for quant in ("none", "int8"):
        eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant=quant, **ENGINE)
        reqs = [eng.submit(_prompt(n, seed=30 + i), max_new_tokens=6)
                for i, n in enumerate(lens)]
        eng.run_until_idle()
        outs[quant] = [r.wait(1)[n:] for r, n in zip(reqs, lens)]
    rates = [float(np.mean(a == b)) for a, b in zip(outs["none"], outs["int8"])]
    assert float(np.mean(rates)) >= 0.95, rates


def test_cow_copies_the_scale_rows_and_hits_reproduce_fresh_runs(models):
    """B copy-on-writes the shared tail page, values and scales, so its
    divergent suffix never changes what A reads; every output equals a
    no-cache int8 engine's, and a repeated prompt (a hit on its own pages)
    reproduces its first run."""
    _, tm = models
    base = _prompt(12, 70)
    pa = np.concatenate([base, _prompt(4, 71)]).astype(np.int32)
    pb = np.concatenate([base, _prompt(4, 72)]).astype(np.int32)
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant="int8", **ENGINE)
    eng.generate(base, max_new_tokens=2)  # commits a full page + a tail
    tail = eng._prefix.lookup(pb)[2]
    before = [a.k_scale[tail].clone() for a in eng._arenas]
    profiler.reset_paging()
    out_b = eng.generate(pb, max_new_tokens=6)
    assert profiler.paging_summary()["cow_copies"] == 1
    assert all(torch.equal(a.k_scale[tail], s) for a, s in zip(eng._arenas, before))
    out_a = eng.generate(pa, max_new_tokens=6)
    again = eng.generate(pa, max_new_tokens=6)
    fresh = ContinuousBatchingEngine(tm, device="cpu", kv_quant="int8",
                                     **{**ENGINE, "prefix_cache": False})
    assert np.array_equal(out_b, fresh.generate(pb, max_new_tokens=6))
    assert np.array_equal(out_a, fresh.generate(pa, max_new_tokens=6))
    assert np.array_equal(again, out_a)


def test_engine_rejects_unknown_modes_and_int8_without_paging(models):
    _, tm = models
    with pytest.raises(tpaging.QuantConfigError, match="paged"):
        ContinuousBatchingEngine(tm, device="cpu", **{**ENGINE, "paged": False},
                                 kv_quant="int8")
    with pytest.raises(tpaging.QuantConfigError, match="fp4"):
        ContinuousBatchingEngine(tm, device="cpu", kv_quant="fp4", **ENGINE)
    # an explicit pool is kept as given
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant="int8",
                                   pool_pages=9, **ENGINE)
    assert eng.pool_pages == 9
