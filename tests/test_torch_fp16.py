"""float16 operands of the port's attention kernels against the JAX package
on the CPU.

- K1 (plain, with segment ids and key bias, with the ring operands), K3,
  K6, K2 (over a page arena and over a dense cache's page view), K4 (an
  fp16 q over int8 pages) and K5 (a cp shard's partials) in float16: the
  same numpy inputs go through the reference's Pallas kernels in interpret
  mode (or its dense math where that is the reference's path) and the
  port's wrappers, whose CPU tensors take the plain versions.
- A tiny Llama cast to float16 served by both engines on shared weights
  (fresh prefills, a prefix-cache hit's chunk prefill, int8 pages): greedy
  tokens identical; teacher-forced logits within FP16_LOGITS.
- The dispatch: a float16 tensor takes the path a bfloat16 one of its shape
  takes, and on the card (a fake library stands in for it) the wrappers
  pass dtype code 2 and count the launch under that path.

Tolerances.  Both sides compute scores and sums in float32 from the same
float16 values and round p to float16 where the reference does
(`p.astype(v.dtype)`), then round the output to float16; the float32 sums
run in different orders, so a result can land one float16 ulp apart:
FP16_TOL (atol 2e-3, rtol 4e-3; the ulp is 2^-11 relative, 4.9e-4) for
float16 outputs and float32 partials, LSE_TOL for the float32 lse.  The
reference's XLA and the port's torch round the model's float16 matmuls and
RoPE at other places, so logits are held to FP16_LOGITS, not to an ulp.
"""

import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as pfa
from test_torch_kernel_paths import fake_card  # noqa: F401  (a fixture)

F16, BF16, F32 = torch.float16, torch.bfloat16, torch.float32
FP16_TOL = dict(atol=2e-3, rtol=4e-3)
LSE_TOL = dict(atol=1e-4, rtol=1e-4)
FP16_LOGITS = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _counts():
    pfa.reset_launch_counts()
    yield
    pfa.reset_launch_counts()


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


def _h(rng, *shape, scale=1.0):
    """float16 numpy values from a seeded generator."""
    return (rng.standard_normal(shape) * scale).astype(np.float16)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _bh(x):
    """[b, s, h, d] -> the reference kernels' [b * h, s, d]."""
    b, s, h, d = x.shape
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d))


def _bshd(x, b, h):
    """[b * h, s, d] -> [b, s, h, d] float32."""
    x = np.asarray(x, np.float32)
    return np.transpose(x.reshape(b, h, *x.shape[1:]), (0, 2, 1, 3))


def _lse(lse, b, h):
    return np.asarray(lse, np.float32).reshape(b, h, -1)


# ---------------------------------------------------------------------------
# K1 and K3
# ---------------------------------------------------------------------------


# b, s, h, d, causal, masking
K1_CASES = [
    (2, 128, 2, 32, True, None),
    (1, 256, 2, 16, False, None),
    (2, 128, 2, 32, True, "both"),
    (2, 128, 2, 16, False, "kbias"),
]


def _masking(kind, b, s, rng):
    """Two packed segments per row and a key-padding bias, as K1 gets them."""
    if kind is None:
        return None, None
    segs = np.zeros((b, s), np.int32)
    segs[:, s // 3:] = 1
    bias = np.zeros((b, s), np.float32)
    bias[:, s - 5:] = -1e30
    return (segs if kind == "both" else None), bias


@pytest.mark.parametrize("b,s,h,d,causal,masking", K1_CASES)
def test_k1_k3_fp16_match_reference_kernels(b, s, h, d, causal, masking):
    rng = np.random.default_rng(s + d)
    q, k, v, g = (_h(rng, b, s, h, d) for _ in range(4))
    segs, bias = _masking(masking, b, s, rng)
    scale = 1.0 / np.sqrt(d)
    kw = dict(segments=None if segs is None else jnp.asarray(segs)[:, :, None],
              kbias=None if bias is None else jnp.asarray(bias)[:, :, None],
              n_heads=h, interpret=True)
    out, lse = fa._pallas_flash_forward(_bh(q), _bh(k), _bh(v), causal, scale, **kw)
    dq, dk, dv = fa._pallas_flash_backward(_bh(q), _bh(k), _bh(v), _bh(g), out,
                                           lse, causal, scale, **kw)
    assert out.dtype == jnp.float16 and dq.dtype == jnp.float16
    tq, tk, tv, tg = map(_t, (q, k, v, g))
    ts = None if segs is None else _t(segs)
    tb = None if bias is None else _t(bias)
    got, got_lse = pfa.flash_forward(tq, tk, tv, causal, scale, ts, tb)
    assert got.dtype == F16
    np.testing.assert_allclose(_np(got), _bshd(out, b, h), **FP16_TOL)
    np.testing.assert_allclose(_np(got_lse), _lse(lse, b, h), **LSE_TOL)
    # K3 from the reference's own out and lse
    ref_out = _t(_bshd(out, b, h).astype(np.float16))
    grads = pfa.flash_backward(tq, tk, tv, ref_out, _t(_lse(lse, b, h)), tg,
                               causal, scale, ts, tb)
    for x, want, name in zip(grads, (dq, dk, dv), "qkv"):
        assert x.dtype == F16
        np.testing.assert_allclose(_np(x), _bshd(want, b, h), err_msg=f"d{name}",
                                   **FP16_TOL)


def test_k1_k3_fp16_ring_operands_match_reference_kernels():
    """A zig-zag rank's q (chunks 0 and 3 of 512) against the whole key
    sequence with q_offset, K3 with the same offsets; then a hop carried onto
    a float32 partial, as the ring chains them."""
    rng = np.random.default_rng(9)
    b, h, d, S, c = 1, 2, 16, 512, 128
    q, g = _h(rng, b, 2 * c, h, d), _h(rng, b, 2 * c, h, d)
    k, v = _h(rng, b, S, h, d), _h(rng, b, S, h, d)
    spans = [(0, c), (3 * c, c)]
    scale = 0.25
    ro, rl = fa._pallas_flash_forward(_bh(q), _bh(k), _bh(v), True, scale,
                                      interpret=True, block_q=c,
                                      q_offset=fa.q_block_starts(spans, c))
    starts = pfa.q_block_starts(spans, c, "cpu")
    out, lse = pfa.flash_forward(_t(q), _t(k), _t(v), True, scale, q_offset=starts)
    np.testing.assert_allclose(_np(out), _bshd(ro, b, h), **FP16_TOL)
    np.testing.assert_allclose(_np(lse), _lse(rl, b, h), **LSE_TOL)
    rg = fa._pallas_flash_backward(_bh(q), _bh(k), _bh(v), _bh(g), ro, rl, True,
                                   scale, interpret=True, block_q=c,
                                   q_offset=fa.q_block_starts(spans, c))
    got = pfa.flash_backward(_t(q), _t(k), _t(v), _t(_bshd(ro, b, h).astype(np.float16)),
                             _t(_lse(rl, b, h)), _t(g), True, scale, q_offset=starts)
    for x, want, name in zip(got, rg, "qkv"):
        np.testing.assert_allclose(_np(x), _bshd(want, b, h), err_msg=f"d{name}",
                                   **FP16_TOL)
    # carry: a causal first hop in float32, a full second hop merged onto it
    k1, v1 = _h(rng, b, 2 * c, h, d), _h(rng, b, 2 * c, h, d)
    r0 = fa._pallas_flash_forward(_bh(q), _bh(k[:, :2 * c]), _bh(v[:, :2 * c]),
                                  True, scale, interpret=True,
                                  out_dtype=jnp.float32)
    r1 = fa._pallas_flash_forward(_bh(q), _bh(k1), _bh(v1), False, scale,
                                  interpret=True, carry=r0)
    p0 = pfa.flash_forward(_t(q), _t(k[:, :2 * c]), _t(v[:, :2 * c]), True,
                           scale, out_dtype=F32)
    p1 = pfa.flash_forward(_t(q), _t(k1), _t(v1), False, scale, carry=p0)
    assert p0[0].dtype == F32 and p1[0].dtype == F16
    for (ro_, rl_), (po, pl) in ((r0, p0), (r1, p1)):
        np.testing.assert_allclose(_np(po), _bshd(ro_, b, h), **FP16_TOL)
        np.testing.assert_allclose(_np(pl), _lse(rl_, b, h), **LSE_TOL)


# ---------------------------------------------------------------------------
# K6 and K2 over a dense cache
# ---------------------------------------------------------------------------


def _dense_inputs(b, sq, h, hk, d, L, pos, seed):
    rng = np.random.default_rng(seed)
    q = _h(rng, b, sq, h, d)
    k = np.zeros((b, L, hk, d), np.float16)
    v = np.zeros((b, L, hk, d), np.float16)
    live = min(pos + sq, L)
    k[:, :live] = _h(rng, b, live, hk, d, scale=0.5)
    v[:, :live] = _h(rng, b, live, hk, d, scale=0.5)
    return q, k, v


@pytest.mark.parametrize("b,sq,h,hk,d,L,pos,kernel", [
    (2, 64, 4, 2, 16, 128, 30, "dense_decode"),      # K6: the Pallas kernel
    (2, 1, 4, 2, 16, 256, 170, "paged_decode_fused"),  # K2 over the page view
    (1, 5, 4, 4, 16, 256, 100, "paged_decode_fused"),
])
def test_k6_and_dense_view_fp16_match_reference(b, sq, h, hk, d, L, pos, kernel):
    q, k, v = _dense_inputs(b, sq, h, hk, d, L, pos, seed=L + sq)
    with _interpret():
        ref = np.asarray(fa.decode_attention_array(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)), np.float32)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    took = pfa.takes_dense_decode(sq, d, L, per_row_pos=False)
    assert took == (kernel == "dense_decode")
    out = pfa.decode_attention(_t(q), _t(k), _t(v), pos_t)
    assert out.dtype == F16
    np.testing.assert_allclose(_np(out), ref, **FP16_TOL)


# ---------------------------------------------------------------------------
# K2, K4 and K5 over page arenas
# ---------------------------------------------------------------------------


def _paged_case(seed, b, sq, h, hk, d=16, ps=8, P=6, max_len=44):
    rng = np.random.default_rng(seed)
    pages = 1 + b * P
    ak, av = _h(rng, pages, ps, hk, d), _h(rng, pages, ps, hk, d)
    tables = rng.permutation(np.arange(1, pages)).astype(np.int32).reshape(b, P)
    pos = rng.integers(0, max_len - sq, size=b).astype(np.int32)
    pos[0], pos[-1] = 0, max_len - sq
    return _h(rng, b, sq, h, d), ak, av, tables, pos, max_len


@pytest.mark.parametrize("b,sq,h,hk", [(3, 1, 4, 2), (2, 4, 4, 2), (2, 3, 4, 1)])
def test_k2_fp16_matches_reference_kernel(b, sq, h, hk):
    q, ak, av, tables, pos, max_len = _paged_case(b * 10 + sq, b, sq, h, hk)
    with _interpret():
        ref = fa.paged_decode_attention_array(
            jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av), jnp.asarray(tables),
            jnp.asarray(pos), max_len, kernel="fused")
    assert ref.dtype == jnp.float16
    out = pfa.paged_decode_fused(_t(q), _t(ak), _t(av), _t(tables), _t(pos), max_len)
    assert out.dtype == F16
    np.testing.assert_allclose(_np(out), _np(ref), **FP16_TOL)


def _quant_arena(num_pages=9, ps=8, hk=2, d=16, seed=0):
    """Random int8 rows with per-row float32 scales; scratch page 0 zero."""
    r = np.random.RandomState(seed)
    qk = r.randint(-127, 128, size=(num_pages, ps, hk, d)).astype(np.int8)
    qv = r.randint(-127, 128, size=(num_pages, ps, hk, d)).astype(np.int8)
    sk = (r.rand(num_pages, ps, hk, 1).astype(np.float32) * 0.02) + 1e-4
    sv = (r.rand(num_pages, ps, hk, 1).astype(np.float32) * 0.02) + 1e-4
    qk[0] = qv[0] = 0
    sk[0] = sv[0] = 1.0
    return qk, qv, sk, sv


@pytest.mark.parametrize("sq", [1, 4])
def test_k4_fp16_q_over_int8_pages_matches_reference_kernel(sq):
    ak, av, ks, vs = _quant_arena()
    q = (np.random.RandomState(7).rand(4, sq, 4, 16) - 0.5).astype(np.float16)
    tables = np.arange(1, 9, dtype=np.int32).reshape(4, 2)
    pos = np.asarray([0, 3, 9, 15 - sq + 1], np.int32)
    with _interpret():
        ref = fa.paged_decode_attention_array(
            jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av), jnp.asarray(tables),
            jnp.asarray(pos), 16, kernel="fused", k_scale=jnp.asarray(ks),
            v_scale=jnp.asarray(vs))
    out = pfa.paged_decode_fused_q8(_t(q), _t(ak), _t(av), _t(ks), _t(vs),
                                    _t(tables), _t(pos), 16)
    assert out.dtype == F16 and ref.dtype == jnp.float16
    np.testing.assert_allclose(_np(out), _np(ref), **FP16_TOL)


@pytest.mark.parametrize("quant", [False, True], ids=["fp16", "int8"])
@pytest.mark.parametrize("sq", [1, 3])
def test_k5_fp16_partials_match_reference_kernel(sq, quant):
    cp, per, ps, hk, d = 2, 8, 8, 2, 16
    rng = np.random.default_rng(sq + 2 * quant)
    if quant:
        k8, v8, ks, vs = _quant_arena(num_pages=cp * per, hk=hk, seed=sq)
        for s in range(cp):
            k8[s * per] = v8[s * per] = 0
            ks[s * per] = vs[s * per] = 1.0
        k, v = k8, v8
    else:
        k, v = _h(rng, cp * per, ps, hk, d), _h(rng, cp * per, ps, hk, d)
        for s in range(cp):
            k[s * per] = v[s * per] = 0
        ks = vs = None
    b, P = 3, 8
    nxt = [s * per + 1 for s in range(cp)]
    tables = np.zeros((b, P), np.int32)
    for i in range(b):
        for j in range(P // 2):
            tables[i, j] = nxt[j % cp]
            nxt[j % cp] += 1
    q = _h(rng, b, sq, 4, d)
    pos = np.asarray([29 - sq, 5, 17], np.int32)
    R = 2 * sq
    for s, (loc, base) in enumerate(pfa.cp_local_tables(_t(tables), cp, per, ps)):
        sl = slice(s * per, (s + 1) * per)
        scales = (ks[sl], vs[sl]) if quant else (None, None)
        with _interpret():
            ref = fa._fused_paged_decode_partials_forward(
                jnp.asarray(q), jnp.asarray(k[sl]), jnp.asarray(v[sl]),
                jnp.asarray(loc.numpy()), jnp.asarray(base.numpy()),
                jnp.asarray(pos), 32, 0.25, interpret=True,
                k_scale=None if not quant else jnp.asarray(scales[0]),
                v_scale=None if not quant else jnp.asarray(scales[1]))
        r_acc, r_m, r_l = (np.asarray(x, np.float32)[:, :, :R] for x in ref)
        got = pfa.paged_decode_partials(
            _t(q), _t(k[sl]), _t(v[sl]), loc, base, _t(pos), 32, 0.25,
            *(None if x is None else _t(x) for x in scales))
        g_acc, g_m, g_l = (x.numpy() for x in got)
        seen = (r_m > -1e29)[..., 0]
        assert seen.any()
        np.testing.assert_allclose(g_m, r_m, **LSE_TOL)
        np.testing.assert_allclose(g_l[seen], r_l[seen], **FP16_TOL)
        np.testing.assert_allclose(g_acc[seen], r_acc[seen], **FP16_TOL)


# ---------------------------------------------------------------------------
# a float16 tiny Llama served by both engines
# ---------------------------------------------------------------------------


ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8)


@pytest.fixture(scope="module")
def models():
    """Tiny Llama from numpy seed 1234, cast to float16 in the reference, and
    the port's float16 model on the same float32 weights (both round them to
    float16 once)."""
    paddle.seed(1234)
    np.random.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu",
                                 dtype="float16")
    load_reference_state(tm, state)
    jm.half()
    return jm, tm


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _serve(eng, prompts, news, one_by_one=False):
    if one_by_one:  # each commits its pages before the next looks up
        out = []
        for p, n in zip(prompts, news):
            r = eng.submit(p, max_new_tokens=n)
            eng.run_until_idle()
            out.append(r.wait(1).tolist())
        return out
    reqs = [eng.submit(p, max_new_tokens=n) for p, n in zip(prompts, news)]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs]


def test_fp16_llama_logits_match_reference(models):
    jm, tm = models
    ids = np.stack([_prompt(24, 0), _prompt(24, 1)])
    ref = np.asarray(jm(paddle.to_tensor(ids)).numpy(), np.float32)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    got = got[0] if isinstance(got, tuple) else got
    assert got.dtype == F16
    np.testing.assert_allclose(_np(got), ref, **FP16_LOGITS)


def _traffic():
    return ([_prompt(5, 0), _prompt(12, 1), _prompt(20, 2), _prompt(9, 3)],
            [20, 16, 24, 12])


def test_fp16_engines_serve_identical_tokens(models):
    jm, tm = models
    prompts, news = _traffic()
    ref = _serve(JaxEngine(jm, **ENGINE), prompts, news)
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert eng._arenas[0].k.dtype == F16
    assert _serve(eng, prompts, news) == ref


def test_fp16_int8_engines_agree_up_to_near_ties(models):
    """int8 pages under a float16 model.  The two packages quantize a row
    with scales that can differ by an ulp (XLA rewrites amax / 127 as amax *
    (1/127) and fuses RoPE into FMAs), so an int8 value can differ by one
    and move a logit by a float16 ulp; at this size that flips a greedy
    near tie now and then, and from there the streams part.  So the tokens
    are held identical up to each request's first difference, and at that
    step the port's kept logits of the two candidates must lie within
    FP16_LOGITS' atol of each other (a tie at float16's resolution)."""
    jm, tm = models
    prompts, news = _traffic()
    ref = _serve(JaxEngine(jm, kv_quant="int8", **ENGINE), prompts, news)
    eng = ContinuousBatchingEngine(tm, device="cpu", kv_quant="int8", **ENGINE)
    assert eng._arenas[0].k.dtype == torch.int8
    reqs = [eng.submit(p, max_new_tokens=n, keep_logits=True)
            for p, n in zip(prompts, news)]
    eng.run_until_idle()
    same = 0
    for p, want, req in zip(prompts, ref, reqs):
        got = req.wait(1).tolist()
        gen_w, gen_g = want[len(p):], got[len(p):]
        assert len(gen_w) == len(gen_g)
        first = next((i for i, (a, b) in enumerate(zip(gen_w, gen_g)) if a != b),
                     None)
        if first is None:
            same += 1
            continue
        row = req.logits[first].float()
        gap = float(row[gen_g[first]] - row[gen_w[first]])
        assert 0.0 <= gap <= FP16_LOGITS["atol"], (first, gap)
    assert same >= len(prompts) // 2  # most streams agree end to end


def test_fp16_prefix_hit_chunk_prefill_matches_reference(models):
    """A shared 18-token prefix: the second request's suffix runs the chunk
    prefill (K2's chunk window on the card) over the first one's pages."""
    jm, tm = models
    sys_p = _prompt(18, 7)
    prompts = [np.concatenate([sys_p, _prompt(n, 8 + n)]) for n in (3, 9)]
    ref = _serve(JaxEngine(jm, **ENGINE), prompts, [10, 10], one_by_one=True)
    eng = ContinuousBatchingEngine(tm, device="cpu", **ENGINE)
    assert _serve(eng, prompts, [10, 10], one_by_one=True) == ref
    assert eng._prefix is not None and len(eng._prefix) > 0


# ---------------------------------------------------------------------------
# the dispatch: float16 takes bfloat16's paths, with dtype code 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [1, 15, 16, 64, 127, 128, 2048])
@pytest.mark.parametrize("d", [36, 64, 128, 256])
def test_fp16_paths_are_the_bf16_paths(rows, d):
    assert pfa.flash_path(rows, d, F16) == pfa.flash_path(rows, d, BF16)
    assert pfa.paged_path(rows, d, F16) == pfa.paged_path(rows, d, BF16)


def test_dtype_code_of_a_float16_card_tensor_is_2():
    card = types.SimpleNamespace(dtype=F16, device=torch.device("cuda"))
    assert pfa._dtype_code(card, "flash_fwd") == 2
    assert pfa._dtype_code(torch.zeros(1, dtype=F16), "flash_fwd") == 2
    assert pfa._dtype_code(torch.zeros(1, dtype=BF16), "flash_fwd") == 1
    assert not hasattr(pfa, "FP16_ITEM")


@pytest.mark.parametrize("s, d, path", [(128, 128, "wgmma"), (2048, 64, "wgmma"),
                                        (100, 128, "mma"), (200, 256, "fma")])
def test_fp16_flash_wrappers_pass_code_2_on_the_bf16_path(fake_card, s, d, path):
    g = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn(1, s, heads, d, generator=g).to(F16) for heads in (8, 2, 2))
    pfa.flash_forward(q, k, v)
    pfa.dense_decode(q, k, v, torch.tensor(0, dtype=torch.int32))
    pfa.flash_backward(q, k, v, q, torch.zeros(1, 8, s), q)
    (fwd, fa_), (dec, da_), (bwd, ba_) = fake_card.calls
    code = {"fma": 0, "mma": 1, "wgmma": 2}[path]
    assert fwd == "ptt_flash_fwd" and fa_[12:14] == (2, code)
    assert dec == "ptt_dense_decode" and da_[12:14] == (2, code)
    assert bwd == "ptt_flash_bwd" and ba_[17:19] == (2, code)
    assert pfa.launch_counts["flash_fwd_wgmma"] == (path == "wgmma")
    assert pfa.launch_counts["flash_bwd_wgmma"] == (path == "wgmma")


@pytest.mark.parametrize("sq, path", [(1, "walk"), (3, "walk"), (16, "mma")])
@pytest.mark.parametrize("quant", [False, True], ids=["fp16", "int8"])
def test_fp16_paged_wrappers_pass_code_2_on_the_bf16_path(fake_card, sq, path,
                                                          quant):
    b, h, hk, d, ps, P = 2, 8, 8, 128, 16, 4
    q = torch.zeros(b, sq, h, d, dtype=F16)
    store = torch.int8 if quant else F16
    ak = torch.zeros(b * P + 1, ps, hk, d, dtype=store)
    tables = torch.arange(1, b * P + 1, dtype=torch.int32).reshape(b, P)
    pos = torch.zeros(b, dtype=torch.int32)
    base = torch.arange(P, dtype=torch.int32) * ps
    sc = torch.ones(b * P + 1, ps, hk, 1)
    if quant:
        pfa.paged_decode_fused_q8(q, ak, ak, sc, sc, tables, pos, 64)
        pfa.paged_decode_partials(q, ak, ak, tables, base, pos, 64, k_scale=sc,
                                  v_scale=sc)
    else:
        pfa.paged_decode_fused(q, ak, ak, tables, pos, 64)
        pfa.paged_decode_partials(q, ak, ak, tables, base, pos, 64)
    code = {"fma": 0, "mma": 1, "walk": 2}[path]
    (k2, a2), (k5, a5) = fake_card.calls
    assert a2[-2] == 2 and a5[-2] == 2  # the dtype code, before the stream
    assert a2[10 if quant else 8] == code and a5[13 if quant else 11] == code
    name = "paged_decode_fused_q8" if quant else "paged_decode_fused"
    assert pfa.launch_counts[f"{name}_{path}"] == 1
    cp_name = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
    assert pfa.launch_counts[f"{cp_name}_{path}"] == 1
