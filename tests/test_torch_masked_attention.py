"""K1 and K3 with segment ids and a per-key bias, and their callers, against
the JAX package on the CPU.

The same numpy inputs (made from a seed) go through the reference and the
port's plain path (CPU tensors take the kernels' plain versions):

- `flash_forward` / `flash_backward` with `segments` and `kbias` against
  the reference's Pallas kernels (`_pallas_flash_forward`,
  `_pallas_flash_backward`) run in interpret mode, at s 128 and 256;
  among the cases a packed row whose own keys lie only in the last key
  tile (every earlier tile fully masked) and a batch row with every key
  masked (its output the mean of V, its p 1 on every key in K3);
- `sdpa` with `segment_ids`, with a key-padding mask, and with a general
  [b, 1, s, s] mask, forward and dq/dk/dv, against `sdpa_array` through
  `jax.vjp`, on the reference's Pallas path (interpret mode, which pads a
  ragged s of 100 to 128 and fences the pad) and on its XLA path;
- `flash_attn_varlen` against `flash_attn_varlen_array`.

Tolerance: float32 at atol/rtol 1e-5 (the two sides sum in different
orders).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Restore paddle_tpu's global generator so later modules see the
    stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@contextlib.contextmanager
def _interpret(on=True):
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = on
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


def _qkvg(seed, b, s, h, hk, d):
    rng = np.random.default_rng(seed)
    mk = lambda heads: rng.standard_normal((b, s, heads, d)).astype(np.float32)
    return mk(h), mk(hk), mk(hk), mk(h)


def _masking(kind, b, s, seed):
    """(segments [b, s] int32 or None, kbias [b, s] float32 or None):
    "pad" BERT's ids (valid 0, pad j -> j + 1); "kbias" a padding bias
    (-1e30 on pad keys, N(0, 1) on valid ones) with batch row 0 masked on
    every key; "both" the ids and a finite bias; "packed" three sequences
    per row, the last starting 20 keys before the end (its rows find their
    own keys only in the last 128-key tile)."""
    rng = np.random.default_rng(seed)
    j = np.arange(s)[None, :]
    lens = rng.integers(s // 2, s, b)
    valid = j < lens[:, None]
    segs = bias = None
    if kind in ("pad", "both"):
        segs = np.where(valid, 0, j + 1)
    if kind in ("kbias", "both"):
        bias = rng.standard_normal((b, s))
        if kind == "kbias":
            bias = np.where(valid, bias, -1e30)
            bias[0] = -1e30
    if kind == "packed":
        segs = np.broadcast_to((j >= s // 3).astype(np.int64) + (j >= s - 20), (b, s))
    return (None if segs is None else np.ascontiguousarray(segs, np.int32),
            None if bias is None else bias.astype(np.float32))


def _t(x):
    return None if x is None else torch.from_numpy(np.ascontiguousarray(x))


def _bh(x):
    """[b, s, h, d] -> the reference kernels' [b * h, s, d]."""
    b, s, h, d = x.shape
    return jnp.asarray(np.transpose(x, (0, 2, 1, 3)).reshape(b * h, s, d))


def _bshd(x, b, h):
    """[b * h, s, d] -> [b, s, h, d]."""
    x = np.asarray(x)
    return np.transpose(x.reshape(b, h, *x.shape[1:]), (0, 2, 1, 3))


# b, s, h, d, causal, kind
KERNEL_CASES = [
    (2, 128, 2, 32, False, "pad"),
    (2, 128, 2, 32, False, "kbias"),
    (2, 256, 2, 16, False, "both"),
    (2, 256, 2, 16, True, "packed"),
    (1, 256, 2, 16, False, "packed"),
    (2, 128, 2, 32, True, "both"),
]


@pytest.mark.parametrize("b,s,h,d,causal,kind", KERNEL_CASES)
def test_k1_k3_match_reference_kernels_interpret(b, s, h, d, causal, kind):
    q, k, v, g = _qkvg(s + d, b, s, h, h, d)
    segs, bias = _masking(kind, b, s, d)
    scale = 1.0 / np.sqrt(d)
    kw = dict(segments=None if segs is None else jnp.asarray(segs)[:, :, None],
              kbias=None if bias is None else jnp.asarray(bias)[:, :, None],
              n_heads=h, interpret=True)
    out, lse = fa._pallas_flash_forward(_bh(q), _bh(k), _bh(v), causal, scale, **kw)
    dq, dk, dv = fa._pallas_flash_backward(_bh(q), _bh(k), _bh(v), _bh(g), out, lse,
                                           causal, scale, **kw)
    tq, tk, tv, tg = map(_t, (q, k, v, g))
    got_out, got_lse = pfa.flash_forward(tq, tk, tv, causal, scale, _t(segs), _t(bias))
    np.testing.assert_allclose(got_out.numpy(), _bshd(out, b, h), **TOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse).reshape(b, h, s), **TOL)
    # K3 from the reference's own out and lse, so each side recomputes p
    # from the same statistics
    ref_out = torch.from_numpy(_bshd(out, b, h).copy())
    ref_lse = torch.from_numpy(np.asarray(lse).reshape(b, h, s).copy())
    got = pfa.flash_backward(tq, tk, tv, ref_out, ref_lse, tg, causal, scale,
                             _t(segs), _t(bias))
    for x, want, name in zip(got, (dq, dk, dv), "qkv"):
        np.testing.assert_allclose(x.numpy(), _bshd(want, b, h), err_msg=f"d{name}",
                                   **TOL)
    if kind == "kbias":  # batch row 0 has no live key: the mean of V
        np.testing.assert_allclose(got_out[0].numpy(),
                                   np.broadcast_to(v[0].mean(0), (s, h, d)), **TOL)
        assert np.all(got_lse[0].numpy() == -1e30)
    if kind == "packed":  # the last sequence's rows: own keys in the last tile
        last = s - 20
        want = pfa.flash_forward(tq[:, last:], tk[:, last:], tv[:, last:], causal,
                                 scale)[0]
        np.testing.assert_allclose(got_out[:, last:].numpy(), want.numpy(), **TOL)


def _sdpa_ref(q, k, v, g, mask, causal, segs):
    """(out, dq, dk, dv) of the reference's `sdpa_array`."""
    m = None if mask is None else jnp.asarray(mask)
    sg = None if segs is None else jnp.asarray(segs)
    f = lambda q, k, v: fa.sdpa_array(q, k, v, m, causal, segment_ids=sg)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return (out, *vjp(jnp.asarray(g)))


def _sdpa_port(q, k, v, g, mask, causal, segs):
    q, k, v = (_t(x).requires_grad_() for x in (q, k, v))
    out = pfa.sdpa(q, k, v, _t(mask), causal, segment_ids=_t(segs))
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), _t(g)))


def _mask(kind, b, s, seed):
    """An additive mask: "key_padding" [b, 1, 1, s] (0 or -1e30 per key),
    "key_padding_1" the same shared by the batch ([1, 1, 1, s]), "general"
    [b, 1, s, s] (a random pattern of 0 and -1e30, the diagonal kept)."""
    rng = np.random.default_rng(seed)
    if kind.startswith("key_padding"):
        rows = 1 if kind.endswith("_1") else b
        lens = rng.integers(s // 2, s, rows)
        return np.where(np.arange(s)[None, :] < lens[:, None], 0.0,
                        -1e30).astype(np.float32).reshape(rows, 1, 1, s)
    keep = (rng.random((b, 1, s, s)) < 0.6) | np.eye(s, dtype=bool)
    return np.where(keep, 0.0, -1e30).astype(np.float32)


# b, s, h, hk, d, causal, what: s 100 is ragged; hk < h is GQA
SDPA_CASES = [
    (2, 128, 4, 2, 32, False, "segments"),
    (2, 100, 4, 4, 32, False, "segments"),
    (2, 100, 4, 2, 16, True, "segments"),
    (2, 128, 4, 4, 32, False, "key_padding"),
    (2, 100, 4, 2, 16, False, "key_padding_1"),
    (2, 64, 4, 2, 16, False, "general"),
    (2, 64, 4, 4, 16, True, "general"),
]


@pytest.mark.parametrize("interpret", [True, False], ids=["pallas", "xla"])
@pytest.mark.parametrize("b,s,h,hk,d,causal,what", SDPA_CASES)
def test_sdpa_with_masks_matches_sdpa_array(b, s, h, hk, d, causal, what, interpret):
    q, k, v, g = _qkvg(s + h + d, b, s, h, hk, d)
    segs = _masking("pad", b, s, d)[0] if what == "segments" else None
    mask = None if what == "segments" else _mask(what, b, s, d)
    with _interpret(interpret):
        ref = _sdpa_ref(q, k, v, g, mask, causal, segs)
    pfa.reset_launch_counts()
    got = _sdpa_port(q, k, v, g, mask, causal, segs)
    for x, want, name in zip(got, ref, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), err_msg=name, **TOL)
    fallbacks = dict.fromkeys(pfa.FALLBACK_REASONS, 0)
    if what == "general":  # the reference's XLA path, as plain torch ops
        fallbacks["attn_mask not key-padding"] = 1
    assert pfa.fallback_counts == fallbacks


def test_sdpa_cross_attention_takes_the_plain_path():
    """q and k of different lengths: the reference's "q/k shapes differ"
    fallback, with a key-padding mask over the keys."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 24, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 4, 16)).astype(np.float32) for _ in "kv")
    g = rng.standard_normal(q.shape).astype(np.float32)
    mask = _mask("key_padding", 2, 40, 1)
    ref = _sdpa_ref(q, k, v, g, mask, False, None)
    pfa.reset_launch_counts()
    got = _sdpa_port(q, k, v, g, mask, False, None)
    for x, want, name in zip(got, ref, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(x.numpy(), np.asarray(want), err_msg=name, **TOL)
    assert pfa.fallback_counts["q/k shapes differ"] == 1


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attn_varlen_matches_reference(causal):
    rng = np.random.default_rng(11)
    total, h, d = 150, 4, 16
    q, k, v = (rng.standard_normal((total, h, d)).astype(np.float32) for _ in "qkv")
    cu = np.array([0, 40, 41, 117, 150], np.int32)
    ref = fa.flash_attn_varlen_array(*(jnp.asarray(x) for x in (q, k, v)),
                                     jnp.asarray(cu), causal)
    got = pfa.flash_attn_varlen(_t(q), _t(k), _t(v), _t(cu), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # each sequence alone gives the same rows
    one = pfa.sdpa(_t(q[41:117])[None], _t(k[41:117])[None], _t(v[41:117])[None],
                   causal=causal)[0]
    np.testing.assert_allclose(got[41:117].numpy(), one.numpy(), **TOL)
    np.testing.assert_array_equal(
        pfa.cu_seqlens_to_segment_ids(_t(cu), total).numpy(),
        np.asarray(fa.cu_seqlens_to_segment_ids(jnp.asarray(cu), total)))


def test_flash_attn_varlen_refuses_distinct_cu_seqlens_k():
    x = torch.zeros(10, 2, 8)
    cu = torch.tensor([0, 4, 10], dtype=torch.int32)
    pfa.flash_attn_varlen(x, x, x, cu, cu.clone())  # equal values: fine
    with pytest.raises(NotImplementedError, match="cu_seqlens_k"):
        pfa.flash_attn_varlen(x, x, x, cu, torch.tensor([0, 5, 10], dtype=torch.int32))


def test_key_padding_bias_lowers_only_key_padding_masks():
    m = torch.zeros(3, 1, 1, 7)
    m[1, 0, 0, 5:] = -1e30
    kb = pfa.key_padding_bias(m, 3, 7)
    assert kb.shape == (3, 7) and kb.dtype == torch.float32
    assert torch.equal(kb[1], m[1, 0, 0])
    assert pfa.key_padding_bias(m[:1], 3, 7).shape == (3, 7)  # broadcast batch
    for other in (torch.zeros(3, 1, 7, 7), torch.zeros(3, 2, 1, 7),
                  torch.zeros(2, 1, 1, 7), torch.zeros(3, 1, 1, 6), None):
        assert pfa.key_padding_bias(other, 3, 7) is None


def test_masking_operands_are_checked():
    x = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="segments"):
        pfa.flash_forward(x, x, x, segments=torch.zeros(2, 8, dtype=torch.int64))
    with pytest.raises(ValueError, match="kbias"):
        pfa.flash_forward(x, x, x, kbias=torch.zeros(2, 7))
