"""The port's flash-attention backward (K3) against the JAX package on the CPU.

The same numpy inputs (made from a seed) go through the reference and the
port.  On the CPU `flash_backward` takes its plain version; the reference
runs its own K3 (`_pallas_flash_backward`) in interpret mode through
`jax.vjp` of `sdpa_array`, and its XLA backward `_flash_backward` directly.

Tolerances: float32 at atol/rtol 1e-5 (the two sides sum in different
orders).  bfloat16 at atol 2e-2 and rtol 2e-2: both sides round p and ds
to bf16 at the same points, but a product that lands near a rounding
boundary may round one bf16 ulp (up to 2^-7 relative) apart, and the
reference sums the GQA group's bf16 dk/dv after rounding each head while
the port sums in float32 and rounds once.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu_torch import profiler
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-5, rtol=1e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Restore paddle_tpu's global generator so later modules see the
    stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


def _inputs(seed, b, s, h, hk, d):
    rng = np.random.default_rng(seed)
    mk = lambda heads: rng.standard_normal((b, s, heads, d)).astype(np.float32)
    return mk(h), mk(hk), mk(hk), mk(h)  # q, k, v, g


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(dtype)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _ref_vjp(q, k, v, g, causal, dtype=jnp.float32):
    """(dq, dk, dv) of the reference's `sdpa_array`, [b, s, h | hk, d]."""
    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    _, vjp = jax.vjp(lambda q, k, v: fa.sdpa_array(q, k, v, causal=causal), *args)
    return vjp(jnp.asarray(g, dtype))


def _port_grads(q, k, v, g, causal, dtype=torch.float32):
    """(dq, dk, dv) of the port's `sdpa` through autograd."""
    q, k, v = (_t(x, dtype).requires_grad_() for x in (q, k, v))
    out = pfa.sdpa(q, k, v, causal=causal)
    return torch.autograd.grad(out, (q, k, v), _t(g, dtype))


# b, s, h, hk, d, causal: s 100 is ragged (the reference pads it to 128)
CASES = [
    (2, 128, 4, 4, 64, True),
    (2, 128, 4, 2, 32, False),
    (2, 100, 4, 2, 64, True),
    (2, 100, 4, 4, 32, False),
]


@pytest.mark.parametrize("b,s,h,hk,d,causal", CASES)
def test_autograd_matches_reference_kernel_interpret(b, s, h, hk, d, causal):
    """The port's grads against `jax.vjp` of `sdpa_array` with the
    reference's Pallas forward and K3 backward run in interpret mode."""
    q, k, v, g = _inputs(s + hk + d, b, s, h, hk, d)
    with _interpret():
        ref = _ref_vjp(q, k, v, g, causal)
    for got, want, name in zip(_port_grads(q, k, v, g, causal), ref, "qkv"):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("b,s,h,hk,d,causal", CASES[1:3])
def test_autograd_matches_reference_xla_path(b, s, h, hk, d, causal):
    """Against `jax.vjp` of `sdpa_array` on the reference's CPU default
    path (blockwise forward, `_flash_backward`)."""
    q, k, v, g = _inputs(7 + s + d, b, s, h, hk, d)
    ref = _ref_vjp(q, k, v, g, causal)
    for got, want, name in zip(_port_grads(q, k, v, g, causal), ref, "qkv"):
        np.testing.assert_allclose(_np(got), _np(want), err_msg=f"d{name}", **TOL)


def _ref_flash_backward(q, k, v, g, causal, dtype):
    """The reference's `_flash_backward` on its own forward's out and lse,
    kv heads repeated as `sdpa_array` does and dk/dv summed back over each
    group in float32.  Returns (out, lse, dq, dk, dv) in [b, s, h, d] /
    [b, h, s] layouts."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    tr = lambda x: jnp.transpose(jnp.asarray(x, dtype), (0, 2, 1, 3))
    qt, kt, vt, gt = tr(q), tr(k), tr(v), tr(g)
    kt, vt = jnp.repeat(kt, rep, axis=1), jnp.repeat(vt, rep, axis=1)
    scale = 1.0 / np.sqrt(d)
    out, lse, _ = fa._flash_fwd_impl(qt, kt, vt, None, None, causal, scale)
    dq, dk, dv = fa._flash_backward(qt, kt, vt, None, out, lse, gt, causal, scale)
    group = lambda x: x.astype(jnp.float32).reshape(b, hk, rep, s, d).sum(2)
    back = lambda x: jnp.transpose(x, (0, 2, 1, 3))
    return back(out), lse, back(dq), back(group(dk)), back(group(dv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,hk,d,causal", CASES)
def test_plain_matches_reference_flash_backward(b, s, h, hk, d, causal, dtype):
    """`flash_backward_plain` against the reference's `_flash_backward`
    (flash_attention.py:1763) on the same out and lse."""
    q, k, v, g = _inputs(3 * s + d, b, s, h, hk, d)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, lse, *ref = _ref_flash_backward(q, k, v, g, causal, jdt)
    got = pfa.flash_backward_plain(
        _t(q, tdt), _t(k, tdt), _t(v, tdt), _t(_np(out), tdt),
        torch.from_numpy(np.array(lse)), _t(g, tdt), causal, 1.0 / np.sqrt(d),
    )
    tol = TOL if dtype == "float32" else BF16_TOL
    for x, want, name in zip(got, ref, "qkv"):
        assert x.dtype == tdt
        np.testing.assert_allclose(_np(x), _np(want), err_msg=f"d{name}", **tol)


def test_bf16_autograd_matches_reference_within_bf16_tolerance():
    b, s, h, hk, d = 2, 100, 4, 2, 64
    q, k, v, g = _inputs(5, b, s, h, hk, d)
    ref = _ref_vjp(q, k, v, g, True, jnp.bfloat16)
    got = _port_grads(q, k, v, g, True, torch.bfloat16)
    for x, want, name in zip(got, ref, "qkv"):
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(x), _np(want), err_msg=f"d{name}", **BF16_TOL)


@pytest.mark.parametrize("hk", [4, 2])
def test_keys_past_the_ragged_edge_get_exactly_zero_grads(hk):
    """Keys that only rows with a zero output gradient see get dk = dv = 0
    exactly: on a causal 128-row sequence whose g is zero past row 100,
    key rows 100.. of dk/dv are 0 and rows ..100 equal the grads of the
    100-row sequence.  This is the reference's pad-and-fence contract
    (pad keys contribute nothing), which the port keeps by masking the
    ragged edge in-kernel."""
    b, s, cut, h, d = 2, 128, 100, 4, 32
    q, k, v, g = _inputs(11, b, s, h, hk, d)
    g[:, cut:] = 0.0
    full = _port_grads(q, k, v, g, True)
    short = _port_grads(q[:, :cut], k[:, :cut], v[:, :cut], g[:, :cut], True)
    for x in full[1:]:
        assert torch.count_nonzero(x[:, cut:]) == 0
    for x, y in zip(full, short):
        np.testing.assert_allclose(x[:, :cut].numpy(), y.numpy(), **TOL)


def test_sdpa_records_the_autograd_function_only_with_grad():
    x = torch.zeros(1, 8, 2, 16, requires_grad=True)
    out = pfa.sdpa(x, x, x, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    with torch.no_grad():
        assert pfa.sdpa(x, x, x, causal=True).grad_fn is None
    assert pfa.sdpa(x.detach(), x.detach(), x.detach()).grad_fn is None


def test_flash_backward_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(1, 8, 2, 16)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="lse"):
        pfa.flash_backward(x, x, x, x, lse.double(), x)
    with pytest.raises(ValueError, match="lse"):
        pfa.flash_backward(x, x, x, x, lse[:, :1], x)
    with pytest.raises(ValueError, match="shaped like q"):
        pfa.flash_backward(x, x, x, x[:, :4], lse, x)
    with pytest.raises(ValueError, match="typed like q"):
        pfa.flash_backward(x, x, x, x, lse, x.bfloat16())


def test_cpu_backward_never_counts_a_kernel_launch():
    pfa.reset_launch_counts()
    _port_grads(*_inputs(1, 1, 8, 2, 2, 16), causal=True)
    assert pfa.launch_counts == {"flash_fwd": 0, "paged_decode_fused": 0,
                                 "paged_decode_fused_q8": 0, "flash_bwd": 0,
                                 "dense_decode": 0, "paged_decode_fused_cp": 0,
                                 "paged_decode_fused_cp_q8": 0,
                                 "flash_fwd_wgmma": 0, "dense_decode_wgmma": 0,
                                 "paged_decode_fused_mma": 0,
                                 "paged_decode_fused_q8_mma": 0,
                                 "paged_decode_fused_cp_mma": 0,
                                 "paged_decode_fused_cp_q8_mma": 0,
                                 "flash_bwd_wgmma": 0,
                                 "flash_fwd_masked": 0, "flash_bwd_masked": 0,
                                 "flash_fwd_offset": 0, "flash_fwd_carry": 0,
                                 "flash_bwd_offset": 0, "flash_bwd_delta": 0,
                                 "paged_decode_fused_walk": 0,
                                 "paged_decode_fused_q8_walk": 0,
                                 "paged_decode_fused_cp_walk": 0,
                                 "paged_decode_fused_cp_q8_walk": 0,
                                 "paged_decode_tp": 0, "paged_decode_tp_q8": 0,
                                 "paged_decode_cp_tp": 0, "paged_decode_cp_tp_q8": 0}
    assert profiler.summary()["kernel_launches"]["flash_bwd"] == 0
