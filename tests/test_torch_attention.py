"""The port's attention functions against the JAX package on the CPU.

The same numpy inputs (made from a seed) go through the reference function
and its port.  On the CPU the port's kernel wrappers take their plain
PyTorch versions; the reference runs its CPU default path and, where it
reaches a Pallas kernel, that kernel in interpret mode.  Tolerance: atol and
rtol 1e-5 in float32 -- the two sides sum in different orders.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.flash_attention as fa
from paddle_tpu_torch.inference.paging import check_table_bounds
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-5, rtol=1e-5)


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# K1: flash forward (sdpa)
# ---------------------------------------------------------------------------


def _jax_flash(q, k, v, causal, interpret):
    """Reference (out [b, s, h, d], lse [b, h, s]) through `_flash_fwd_impl`,
    kv heads repeated as `sdpa_array` does."""
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (jnp.transpose(jnp.asarray(x), (0, 2, 1, 3)) for x in (q, k, v))
    kt, vt = jnp.repeat(kt, rep, axis=1), jnp.repeat(vt, rep, axis=1)
    scale = 1.0 / np.sqrt(q.shape[-1])
    ctx = _interpret() if interpret else contextlib.nullcontext()
    with ctx:
        out, lse, used = fa._flash_fwd_impl(qt, kt, vt, None, None, causal, scale)
    assert used == interpret
    return np.asarray(jnp.transpose(out, (0, 2, 1, 3))), np.asarray(lse)


@pytest.mark.parametrize(
    "b,s,h,hk,causal,interpret",
    [
        (2, 16, 4, 4, True, False),
        (1, 37, 4, 2, True, False),    # ragged seq, GQA
        (2, 24, 4, 1, False, False),   # non-causal, MQA
        (1, 21, 4, 2, True, True),     # Pallas kernel (interpret), ragged + GQA
    ],
)
def test_flash_forward_matches_reference(b, s, h, hk, causal, interpret):
    rng = np.random.default_rng(s * 10 + h + hk)
    d = 16
    q, k, v = _randn(rng, b, s, h, d), _randn(rng, b, s, hk, d), _randn(rng, b, s, hk, d)
    ref_out, ref_lse = _jax_flash(q, k, v, causal, interpret)
    out, lse = pfa.flash_forward(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), ref_lse, **TOL)


def test_sdpa_matches_reference_sdpa_array():
    rng = np.random.default_rng(3)
    q, k, v = _randn(rng, 2, 19, 4, 16), _randn(rng, 2, 19, 2, 16), _randn(rng, 2, 19, 2, 16)
    ref = np.asarray(fa.sdpa_array(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True))
    np.testing.assert_allclose(pfa.sdpa(_t(q), _t(k), _t(v), causal=True).numpy(),
                               ref, **TOL)


@pytest.mark.parametrize(
    "kwargs,match",
    [
        (dict(d=272), "head_dim"),
        (dict(hk=3), "multiple"),
        (dict(sk=9), "share"),
    ],
)
def test_flash_forward_rejects_what_the_kernel_does_not_take(kwargs, match):
    d, hk, sk = kwargs.get("d", 16), kwargs.get("hk", 2), kwargs.get("sk", 8)
    q = torch.zeros(1, 8, 4, d)
    k = torch.zeros(1, sk, hk, d)
    with pytest.raises(ValueError, match=match):
        pfa.flash_forward(q, k, k.clone())


def test_flash_forward_rejects_integer_dtype():
    x = torch.zeros(1, 8, 2, 16, dtype=torch.int32)
    with pytest.raises(TypeError, match="dtype"):
        pfa.flash_forward(x, x, x)


def test_cpu_tensors_never_count_a_kernel_launch():
    pfa.reset_launch_counts()
    x = torch.zeros(1, 8, 2, 16)
    pfa.flash_forward(x, x, x)
    assert pfa.launch_counts == {"flash_fwd": 0, "paged_decode_fused": 0}


# ---------------------------------------------------------------------------
# K2: paged decode
# ---------------------------------------------------------------------------


def _paged_case(rng, b, sq, h, hk, d=16, ps=8, P=6, max_len=44):
    """Arena, shuffled page tables (page 0 scratch, unique pages per slot)
    and mixed positions, the last slot near max_len."""
    pages = 1 + b * P
    ak, av = _randn(rng, pages, ps, hk, d), _randn(rng, pages, ps, hk, d)
    perm = rng.permutation(np.arange(1, pages)).astype(np.int32)
    tables = perm.reshape(b, P)
    pos = rng.integers(0, max_len - sq, size=b).astype(np.int32)
    pos[0], pos[-1] = 0, max_len - sq
    q = _randn(rng, b, sq, h, d)
    check_table_bounds(tables, pages)
    return q, ak, av, tables, pos, max_len


PAGED_CASES = [
    (3, 1, 4, 4),   # plain decode
    (3, 1, 4, 2),   # GQA rep 2
    (2, 4, 4, 2),   # verify / chunk window sq > 1 with GQA
    (2, 3, 4, 1),   # MQA, sq 3
]


@pytest.mark.parametrize("b,sq,h,hk", PAGED_CASES)
def test_paged_decode_matches_reference_gather(b, sq, h, hk):
    rng = np.random.default_rng(b * 100 + sq * 10 + hk)
    q, ak, av, tables, pos, max_len = _paged_case(rng, b, sq, h, hk)
    ref = np.asarray(fa.paged_decode_attention_array(
        jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av), jnp.asarray(tables),
        jnp.asarray(pos), max_len, kernel="gather",
    ))
    args = (_t(q), _t(ak), _t(av), _t(tables), _t(pos), max_len)
    fused = pfa.paged_decode_fused(*args)
    gather = pfa.paged_decode_attention(*args, kernel="gather")
    np.testing.assert_allclose(fused.numpy(), ref, **TOL)
    np.testing.assert_allclose(gather.numpy(), ref, **TOL)


@pytest.mark.parametrize("b,sq,h,hk", PAGED_CASES[1:3])
def test_paged_decode_matches_reference_fused_kernel(b, sq, h, hk):
    rng = np.random.default_rng(7 + sq + hk)
    q, ak, av, tables, pos, max_len = _paged_case(rng, b, sq, h, hk)
    with _interpret():
        ref = np.asarray(fa.paged_decode_attention_array(
            jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av),
            jnp.asarray(tables), jnp.asarray(pos), max_len, kernel="fused",
        ))
    out = pfa.paged_decode_attention(_t(q), _t(ak), _t(av), _t(tables), _t(pos),
                                     max_len, kernel="fused")
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_paged_gather_and_dense_decode_match_reference():
    rng = np.random.default_rng(11)
    q, ak, av, tables, pos, max_len = _paged_case(rng, 3, 2, 4, 2)
    ref_k = np.asarray(fa.paged_gather_kv(jnp.asarray(ak), jnp.asarray(tables), max_len))
    k = pfa.paged_gather_kv(_t(ak), _t(tables), max_len)
    np.testing.assert_array_equal(k.numpy(), ref_k)
    v = pfa.paged_gather_kv(_t(av), _t(tables), max_len)
    ref = np.asarray(fa.decode_attention_array(
        jnp.asarray(q), jnp.asarray(ref_k), jnp.asarray(v.numpy()), jnp.asarray(pos)))
    out = pfa.decode_attention(_t(q), k, v, _t(pos))
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_paged_decode_rejects_bad_inputs():
    rng = np.random.default_rng(5)
    q, ak, av, tables, pos, max_len = _paged_case(rng, 2, 1, 4, 2)
    with pytest.raises(ValueError, match="int32"):
        pfa.paged_decode_fused(_t(q), _t(ak), _t(av), _t(tables).long(), _t(pos), max_len)
    with pytest.raises(ValueError, match="auto|fused|gather"):
        pfa.paged_decode_attention(_t(q), _t(ak), _t(av), _t(tables), _t(pos),
                                   max_len, kernel="dense")
    big_q = torch.zeros(2, 40, 4, 16)  # rep 2 x sq 40 rows > one block
    with pytest.raises(ValueError, match="rows"):
        pfa.paged_decode_fused(big_q, _t(ak), _t(av), _t(tables), _t(pos), max_len)
    with pytest.raises(ValueError, match="bounds"):
        check_table_bounds(tables + ak.shape[0], ak.shape[0])
