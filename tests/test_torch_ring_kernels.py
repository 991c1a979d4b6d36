"""K1's and K3's ring operands against the JAX package's kernels on the CPU.

The same numpy inputs (made from a seed) go through the reference's Pallas
kernels in interpret mode (`_pallas_flash_forward`,
`_pallas_flash_backward`) and the port's wrappers, whose CPU tensors take
the kernels' plain versions:

- K1 with `q_offset` over rectangular keys (a zig-zag rank's two chunks
  against the whole sequence, causal), with `carry` (a hop merged onto a
  partial result) and with `out_dtype=float32`;
- K3 with `q_offset` over rectangular keys and with a precomputed `delta`
  (then `out` is not read);
- `q_block_starts` and the rows' absolute positions.

Layouts: the reference takes [b*h, s, d] and an lse [b*h, s, 1], the port
[b, s, h, d] and [b, h, s].  Tolerance: float32 at atol/rtol 1e-5 (the two
sides sum in different orders).
"""

import contextlib

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


@pytest.fixture(autouse=True)
def _counts():
    pfa.reset_launch_counts()
    yield
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)  # CPU


def _rand(rng, b, s, h, d):
    return rng.standard_normal((b, s, h, d)).astype(np.float32)


def _bh(x):
    """[b, s, h, d] numpy -> the reference's [b*h, s, d]."""
    b, s, h, d = x.shape
    return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, s, d))


def _from_bh(x, b, h):
    """The reference's [b*h, s, d] -> [b, s, h, d] numpy."""
    x = np.asarray(x)
    return x.reshape(b, h, x.shape[1], x.shape[2]).transpose(0, 2, 1, 3)


def _lse_bh(lse, b, h):
    """The reference's [b*h, s, 1] lse -> [b, h, s]."""
    return np.asarray(lse)[..., 0].reshape(b, h, -1)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32))


# the zig-zag layout of S = 512 over R = 2 ranks (c = 128): rank 0 holds
# chunks 0 and 3, rank 1 chunks 1 and 2; and S = 1024 over R = 2 (c = 256,
# blocks of 256 rows)
OFFSET_CASES = [
    # (S, c, chunks of the q shard)
    (512, 128, (0, 3)),
    (512, 128, (1, 2)),
    (1024, 256, (1, 2)),
]


def _offset_inputs(S, c, chunks, seed, b=1, h=2, d=16):
    rng = np.random.default_rng(seed)
    q = _rand(rng, b, 2 * c, h, d)
    k, v = _rand(rng, b, S, h, d), _rand(rng, b, S, h, d)
    g = _rand(rng, b, 2 * c, h, d)
    spans = [(ch * c, c) for ch in chunks]
    return q, k, v, g, spans


def test_q_block_starts_match_the_reference():
    spans = [(256, 256), (1536, 256)]
    ref = np.asarray(fa.q_block_starts(spans, 128))
    got = pfa.q_block_starts(spans, 128, "cpu")
    assert got.dtype == torch.int32 and got.tolist() == ref.tolist()
    pos = pfa.q_positions(512, got, "cpu")
    want = np.concatenate([np.arange(256, 512), np.arange(1536, 1792)])
    np.testing.assert_array_equal(pos.numpy(), want)
    np.testing.assert_array_equal(pfa.q_positions(5, None, "cpu").numpy(), np.arange(5))


@pytest.mark.parametrize("S, c, chunks", OFFSET_CASES)
def test_forward_with_q_offset_matches_reference(S, c, chunks):
    q, k, v, _, spans = _offset_inputs(S, c, chunks, seed=S + chunks[0])
    bq = c  # the reference's _pick_block(c, 1024) at these sizes
    scale = 0.25
    ro, rl = fa._pallas_flash_forward(
        _bh(q), _bh(k), _bh(v), True, scale, interpret=True,
        q_offset=fa.q_block_starts(spans, bq), block_q=bq)
    starts = pfa.q_block_starts(spans, bq, "cpu")
    out, lse = pfa.flash_forward(_t(q), _t(k), _t(v), True, scale, q_offset=starts)
    np.testing.assert_allclose(out.numpy(), _from_bh(ro, 1, 2), **TOL)
    np.testing.assert_allclose(lse.numpy(), _lse_bh(rl, 1, 2), **TOL)


def test_forward_carry_and_float32_out_match_reference():
    """A first hop (causal, float32 out, no carry), then a full hop merged
    onto it, as the Pallas-hop ring chains them."""
    rng = np.random.default_rng(5)
    b, s, h, d = 2, 128, 2, 16
    q, k0, v0, k1, v1 = (_rand(rng, b, s, h, d) for _ in range(5))
    scale = 0.3
    r0 = fa._pallas_flash_forward(_bh(q), _bh(k0), _bh(v0), True, scale,
                                  interpret=True, out_dtype=jnp.float32)
    r1 = fa._pallas_flash_forward(_bh(q), _bh(k1), _bh(v1), False, scale,
                                  interpret=True, carry=r0, out_dtype=jnp.float32)
    f32 = torch.float32
    p0 = pfa.flash_forward(_t(q), _t(k0), _t(v0), True, scale, out_dtype=f32)
    p1 = pfa.flash_forward(_t(q), _t(k1), _t(v1), False, scale, carry=p0,
                           out_dtype=f32)
    for (ro, rl), (po, pl) in ((r0, p0), (r1, p1)):
        assert po.dtype == f32
        np.testing.assert_allclose(po.numpy(), _from_bh(ro, b, h), **TOL)
        np.testing.assert_allclose(pl.numpy(), _lse_bh(rl, b, h), **TOL)


def test_forward_carry_with_a_causal_hop_and_gqa():
    """The zig-zag form's third launch: a causal diagonal merged onto the
    carry of a full one; GQA kv heads (the kernels read them in place)."""
    rng = np.random.default_rng(6)
    b, s, h, hk, d = 1, 128, 4, 2, 16
    q = _rand(rng, b, s, h, d)
    k0, v0, k1, v1 = (_rand(rng, b, s, hk, d) for _ in range(4))
    rep = lambda x: np.repeat(x, h // hk, axis=2)  # the reference wants h heads
    r0 = fa._pallas_flash_forward(_bh(q), _bh(rep(k0)), _bh(rep(v0)), False, 0.25,
                                  interpret=True, out_dtype=jnp.float32)
    r1 = fa._pallas_flash_forward(_bh(q), _bh(rep(k1)), _bh(rep(v1)), True, 0.25,
                                  interpret=True, carry=r0, out_dtype=jnp.float32)
    p0 = pfa.flash_forward(_t(q), _t(k0), _t(v0), False, 0.25, out_dtype=torch.float32)
    po, pl = pfa.flash_forward(_t(q), _t(k1), _t(v1), True, 0.25, carry=p0,
                               out_dtype=torch.float32)
    np.testing.assert_allclose(po.numpy(), _from_bh(r1[0], b, h), **TOL)
    np.testing.assert_allclose(pl.numpy(), _lse_bh(r1[1], b, h), **TOL)


@pytest.mark.parametrize("S, c, chunks", OFFSET_CASES[:2])
def test_backward_with_q_offset_matches_reference(S, c, chunks):
    q, k, v, g, spans = _offset_inputs(S, c, chunks, seed=7 + chunks[0])
    scale = 0.25
    ref_starts = fa.q_block_starts(spans, c)
    ro, rl = fa._pallas_flash_forward(_bh(q), _bh(k), _bh(v), True, scale,
                                      interpret=True, q_offset=ref_starts, block_q=c)
    rdq, rdk, rdv = fa._pallas_flash_backward(
        _bh(q), _bh(k), _bh(v), _bh(g), ro, rl, True, scale, interpret=True,
        q_offset=ref_starts, block_q=c)
    starts = pfa.q_block_starts(spans, c, "cpu")
    out, lse = pfa.flash_forward(_t(q), _t(k), _t(v), True, scale, q_offset=starts)
    dq, dk, dv = pfa.flash_backward(_t(q), _t(k), _t(v), out, lse, _t(g), True,
                                    scale, q_offset=starts)
    assert dk.shape == (1, S, 2, 16)  # rectangular: dk/dv at the keys' rows
    for got, ref in ((dq, rdq), (dk, rdk), (dv, rdv)):
        np.testing.assert_allclose(got.numpy(), _from_bh(ref, 1, 2), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_with_delta_matches_reference(causal):
    """A hop's K3 with the final (out, lse) of a two-hop merge and the
    delta computed once from it; the port is given no `out`."""
    rng = np.random.default_rng(8)
    b, s, h, d = 1, 256, 2, 16
    q, k0, v0, k1, v1, g = (_rand(rng, b, s, h, d) for _ in range(6))
    scale = 0.25
    r0 = fa._pallas_flash_forward(_bh(q), _bh(k0), _bh(v0), True, scale,
                                  interpret=True, out_dtype=jnp.float32)
    ro, rl = fa._pallas_flash_forward(_bh(q), _bh(k1), _bh(v1), False, scale,
                                      interpret=True, carry=r0,
                                      out_dtype=jnp.float32)
    rdelta = jnp.sum(_bh(g) * ro, -1, keepdims=True)
    kk, vv = (k0, v0) if causal else (k1, v1)
    ref = fa._pallas_flash_backward(_bh(q), _bh(kk), _bh(vv), _bh(g), ro, rl,
                                    causal, scale, interpret=True, delta=rdelta)
    p0 = pfa.flash_forward(_t(q), _t(k0), _t(v0), True, scale, out_dtype=torch.float32)
    out, lse = pfa.flash_forward(_t(q), _t(k1), _t(v1), False, scale, carry=p0,
                                 out_dtype=torch.float32)
    delta = (_t(g) * out).sum(-1).transpose(1, 2).contiguous()
    np.testing.assert_allclose(delta.numpy(), np.asarray(rdelta)[..., 0].reshape(b, h, s),
                               **TOL)
    got = pfa.flash_backward(_t(q), _t(kk), _t(vv), None, lse, _t(g), causal,
                             scale, delta=delta)
    for x, r in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), _from_bh(r, b, h), **TOL)


def test_plain_causal_is_top_left_without_offsets_and_bottom_right_on_the_xla_path():
    """K1's plain version follows the reference's kernels: without q_offset
    row i sits at position i (top-left); `attention_plain`, the reference's
    XLA path, aligns the last row with the last key (bottom-right)."""
    rng = np.random.default_rng(9)
    q, k = _rand(rng, 1, 128, 1, 16), _rand(rng, 1, 256, 1, 16)
    ro, _ = fa._pallas_flash_forward(_bh(q), _bh(k), _bh(k), True, 0.25,
                                     interpret=True)
    out, _ = pfa.flash_forward(_t(q), _t(k), _t(k), True, 0.25)
    np.testing.assert_allclose(out.numpy(), _from_bh(ro, 1, 1), **TOL)
    ref_xla = fa.sdpa_array(jnp.asarray(q), jnp.asarray(k), jnp.asarray(k), None,
                            True, 0.25)
    np.testing.assert_allclose(pfa.attention_plain(_t(q), _t(k), _t(k), None, True,
                                                   0.25).numpy(),
                               np.asarray(ref_xla), **TOL)


def test_ring_operands_are_checked():
    x = torch.zeros(1, 256, 2, 16)
    with pytest.raises(ValueError, match="q_offset"):
        pfa.flash_forward(x, x, x, q_offset=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="q_offset"):  # blocks of 64 rows
        pfa.flash_forward(x, x, x, q_offset=torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="carry"):
        pfa.flash_forward(x, x, x, carry=(x, torch.zeros(1, 2, 255)))
    with pytest.raises(ValueError, match="out_dtype"):
        pfa.flash_forward(x, x, x, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="do not combine"):
        pfa.flash_forward(x, x, x, segments=torch.zeros(1, 256, dtype=torch.int32),
                          out_dtype=torch.float32)
    with pytest.raises(ValueError, match="out is needed"):
        pfa.flash_backward(x, x, x, None, torch.zeros(1, 2, 256), x)
    with pytest.raises(ValueError, match="delta"):
        pfa.flash_backward(x, x, x, None, torch.zeros(1, 2, 256), x,
                           delta=torch.zeros(1, 2, 255))
