"""Dense-cache attention through K2's page walk, on the CPU, against the JAX
package's `decode_attention_array` (its dense XLA math).

Outside K6's shapes (`takes_dense_decode`: a scalar position, 64+ query
rows, head_dim <= 256, L % 128 == 0), the port's `decode_attention` runs
`paged_decode_fused` over a page view of the same cache buffers: a
contiguous `[b, L, kv_h, d]` cache is the arena `[b * L / ps, ps, kv_h, d]`
under the table t[s, j] = s * L / ps + j, with ps = 128 where L is a
multiple of 128, else one page of L rows.  On CPU tensors the wrapper runs
its plain version (`paged_decode_plain`), so these tests hold the view, the
table and the masking against the reference; float32 inputs from a seeded
numpy generator, atol 1e-5.
"""

import numpy as np
import pytest
import torch

from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.models.llama import StaticKVCache
from paddle_tpu_torch.ops import flash_attention as pfa

ATOL = 1e-5
B, H, HK, D = 3, 4, 2, 16


def _inputs(sq, L, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, sq, H, D).astype(np.float32) * 0.5
    k = rng.randn(B, L, HK, D).astype(np.float32) * 0.5
    v = rng.randn(B, L, HK, D).astype(np.float32) * 0.5
    return q, k, v


def _positions(sq, L, per_row, seed):
    """Scalar: a position whose window ends inside the cache; per row: the
    first row at 0, the last row's window ending at the cache's end, one
    between."""
    if not per_row:
        return np.int32(max(0, (L - sq) * 2 // 3))
    mid = np.random.RandomState(seed).randint(0, L - sq + 1)
    return np.array([0, mid, L - sq], np.int32)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
@pytest.mark.parametrize("L", [128, 640, 2048, 200])
@pytest.mark.parametrize("sq", [1, 7, 63])
def test_page_view_route_matches_reference(sq, L, per_row, monkeypatch):
    import jax.numpy as jnp

    q, k, v = _inputs(sq, L, seed=sq + L)
    pos = _positions(sq, L, per_row, seed=L)
    ref = np.asarray(jfa.decode_attention_array(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))

    calls = []
    real = pfa.paged_decode_fused
    monkeypatch.setattr(pfa, "paged_decode_fused",
                        lambda *a, **kw: calls.append(a) or real(*a, **kw))
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    out = pfa.decode_attention(torch.from_numpy(q), kt, vt, torch.as_tensor(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)

    # one K2 call over a view of the same memory, under the dense table
    assert not pfa.takes_dense_decode(sq, D, L, per_row)
    assert len(calls) == 1
    _, ak, av, table, _, max_len = calls[0][:6]
    ps = 128 if L % 128 == 0 else L
    assert tuple(ak.shape) == (B * L // ps, ps, HK, D) and max_len == L
    assert ak.data_ptr() == kt.data_ptr() and av.data_ptr() == vt.data_ptr()
    torch.testing.assert_close(table, pfa.dense_page_table(B, L, "cpu"))


@pytest.mark.parametrize("L,ps", [(128, 128), (640, 128), (2048, 128), (200, 200),
                                  (64, 64)])
def test_dense_page_table_values(L, ps):
    t = pfa.dense_page_table(B, L, "cpu")
    n = L // ps
    assert pfa.dense_page_size(L) == ps
    assert t.dtype == torch.int32 and tuple(t.shape) == (B, n)
    np.testing.assert_array_equal(t.numpy(), np.arange(B * n).reshape(B, n))
    # page t[s, j] of the view holds rows j * ps ... of sequence s
    k = torch.arange(B * L * HK * D, dtype=torch.float32).reshape(B, L, HK, D)
    arena = pfa.dense_page_view(k)
    gathered = pfa.paged_gather_kv(arena, t, L)
    assert torch.equal(gathered, k)


def test_static_cache_builds_its_table_once():
    c = StaticKVCache(2, 640, HK, D)
    torch.testing.assert_close(c.table, pfa.dense_page_table(2, 640, "cpu"))
    assert c.table.device == c.k.device


@pytest.mark.parametrize("sq,L", [(64, 128), (70, 640), (500, 640), (130, 2048)])
def test_k6_shapes_still_reach_dense_decode(sq, L, monkeypatch):
    """`takes_dense_decode`'s dispatch is unchanged: its shapes run K6 and
    never K2."""
    import jax.numpy as jnp

    q, k, v = _inputs(sq, L, seed=sq)
    pos = np.int32(L - sq)
    seen = []
    real_k6, real_k2 = pfa.dense_decode, pfa.paged_decode_fused
    monkeypatch.setattr(pfa, "dense_decode",
                        lambda *a, **kw: seen.append("k6") or real_k6(*a, **kw))
    monkeypatch.setattr(pfa, "paged_decode_fused",
                        lambda *a, **kw: seen.append("k2") or real_k2(*a, **kw))
    out = pfa.decode_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.tensor(pos))
    assert seen == ["k6"]
    ref = np.asarray(jfa.decode_attention_array(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)  # K6's own bar
