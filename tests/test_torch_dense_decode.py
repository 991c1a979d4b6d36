"""K6 of the port (`dense_decode`, cached attention against a dense static
KV cache) and its dispatcher `decode_attention`, on the CPU, against the
JAX package's `decode_attention_array`: its dense XLA path and its Pallas
kernel `_pallas_decode_forward` in interpret mode.

On CPU tensors the port's wrapper runs the kernel's plain version; float32
inputs from a seeded numpy generator, atol 2e-5 (the reference test's bar:
dense and online softmax re-associate float32 sums).
"""

import numpy as np
import pytest
import torch

from paddle_tpu import profiler as jprofiler
from paddle_tpu.ops import flash_attention as jfa
from paddle_tpu_torch.ops import flash_attention as pfa

ATOL = 2e-5

# tests/test_decode_generation.py's five shapes, then ragged sq >= 64 at
# pos > 0 (with GQA, and a tile whose rows cross the cache's end)
SHAPES = [
    (2, 1, 4, 4, 64, 256, 7),      # single-token decode
    (1, 5, 4, 2, 64, 128, 100),    # GQA, chunked decode
    (2, 130, 8, 8, 64, 384, 0),    # prefill-with-cache, odd length
    (1, 3, 2, 2, 128, 256, 252),   # near the cache end
    (1, 64, 8, 2, 64, 128, 30),    # GQA on the kernel path
    (1, 77, 8, 2, 32, 256, 50),    # ragged sq, pos > 0
    (2, 100, 4, 4, 16, 256, 200),  # rows past the cache end see all of it
]


def _inputs(b, sq, h, hk, d, L, pos, seed=0):
    """q and a cache written up to pos + sq (later rows zero, as a fresh
    StaticKVCache)."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, sq, h, d).astype(np.float32) * 0.5
    k = np.zeros((b, L, hk, d), np.float32)
    v = np.zeros((b, L, hk, d), np.float32)
    live = min(pos + sq, L)
    k[:, :live] = rng.randn(b, live, hk, d) * 0.5
    v[:, :live] = rng.randn(b, live, hk, d) * 0.5
    return q, k, v


def _reference(q, k, v, pos, interpret):
    import jax.numpy as jnp

    saved = jfa._FORCE_INTERPRET
    jfa._FORCE_INTERPRET = interpret
    try:
        return np.asarray(jfa.decode_attention_array(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos)))
    finally:
        jfa._FORCE_INTERPRET = saved


@pytest.mark.parametrize("b,sq,h,hk,d,L,pos", SHAPES)
@pytest.mark.parametrize("interpret", [False, True], ids=["dense", "pallas"])
def test_matches_reference(b, sq, h, hk, d, L, pos, interpret):
    q, k, v = _inputs(b, sq, h, hk, d, L, pos)
    ref = _reference(q, k, v, pos, interpret)
    pos_t = torch.tensor(pos, dtype=torch.int32)
    out = pfa.decode_attention(*map(torch.from_numpy, (q, k, v)), pos_t)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    if pfa.takes_dense_decode(sq, d, L, per_row_pos=False):
        # the kernel's wrapper itself, pos as an int and as a [1] tensor
        for p in (pos, torch.tensor([pos], dtype=torch.int32)):
            got = pfa.dense_decode(*map(torch.from_numpy, (q, k, v)), p)
            np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


def test_per_row_positions_match_reference():
    """The slot pool's per-slot positions: the dense path on both sides."""
    import jax.numpy as jnp

    b, sq, h, hk, d, L = 3, 1, 4, 2, 16, 128
    q, k, v = _inputs(b, sq, h, hk, d, L, 100, seed=1)
    pos = np.array([5, 100, 0], np.int32)
    ref = np.asarray(jfa.decode_attention_array(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos)))
    out = pfa.decode_attention(*map(torch.from_numpy, (q, k, v)),
                               torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


# (sq, d, L, per_row): every condition of the rule on and off its edge
DISPATCH = [
    (64, 64, 128, False), (63, 64, 128, False), (64, 64, 128, True),
    (130, 64, 384, False), (64, 256, 128, False), (64, 264, 128, False),
    (64, 64, 192, False), (500, 128, 640, False), (1, 128, 640, False),
    (200, 32, 256, True), (80, 16, 130, False),
]


@pytest.mark.parametrize("sq,d,L,per_row", DISPATCH)
def test_dispatch_picks_the_kernel_where_the_reference_does(sq, d, L, per_row,
                                                           monkeypatch):
    """`decode_attention` calls `dense_decode` exactly where the reference's
    `decode_attention_array` (interpret mode standing in for the TPU) calls
    its Pallas kernel (flash_attention.py:738-744)."""
    import jax.numpy as jnp

    b, h, hk = 1, 2, 1
    q = np.zeros((b, sq, h, d), np.float32)
    k = np.zeros((b, L, hk, d), np.float32)
    pos = np.zeros(b, np.int32) if per_row else np.int32(0)
    jprofiler.reset_flash_pallas()
    saved = jfa._FORCE_INTERPRET
    jfa._FORCE_INTERPRET = True
    # the reference's kernel itself is not needed to observe its choice
    monkeypatch.setattr(jfa, "_pallas_decode_forward",
                        lambda q_, k_, v_, *a, **kw: q_)
    try:
        jfa.decode_attention_array(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(k), jnp.asarray(pos))
    finally:
        jfa._FORCE_INTERPRET = saved
    reference = jprofiler.flash_pallas_summary().get("decode", 0) == 1

    calls = []
    real = pfa.dense_decode
    monkeypatch.setattr(pfa, "dense_decode",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    pfa.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(k), torch.as_tensor(pos))
    assert bool(calls) == reference
    assert pfa.takes_dense_decode(sq, d, L, per_row) == reference


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    pfa.reset_launch_counts()
    q, k, v = map(torch.from_numpy, _inputs(1, 64, 4, 2, 16, 128, 3))
    out = pfa.dense_decode(q, k, v, 3)
    ref = pfa.decode_attention_plain(q, k, v, 3)
    assert torch.equal(out, ref)
    assert pfa.launch_counts["dense_decode"] == 0


@pytest.mark.parametrize("bad,match", [
    (dict(pos=torch.tensor([1, 2], dtype=torch.int32)), "one int32"),
    (dict(pos=torch.tensor(1, dtype=torch.int64)), "one int32"),
    (dict(k=torch.zeros(2, 128, 2, 16)), "batch"),
    (dict(k=torch.zeros(1, 128, 3, 16)), "kv heads"),
    (dict(q=torch.zeros(1, 64, 4, 16, dtype=torch.bfloat16)), "dtypes"),
])
def test_rejects_what_the_kernel_does_not_take(bad, match):
    args = dict(q=torch.zeros(1, 64, 4, 16), k=torch.zeros(1, 128, 2, 16),
                v=None, pos=torch.tensor(0, dtype=torch.int32))
    args.update(bad)
    if args["v"] is None:
        args["v"] = torch.zeros_like(args["k"])
    with pytest.raises(ValueError, match=match):
        pfa.dense_decode(args["q"], args["k"], args["v"], args["pos"])
