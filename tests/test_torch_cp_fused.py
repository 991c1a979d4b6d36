"""K5 on one card: `paged_decode_cp` walks every cp shard in one launch.
On the CPU, in one process, well under a minute.

- Through the `fake_card` fixture of tests/test_torch_kernel_paths.py (a
  recorder in place of the kernel library): a CUDA-typed `paged_decode_cp`
  makes ONE C call for all shards (`ptt_paged_decode_cp`, or its `_q8`
  form over int8 pages) and passes it the stacked local tables [cp, b,
  P/cp] and page_base [cp, P/cp], cp, the per-shard page count, the split
  count `paged_splits` gives per shard, the path `paged_path` picks and a
  workspace for cp x splits partials per row.  The launch count rises once
  per call, and once on the path's count.
- `cp_stacked_tables`, which the engine uploads once per table, equals
  `cp_local_tables` of the same table stacked, shard by shard.
- The plain path (CPU tensors: one `paged_decode_partials` per shard, then
  `cp_softmax_combine`) still equals the reference's cp dispatch
  (`paged_decode_attention_array` under a cp=2 mesh, its Pallas kernel in
  interpret mode) at sq 1 and 3 in float32 and over int8 pages (2e-5) and
  in bfloat16 (atol 1e-2, rtol 2e-2: both sides round p and the output to
  bf16, at points that may sit one bf16 ulp apart).
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_kernel_paths import fake_card  # noqa: F401  (the fixture)

import paddle_tpu.ops.flash_attention as fa
from paddle_tpu.distributed import mesh as jmesh
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as pfa

BF16, F32 = torch.bfloat16, torch.float32
F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=1e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _counts():
    pfa.reset_launch_counts()
    yield
    pfa.reset_launch_counts()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _cp_arena(cp=2, ps=8, hk=2, d=16, b=3, P=4, seed=0, quant=False):
    """Global arenas and tables in the cp layout: shard s owns pages
    [s*per, (s+1)*per) with its scratch page (zero) first; sequence page j
    of every slot lies on shard j % cp.  numpy; int8 values and float32
    scales under quant."""
    per = 2 + b * P // cp  # scratch, every slot's pages, one spare
    r = np.random.RandomState(seed)
    k = r.randn(cp * per, ps, hk, d).astype(np.float32)
    v = r.randn(cp * per, ps, hk, d).astype(np.float32)
    k[::per] = v[::per] = 0.0
    tables = np.zeros((b, P), np.int32)
    for s in range(cp):
        ids = r.permutation(np.arange(s * per + 1, (s + 1) * per))[: b * (P // cp)]
        tables[:, s::cp] = ids.reshape(b, P // cp)
    if not quant:
        return k, v, tables, None, None
    (kq, ks), (vq, vs) = (
        (np.asarray(a) for a in jllama._quantize_kv_rows(jnp.asarray(x)))
        for x in (k, v))
    return kq, vq, tables, ks, vs


@pytest.mark.parametrize("cp", [2, 4])
def test_stacked_tables_equal_the_per_shard_tables(cp):
    k, _, tables, _, _ = _cp_arena(cp=cp, P=8)
    per = k.shape[0] // cp
    loc, base = pfa.cp_stacked_tables(_t(tables), cp, per, 8)
    assert loc.shape == (cp, 3, 8 // cp) and base.shape == (cp, 8 // cp)
    assert loc.dtype == base.dtype == torch.int32
    assert loc.is_contiguous() and base.is_contiguous()
    for s, (lt, bt) in enumerate(pfa.cp_local_tables(_t(tables), cp, per, 8)):
        assert torch.equal(loc[s], lt) and torch.equal(base[s], bt)


def test_engine_uploads_the_stacked_tables_once():
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    eng = ContinuousBatchingEngine(LlamaForCausalLM(cfg, device="cpu"), device="cpu",
                                   cp=2, slots=2, max_len=64, page_size=8,
                                   prefill_buckets=[8, 32], paged=True)
    table = np.zeros((2, eng.pages_per_seq), np.int32)
    table[0, :4] = [1, eng._pool.per_shard + 1, 2, eng._pool.per_shard + 2]
    loc, base = eng._local_tables(table)
    want = pfa.cp_stacked_tables(_t(table), 2, eng._pool.per_shard, 8)
    assert torch.equal(loc, want[0]) and torch.equal(base, want[1])


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("sq, hk, d, path", [
    (1, 8, 128, "walk"),    # a decode step
    (3, 8, 128, "walk"),    # a verify window
    (3, 2, 64, "walk"),     # GQA rep 4 x sq 3: 12 rows
    (64, 8, 128, "mma"),    # a chunk prefill
    (1, 8, 36, "fma"),
])
@pytest.mark.parametrize("cp", [2, 4])
def test_cp_makes_one_call_for_every_shard(fake_card, cp, sq, hk, d, path, quant):
    b, h, ps, P = 2, 8, 16, 8
    per = 1 + b * P // cp
    store = torch.int8 if quant else BF16
    ak = torch.zeros(cp * per, ps, hk, d, dtype=store)
    av = torch.zeros_like(ak)
    scales = dict(k_scale=torch.ones(cp * per, ps, hk, 1),
                  v_scale=torch.ones(cp * per, ps, hk, 1)) if quant else {}
    tables = torch.zeros(b, P, dtype=torch.int32)
    for s in range(cp):
        tables[:, s::cp] = torch.arange(s * per + 1, (s + 1) * per,
                                        dtype=torch.int32).reshape(b, P // cp)
    local = pfa.cp_stacked_tables(tables, cp, per, ps)
    q = torch.zeros(b, sq, h, d, dtype=BF16)
    pos = torch.tensor([100, 3], dtype=torch.int32)
    out = pfa.paged_decode_cp(q, ak, av, tables, pos, P * ps, cp, local=local,
                              **scales)
    assert out.shape == q.shape and out.dtype == q.dtype
    (entry, args), = fake_card.calls  # one C call for all shards
    assert entry == ("ptt_paged_decode_cp_q8" if quant else "ptt_paged_decode_cp")
    n_ptr = 10 if quant else 8
    loc_i = n_ptr - 5
    assert args[loc_i] == local[0].data_ptr() and args[loc_i + 1] == local[1].data_ptr()
    rows = (h // hk) * sq
    splits = pfa.paged_splits(path, b, hk, rows, P // cp, ps, cp)
    want_path = {"fma": 0, "mma": 1, "walk": 2}[path]
    assert args[n_ptr:n_ptr + 4] == (cp, per, splits, want_path)
    assert args[n_ptr + 4:n_ptr + 12] == (b, sq, h, hk, d, ps, P // cp, P * ps)
    assert args[n_ptr - 1] is not None  # the workspace of cp x splits partials
    name = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
    want = dict.fromkeys(pfa.launch_counts, 0)
    want[name] = 1
    if path != "fma":
        want[f"{name}_{path}"] = 1
    assert pfa.launch_counts == want


def test_cp_workspace_holds_every_shards_partials(fake_card, monkeypatch):
    sizes = []
    real = pfa._paged_workspace

    def spy(q, hk, splits, cp=1):
        ws = real(q, hk, splits, cp)
        sizes.append((splits, cp, ws.numel()))
        return ws

    monkeypatch.setattr(pfa, "_paged_workspace", spy)
    b, h, hk, d, ps, P, cp = 2, 8, 8, 128, 16, 8, 2
    per = 1 + b * P // cp
    ak = torch.zeros(cp * per, ps, hk, d, dtype=BF16)
    tables = torch.zeros(b, P, dtype=torch.int32)
    q = torch.zeros(b, 1, h, d, dtype=BF16)
    pfa.paged_decode_cp(q, ak, ak, tables, torch.tensor([5, 9], dtype=torch.int32),
                        P * ps, cp)
    (splits, got_cp, n), = sizes
    assert got_cp == cp and n == b * hk * cp * splits * 1 * (d + 2)


def test_cpu_cp_counts_nothing_and_walks_shard_by_shard(monkeypatch):
    calls = []
    real = pfa.paged_decode_partials

    def spy(*args, **kw):
        calls.append(args[3].shape)
        return real(*args, **kw)

    monkeypatch.setattr(pfa, "paged_decode_partials", spy)
    k, v, tables, _, _ = _cp_arena(cp=4, P=8)
    q = _t(np.random.RandomState(3).randn(3, 1, 4, 16).astype(np.float32))
    pfa.paged_decode_cp(q, _t(k), _t(v), _t(tables),
                        _t(np.asarray([60, 20, 7], np.int32)), 64, 4)
    assert calls == [(3, 2)] * 4  # one plain walk per shard, its local table
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)


@contextlib.contextmanager
def _reference_cp(cp):
    saved, prev = fa._FORCE_INTERPRET, jmesh.get_mesh()
    fa._FORCE_INTERPRET = True
    jmesh.serving_mesh(1, cp=cp)
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved
        jmesh.set_mesh(prev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("sq", [1, 3])
def test_plain_cp_matches_reference_cp_dispatch(sq, dtype):
    quant = dtype == "int8"
    k, v, tables, ks, vs = _cp_arena(seed=4, quant=quant)
    q = np.random.RandomState(9).randn(3, sq, 4, 16).astype(np.float32)
    pos = np.asarray([29, 6, 17 + sq], np.int32)  # slot 1: shard 1 sees nothing
    jt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tt = BF16 if dtype == "bfloat16" else F32
    if not quant:
        k, v = (np.asarray(jnp.asarray(x, jt).astype(jnp.float32)) for x in (k, v))
    q = np.asarray(jnp.asarray(q, jt).astype(jnp.float32))
    scales = dict(k_scale=ks, v_scale=vs) if quant else {}
    cast = (lambda x: jnp.asarray(x)) if quant else (lambda x: jnp.asarray(x, jt))
    with _reference_cp(2):
        ref = fa.paged_decode_attention_array(
            jnp.asarray(q, jt), cast(k), cast(v), jnp.asarray(tables),
            jnp.asarray(pos), max_len=32, kernel="fused",
            **{n: jnp.asarray(x) for n, x in scales.items()})
    tcast = (lambda x: _t(x)) if quant else (lambda x: _t(x).to(tt))
    got = pfa.paged_decode_attention(
        _t(q).to(tt), tcast(k), tcast(v), _t(tables), _t(pos), 32, kernel="fused",
        cp=2, **{n: _t(x) for n, x in scales.items()})
    assert got.dtype == tt
    tol = BF16_TOL if dtype == "bfloat16" else F32_TOL
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), **tol)
