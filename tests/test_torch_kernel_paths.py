"""The dispatch rules of the port's attention kernels, on the CPU.

- `flash_path` (K1 and K6): bfloat16 with head_dim 64 or 128 and at least
  128 query rows takes the `wgmma` + TMA kernel, other bfloat16 shapes with
  head_dim <= 128 `mma.sync`, float32 and head_dim > 128 the FMA kernel.
- `paged_path` (K2, K4 and K5): a bfloat16 q with head_dim 64 or 128 and a
  GQA group x window of at least 16 rows takes the tensor-core chunk
  window, fewer rows the decode walk, everything else the FMA page walk.
- K3 (`flash_backward`) takes `flash_path` too: the wgmma + TMA kernels
  for bfloat16 with head_dim 64 or 128 from 128 rows.
- `paged_splits` (per cp shard) and the split workspace.
- Each wrapper passes its path to the C entry point and counts the launch
  under its kernel and, on a tensor-core path, under the path's count: a
  fake library stands in for the card, so the arguments the kernels would
  get are read here.  CPU tensors launch nothing and count nothing.
- K1's and K3's ring operands (q_offset, carry, float32 out, delta,
  rectangular keys) go to the ring entry points on the same path rule,
  counted under `*_offset`, `flash_fwd_carry` and `flash_bwd_delta`; a
  launch without them keeps the parent's entry point.
"""

import pytest
import torch

from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import flash_attention as pfa

BF16, F32 = torch.bfloat16, torch.float32


@pytest.fixture(autouse=True)
def _counts():
    pfa.reset_launch_counts()
    yield
    pfa.reset_launch_counts()


@pytest.mark.parametrize("rows", [15, 16, 17, 64, 65, 256])
@pytest.mark.parametrize("d", [36, 64, 128, 256])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_paged_path_boundaries(rows, d, dtype):
    if dtype != BF16 or d not in (64, 128):
        want = "fma"
    else:
        want = "mma" if rows >= 16 else "walk"
    assert pfa.paged_path(rows, d, dtype) == want


@pytest.mark.parametrize("rows", [16, 64, 127, 128, 129, 300, 2048])
@pytest.mark.parametrize("d", [36, 64, 100, 128, 256])
@pytest.mark.parametrize("dtype", [BF16, F32], ids=["bf16", "f32"])
def test_flash_path_boundaries(rows, d, dtype):
    if dtype == F32 or d > 128:
        want = "fma"
    elif d in (64, 128) and rows >= 128:
        want = "wgmma"
    else:
        want = "mma"
    assert pfa.flash_path(rows, d, dtype) == want


@pytest.mark.parametrize("b, hk, rows, P, ps, want", [
    # the FMA page walk (float32): about 512 / rows keys per split, at
    # least a page
    (8, 32, 1, 16, 128, 4),      # decode, a 2048-token table
    (8, 32, 3, 16, 128, 16),     # the verify window: one page per split
    (2, 2, 1, 64, 16, 2),        # 32 pages of 16 rows per split
    # the chunk window: one wave of at most 396 blocks, at most one split
    # per 64-key tile
    (1, 32, 256, 16, 128, 3),    # a hit's 256-row chunk: 128 blocks
    (1, 32, 16, 16, 128, 12),    # 16 rows: 32 blocks
    (1, 32, 512, 16, 128, 1),    # 256 blocks
    (8, 32, 64, 16, 128, 1),     # 8 slots: 256 blocks
    (1, 8, 64, 16, 128, 32),     # 8 blocks: every tile of the table
    (1, 2, 16, 2, 16, 1),        # two 16-row pages: a single key tile
    (3, 2, 64, 16, 16, 4),       # 6 blocks, 4 key tiles in the table
])
def test_paged_splits(b, hk, rows, P, ps, want):
    path = pfa.paged_path(rows, 128, BF16 if rows >= 16 else F32)
    assert pfa.paged_splits(path, b, hk, rows, P, ps) == want


@pytest.mark.parametrize("b, hk, rows, P, ps, cp, want", [
    # the decode walk fills PAGED_WALK_BLOCKS (1584: four waves of three
    # blocks on each of 132 SMs), at most one split per page of the
    # shard's table
    (8, 32, 1, 16, 128, 1, 6),    # decode: 256 blocks
    (8, 32, 3, 16, 128, 1, 6),    # the verify window: one 4-row tile
    (8, 8, 12, 16, 128, 1, 12),   # rep 4 x sq 3: two 8-row tiles, 128 blocks
    (4, 32, 1, 16, 128, 2, 6),    # cp 2: 256 blocks over both shards
    (8, 32, 1, 16, 128, 2, 3),    # cp 2 at 8 slots: 512 blocks
    (1, 2, 1, 4, 16, 1, 4),       # 2 blocks: every page of the table
    (1, 2, 1, 4, 16, 4, 4),
])
def test_walk_splits(b, hk, rows, P, ps, cp, want):
    assert pfa.paged_path(rows, 128, BF16) == "walk"
    assert pfa.paged_splits("walk", b, hk, rows, P, ps, cp) == want


@pytest.mark.parametrize("rows, want", [(1, 1), (2, 4), (4, 4), (5, 8), (15, 8)])
def test_walk_row_tile(rows, want):
    assert pfa.walk_row_tile(rows) == want


@pytest.mark.parametrize("splits, cp, n", [
    (1, 1, 0), (3, 1, 1 * 4 * 3 * 2 * 16 * 66), (1, 2, 1 * 4 * 2 * 2 * 16 * 66),
    (3, 2, 1 * 4 * 6 * 2 * 16 * 66)])
def test_paged_workspace_holds_every_splits_partials(splits, cp, n):
    q = torch.zeros(1, 16, 8, 64)  # rep 2 x sq 16 rows per kv head
    assert pfa._paged_workspace(q, 4, splits, cp).numel() == n


class _FakeLib:
    """Records each entry point's arguments and answers success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def fn(*args):
            self.calls.append((name, args))
            return 0
        return fn


@pytest.fixture
def fake_card(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    monkeypatch.setattr(pfa, "_on_cuda", lambda tensors, what: True)
    monkeypatch.setattr(pfa, "_stream", lambda t: 0)
    return lib


def _paged_inputs(b, sq, h, hk, d, dtype=BF16, ps=16, P=4, quant=False):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=g).to(dtype)
    pages = b * P + 1
    store = torch.int8 if quant else dtype
    ak = torch.zeros(pages, ps, hk, d, dtype=store)
    av = torch.zeros(pages, ps, hk, d, dtype=store)
    tables = torch.arange(1, pages, dtype=torch.int32).reshape(b, P)
    pos = torch.zeros(b, dtype=torch.int32)
    scales = (torch.ones(pages, ps, hk, 1), torch.ones(pages, ps, hk, 1))
    return q, ak, av, tables, pos, scales


@pytest.mark.parametrize("sq, hk, d, dtype, path", [
    (15, 8, 64, BF16, "walk"),
    (16, 8, 64, BF16, "mma"),
    (4, 2, 128, BF16, "mma"),     # GQA: rep 4 x sq 4 = 16 rows
    (3, 2, 128, BF16, "walk"),    # 12 rows
    (1, 8, 128, BF16, "walk"),    # a decode step
    (64, 8, 36, BF16, "fma"),
    (64, 8, 64, F32, "fma"),
    (1, 8, 64, F32, "fma"),
])
@pytest.mark.parametrize("kernel", ["k2", "k4", "k5", "k5_q8"])
def test_paged_wrappers_pass_and_count_their_path(fake_card, sq, hk, d, dtype,
                                                  path, kernel):
    quant = kernel in ("k4", "k5_q8")
    q, ak, av, tables, pos, scales = _paged_inputs(1, sq, 8, hk, d, dtype,
                                                   quant=quant)
    if kernel == "k2":
        pfa.paged_decode_fused(q, ak, av, tables, pos, 64)
        name, i_splits = "paged_decode_fused", 7
    elif kernel == "k4":
        pfa.paged_decode_fused_q8(q, ak, av, *scales, tables, pos, 64)
        name, i_splits = "paged_decode_fused_q8", 9
    else:
        base = torch.arange(tables.shape[1], dtype=torch.int32) * ak.shape[1]
        pfa.paged_decode_partials(q, ak, av, tables, base, pos, 64,
                                  **(dict(k_scale=scales[0], v_scale=scales[1])
                                     if quant else {}))
        name = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
        i_splits = 12 if quant else 10
    (entry, args), = fake_card.calls
    assert entry == "ptt_" + {"paged_decode_fused": "paged_decode",
                              "paged_decode_fused_q8": "paged_decode_q8",
                              "paged_decode_fused_cp": "paged_decode_partials",
                              "paged_decode_fused_cp_q8": "paged_decode_partials_q8"}[name]
    rows = (8 // hk) * sq
    assert args[i_splits + 1] == {"fma": 0, "mma": 1, "walk": 2}[path]
    assert args[i_splits] == pfa.paged_splits(path, 1, hk, rows, 4, 16)
    want = dict.fromkeys(pfa.launch_counts, 0)
    want[name] = 1
    if path != "fma":
        want[f"{name}_{path}"] = 1
    assert pfa.launch_counts == want


@pytest.mark.parametrize("s, d, dtype, path", [
    (127, 128, BF16, "mma"),
    (128, 128, BF16, "wgmma"),
    (300, 64, BF16, "wgmma"),
    (300, 100, BF16, "mma"),
    (300, 128, F32, "fma"),
    (200, 256, BF16, "fma"),
])
def test_flash_wrappers_pass_and_count_their_path(fake_card, s, d, dtype, path):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(1, s, heads, d, generator=g).to(dtype) for heads in (8, 2, 2))
    pfa.flash_forward(q, k, v)
    pfa.dense_decode(q, k, v, torch.tensor(0, dtype=torch.int32))
    (fwd, fargs), (dec, dargs) = fake_card.calls
    code = {"fma": 0, "mma": 1, "wgmma": 2}[path]
    assert fwd == "ptt_flash_fwd" and fargs[13] == code
    assert dec == "ptt_dense_decode" and dargs[13] == code
    want = dict.fromkeys(pfa.launch_counts, 0)
    want["flash_fwd"] = want["dense_decode"] = 1
    if path == "wgmma":
        want["flash_fwd_wgmma"] = want["dense_decode_wgmma"] = 1
    assert pfa.launch_counts == want


@pytest.mark.parametrize("s, d, dtype, path", [
    (16, 128, BF16, "mma"),       # below the wgmma tile: the old kernels
    (127, 64, BF16, "mma"),
    (128, 128, BF16, "wgmma"),
    (1000, 64, BF16, "wgmma"),    # ragged
    (2048, 128, BF16, "wgmma"),   # the training shape
    (300, 100, BF16, "mma"),      # d not 64 or 128
    (300, 128, F32, "fma"),
    (200, 256, BF16, "fma"),
])
def test_flash_backward_passes_and_counts_its_path(fake_card, s, d, dtype, path):
    g = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, s, heads, d, generator=g).to(dtype)
               for heads in (8, 2, 2))
    lse = torch.zeros(1, 8, s)
    pfa.flash_backward(q, k, v, q, lse, q)
    (entry, args), = fake_card.calls
    assert entry == "ptt_flash_bwd"
    assert args[10:16] == (1, s, 8, 2, d, 1)  # b, s, h, hk, d, causal
    assert args[18] == {"fma": 0, "mma": 1, "wgmma": 2}[path]
    want = dict.fromkeys(pfa.launch_counts, 0)
    want["flash_bwd"] = 1
    if path == "wgmma":
        want["flash_bwd_wgmma"] = 1
    assert pfa.launch_counts == want


def test_cpu_tensors_take_the_plain_versions_and_count_nothing():
    q, ak, av, tables, pos, scales = _paged_inputs(1, 16, 8, 8, 64)
    pfa.paged_decode_fused(q, ak, av, tables, pos, 64)
    q8 = _paged_inputs(1, 16, 8, 8, 64, quant=True)
    pfa.paged_decode_fused_q8(q8[0], q8[1], q8[2], *q8[5], q8[3], q8[4], 64)
    base = torch.arange(4, dtype=torch.int32) * 16
    pfa.paged_decode_partials(q, ak, av, tables, base, pos, 64)
    x = torch.randn(1, 128, 8, 64).to(BF16)
    pfa.flash_forward(x, x, x)
    pfa.dense_decode(x, x, x, 0)
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)


# ---------------------------------------------------------------------------
# K1 and K3 with segment ids and key bias
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b, s, h, hk, d, dtype, path", [
    (32, 384, 12, 12, 64, BF16, "wgmma"),   # BERT-base SQuAD: wgmma at d 64
    (2, 127, 8, 2, 64, BF16, "mma"),
    (2, 64, 8, 8, 128, BF16, "mma"),
    (2, 200, 8, 2, 64, F32, "fma"),
    (1, 100, 4, 2, 256, BF16, "fma"),
])
@pytest.mark.parametrize("operands", ["segments", "kbias", "both"])
def test_masked_wrappers_pass_their_operands_and_count(fake_card, b, s, h, hk, d,
                                                       dtype, path, operands):
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(b, s, heads, d, generator=g).to(dtype)
               for heads in (h, hk, hk))
    segs = torch.zeros(b, s, dtype=torch.int32) if operands != "kbias" else None
    kbias = torch.zeros(b, s) if operands != "segments" else None
    pfa.flash_forward(q, k, v, False, None, segs, kbias)
    pfa.flash_backward(q, k, v, q, torch.zeros(b, h, s), q, False, None, segs, kbias)
    (fwd, fargs), (bwd, bargs) = fake_card.calls
    code = {"fma": 0, "mma": 1, "wgmma": 2}[path]
    ptr = lambda t: None if t is None else t.data_ptr()
    assert fwd == "ptt_flash_fwd" and fargs[13:16] == (code, ptr(segs), ptr(kbias))
    assert bwd == "ptt_flash_bwd" and bargs[18:21] == (code, ptr(segs), ptr(kbias))
    want = dict.fromkeys(pfa.launch_counts, 0)
    for name in ("flash_fwd", "flash_bwd"):
        want[name] = want[name + "_masked"] = 1
        if path == "wgmma":
            want[name + "_wgmma"] = 1
    assert pfa.launch_counts == want


def test_unmasked_launches_pass_null_operands(fake_card):
    x = torch.zeros(1, 128, 4, 64, dtype=BF16)
    pfa.flash_forward(x, x, x)
    pfa.dense_decode(x, x, x, 0)
    (_, fargs), (dec, dargs) = fake_card.calls
    assert fargs[14:16] == (None, None)
    assert dec == "ptt_dense_decode" and len(dargs) == 15  # K6 takes no masking
    assert pfa.launch_counts["flash_fwd_masked"] == 0


MASKS = {
    "none": None,
    "key padding [b, 1, 1, s]": torch.zeros(2, 1, 1, 64),
    "key padding [1, 1, 1, s]": torch.zeros(1, 1, 1, 64),
    "per head [b, h, 1, s]": torch.zeros(2, 4, 1, 64),
    "general [b, 1, s, s]": torch.zeros(2, 1, 64, 64),
}


@pytest.mark.parametrize("mask", MASKS, ids=list(MASKS))
@pytest.mark.parametrize("shape", ["self", "gqa", "cross", "d 300"])
def test_flash_viable_follows_the_reference_rule(mask, shape):
    """`flash_viable` (the reference's `_pallas_viable`): the kernels take
    no mask or a key-padding one, over q and k of one batch, length and
    head width (GQA allowed); everything else is the plain path."""
    d = 300 if shape == "d 300" else 16
    q = torch.zeros(2, 64, 4, d)
    k = torch.zeros(2, 48 if shape == "cross" else 64, 2 if shape == "gqa" else 4, d)
    m = MASKS[mask]
    if shape == "cross" and m is not None:
        m = m[..., :48]
    kbias = pfa.key_padding_bias(m, 2, k.shape[1])
    viable, reason = pfa.flash_viable(q, k, m, kbias)
    if mask.startswith("per head") or mask.startswith("general"):
        assert (viable, reason) == (False, "attn_mask not key-padding")
    elif shape == "cross":
        assert (viable, reason) == (False, "q/k shapes differ")
    elif shape == "d 300":
        assert (viable, reason) == (False, "head_dim > 256")
    else:
        assert (viable, reason) == (True, None)


def test_sdpa_dispatch_on_the_card(fake_card):
    """On CUDA tensors a key-padding mask or segment ids launch K1 with
    their operands; a general mask takes the plain path and reaches no
    kernel, counted as a fallback."""
    q = torch.zeros(2, 128, 4, 64, dtype=BF16)
    segs = torch.zeros(2, 128, dtype=torch.int64)
    pfa.sdpa(q, q, q, segment_ids=segs)
    pfa.sdpa(q, q, q, torch.zeros(2, 1, 1, 128))
    calls = [name for name, _ in fake_card.calls]
    assert calls == ["ptt_flash_fwd", "ptt_flash_fwd"]
    assert fake_card.calls[0][1][14] is not None  # the ids, as int32
    assert fake_card.calls[1][1][15] is not None  # the key bias
    pfa.sdpa(q, q, q, torch.zeros(2, 1, 128, 128))
    assert len(fake_card.calls) == 2
    assert pfa.fallback_counts["attn_mask not key-padding"] == 1
    assert pfa.launch_counts["flash_fwd_masked"] == 2


def test_cpu_masked_calls_never_reach_the_library(monkeypatch):
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")

    monkeypatch.setattr(_build, "lib", no_library)
    q = torch.randn(2, 64, 4, 16)
    for mask in MASKS.values():
        pfa.sdpa(q, q, q, mask, segment_ids=torch.zeros(2, 64, dtype=torch.int32))
    q.requires_grad_()
    pfa.sdpa(q, q, q, MASKS["key padding [b, 1, 1, s]"]).sum().backward()
    assert pfa.launch_counts == dict.fromkeys(pfa.launch_counts, 0)


# ---------------------------------------------------------------------------
# K1 and K3 with the ring operands
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s, lk, d, dtype, path", [
    (4096, 32768, 128, BF16, "wgmma"),   # the gathered form at 32k, R 8
    (2048, 2048, 128, BF16, "wgmma"),    # a rotating hop
    (512, 2048, 64, BF16, "wgmma"),
    (512, 2048, 96, BF16, "mma"),
    (256, 1024, 128, F32, "fma"),
    (256, 512, 256, BF16, "fma"),
])
def test_ring_operands_take_the_ring_entry_on_their_path(fake_card, s, lk, d,
                                                         dtype, path):
    """q_offset, the carry and float32 out go to `ptt_flash_fwd_ring`,
    q_offset and delta to `ptt_flash_bwd_ring`, each on `flash_path(s, d,
    dtype)`'s kernel, with the rows per q block, the key length and the
    operands' pointers; the launches count under the operand's name."""
    g = torch.Generator().manual_seed(4)
    q = torch.randn(1, s, 4, d, generator=g).to(dtype)
    k = torch.randn(1, lk, 4, d, generator=g).to(dtype)
    starts = torch.arange(0, s, 128, dtype=torch.int32)  # blocks of 128 rows
    out, lse = pfa.flash_forward(q, k, k, True, None, q_offset=starts)
    carry = (torch.zeros(1, s, 4, d), torch.zeros(1, 4, s))
    pfa.flash_forward(q, q, q, False, None, carry=carry, out_dtype=F32)
    pfa.flash_backward(q, k, k, out, lse, q, True, None, q_offset=starts)
    delta = torch.zeros(1, 4, s)
    pfa.flash_backward(q, q, q, None, lse, q, False, None, delta=delta)
    code = {"fma": 0, "mma": 1, "wgmma": 2}[path]
    (f1, a1), (f2, a2), (b1, c1), (b2, c2) = fake_card.calls
    assert f1 == f2 == "ptt_flash_fwd_ring" and b1 == b2 == "ptt_flash_bwd_ring"
    # q_offset, carry_out, carry_lse; b, s, lk, h, hk, d, bq, causal; path, out_f32
    assert a1[5:8] == (starts.data_ptr(), None, None)
    assert a1[8:16] == (1, s, lk, 4, 4, d, 128, 1)
    assert a1[18:20] == (code, int(dtype == F32))  # a float32 out: out32
    assert a2[5:8] == (None, carry[0].data_ptr(), carry[1].data_ptr())
    assert a2[8:16] == (1, s, s, 4, 4, d, 0, 0) and a2[18:20] == (code, 1)
    # delta scratch, q_offset; b, s, lk, h, hk, d, bq, causal; path, delta_given
    assert c1[10] == starts.data_ptr() and c1[11:19] == (1, s, lk, 4, 4, d, 128, 1)
    assert c1[21:23] == (code, 0)
    assert c2[3] is None and c2[9] == delta.data_ptr() and c2[10] is None
    assert c2[11:19] == (1, s, s, 4, 4, d, 0, 0) and c2[21:23] == (code, 1)
    want = dict.fromkeys(pfa.launch_counts, 0)
    want.update(flash_fwd=2, flash_bwd=2, flash_fwd_offset=1, flash_fwd_carry=1,
                flash_bwd_offset=1, flash_bwd_delta=1)
    if path == "wgmma":
        want.update(flash_fwd_wgmma=2, flash_bwd_wgmma=2)
    assert pfa.launch_counts == want


def test_launches_without_ring_operands_keep_the_parents_entry(fake_card):
    """K1 and K3 without the ring operands and with sq == sk call the entry
    points they called before the operands existed."""
    x = torch.zeros(1, 256, 4, 128, dtype=BF16)
    out, lse = pfa.flash_forward(x, x, x)
    pfa.flash_backward(x, x, x, out, lse, x)
    assert [name for name, _ in fake_card.calls] == ["ptt_flash_fwd", "ptt_flash_bwd"]
