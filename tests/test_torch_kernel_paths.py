"""The dispatch rules of the port's attention kernels, on the CPU.

- `flash_path` (K1 and K6): bfloat16 with head_dim 64 or 128 and at least
  128 query rows takes the `wgmma` + TMA kernel, other bfloat16 shapes with
  head_dim <= 128 `mma.sync`, float32 and head_dim > 128 the FMA kernel.
- `paged_path` (K2, K4 and K5): a bfloat16 q with head_dim 64 or 128 and a
  GQA group x window of at least 16 rows takes the tensor-core chunk
  window, everything else the FMA page walk.
- `paged_splits` and the split workspace.
- Each wrapper passes its path to the C entry point and counts the launch
  under its kernel and, on a tensor-core path, under the path's count: a
  fake library stands in for the card, so the arguments the kernels would
  get are read here.  CPU tensors launch nothing and count nothing.
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
    want = "mma" if dtype == BF16 and d in (64, 128) and rows >= 16 else "fma"
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
    # the FMA page walk: about 512 / rows keys per split, at least a page
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
    path = pfa.paged_path(rows, 128, BF16)
    assert pfa.paged_splits(path, b, hk, rows, P, ps) == want


@pytest.mark.parametrize("splits, n", [(1, 0), (3, 1 * 4 * 3 * 2 * 16 * 66)])
def test_paged_workspace_holds_every_splits_partials(splits, n):
    q = torch.zeros(1, 16, 8, 64)  # rep 2 x sq 16 rows per kv head
    assert pfa._paged_workspace(q, 4, splits).numel() == n


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
    (15, 8, 64, BF16, "fma"),
    (16, 8, 64, BF16, "mma"),
    (4, 2, 128, BF16, "mma"),     # GQA: rep 4 x sq 4 = 16 rows
    (3, 2, 128, BF16, "fma"),     # 12 rows
    (64, 8, 36, BF16, "fma"),
    (64, 8, 64, F32, "fma"),
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
    assert args[i_splits + 1] == int(path == "mma")  # the path argument
    assert args[i_splits] == pfa.paged_splits(path, 1, hk, rows, 4, 16)
    want = dict.fromkeys(pfa.launch_counts, 0)
    want[name] = 1
    if path == "mma":
        want[name + "_mma"] = 1
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
