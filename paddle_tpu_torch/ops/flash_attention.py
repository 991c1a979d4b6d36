"""Attention for the PyTorch/CUDA port: the counterpart of
`paddle_tpu/ops/flash_attention.py`.

Layout at the public functions is the reference's `[batch, seq, heads,
head_dim]`.  Six hand-written Hopper kernels carry the serving and
training paths:

- `flash_fwd` (csrc/flash_fwd.cu, replaces `_flash_fwd_kernel`): causal
  prompt attention at the fresh-prefill site and every training forward,
  through `sdpa`; every hop of ring attention
  (`distributed/fleet/meta_parallel/ring_attention.py`).
- `flash_bwd` (csrc/flash_bwd.cu, replaces `_pallas_flash_backward`): the
  attention gradient of a training step, through the `FlashAttention`
  autograd Function that `sdpa` uses when grad is recorded, and of every
  ring hop.
- `paged_decode_fused` (csrc/paged_decode.cu, replaces
  `_fused_paged_decode_forward`): every decode step and every chunk
  prefill of a prefix-cache hit, reading the K/V page arena through the
  page tables in-kernel; and every cached attention against a dense
  static cache outside K6's shapes (lock-step decode steps and short
  prefills, the dense slot pool's decode), over the cache's page view
  (`dense_page_view`, `dense_page_table`).
- `paged_decode_fused_q8` (csrc/paged_decode.cu, replaces
  `_fused_paged_decode_quant_forward`): the same over an int8 arena with
  per-row float32 scales, dequantized in-kernel.
- `dense_decode` (csrc/flash_fwd.cu, K1's kernels with a query offset read
  from the device; replaces `_pallas_decode_forward`): cached attention
  against a dense static KV cache, taken by `decode_attention` where the
  reference takes its Pallas kernel -- the prefill of lock-step
  generation from 64 rows.
- `paged_decode_tp`, `paged_decode_q8_tp` (replace the reference's
  `shard_map`s of K2 and K4 over heads): tensor-parallel paged attention,
  one `paged_decode_fused` (or `_q8`) launch per rank over its head shard;
  their `paged_decode_tp` / `paged_decode_tp_q8` counts are a subset of
  K2's and K4's.  `paged_decode_cp_tp` (replaces the reference's K5
  `shard_map` over the ('cp', 'mp') mesh) is the same per rank for
  tensor x context parallelism: one `paged_decode_cp` launch per rank over
  its head shard's cp page shards, counted under `paged_decode_cp_tp` /
  `paged_decode_cp_tp_q8` (a subset of K5's count).
- `paged_decode_partials` (csrc/paged_decode.cu, K2's page walk with a
  token position per table column and un-normalised output; replaces
  `_fused_paged_decode_partials_forward`): context-parallel paged
  attention over each cp shard's page range.  On one card
  `paged_decode_cp` walks every shard in one launch and merges them in the
  split combine; per shard, the partials feed `cp_softmax_combine`, the
  form the merge takes across cards.

K1's non-ring form is a registered op of torch's dispatcher,
`paddle_tpu_torch::flash_fwd` (`flash_fwd_op`): `torch.export` keeps it as
one node, so a program exported by `inference.export` or `jit.save` runs
the kernel where it is loaded on the card.

Each kernel has a plain PyTorch version here.  A wrapper takes the plain
version only for a tensor on the CPU (the tests); for a CUDA tensor it
launches the kernel or raises.  `launch_counts` counts kernel launches, so a
run can show that the main path went through the kernels.

Where a kernel has more than one implementation, one function here picks it
from the shape and passes the choice to the C entry point, which raises on
a shape the choice does not fit (never another kernel): `flash_path` for
K1, K6 and K3 (the `wgmma` + TMA kernels, `mma.sync`, or FMA) and
`paged_path` for K2, K4 and K5 (the tensor-core chunk window, the decode
walk, or the FMA page walk).  The `*_wgmma`, `*_mma` and `*_walk` counts
are the launches that took those kernels, a subset of their kernel's
count.

K1 and K3 also take the reference's `segments` (packed sequences, BERT's
padding) and `kbias` (a lowered key-padding mask) on every path; their
`*_masked` counts are the launches that carried either.  `sdpa` picks the
kernels or the reference's XLA path (`attention_plain`, plain torch ops
under autograd) by the reference's rule, `flash_viable`, and counts the
second in `fallback_counts`.

K1 and K3 take the reference's ring operands too, through their own C
entry points (`ptt_flash_fwd_ring`, `ptt_flash_bwd_ring`), so a launch
without them is the one it was before: keys of another length than the
queries; `q_offset` ([s / bq] int32, `q_block_starts`), the absolute start
of each bq-row block of q (the zig-zag shard's two chunks); K1's `carry`
(a partial out and lse the launch merges its keys onto) and `out_dtype=
torch.float32`; K3's `delta` (rowsum(g * out), computed once by the ring
for all its hops).  Causal masking is by absolute position: key j at j,
query row i at i or at its block's offset (`_masked_scores`).  Their
launches count under `*_offset`, `flash_fwd_carry` and `flash_bwd_delta`.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework import nan_inf as _nan
from ..framework.core import INDEX_DTYPE

NEG_INF = -1e30  # the reference's mask value (flash_attention.py:36)

# K5's two counts carry the reference's names (`_log_pallas_call`,
# flash_attention.py:1608) and count kernel launches: one per
# `paged_decode_cp` call (every shard), or one per shard through
# `paged_decode_partials`
launch_counts = {"flash_fwd": 0, "paged_decode_fused": 0,
                 "paged_decode_fused_q8": 0, "flash_bwd": 0, "dense_decode": 0,
                 "paged_decode_fused_cp": 0, "paged_decode_fused_cp_q8": 0,
                 "flash_fwd_wgmma": 0, "dense_decode_wgmma": 0,
                 "flash_bwd_wgmma": 0,
                 "flash_fwd_masked": 0, "flash_bwd_masked": 0,
                 "flash_fwd_offset": 0, "flash_fwd_carry": 0,
                 "flash_bwd_offset": 0, "flash_bwd_delta": 0,
                 "paged_decode_fused_mma": 0, "paged_decode_fused_q8_mma": 0,
                 "paged_decode_fused_cp_mma": 0, "paged_decode_fused_cp_q8_mma": 0,
                 "paged_decode_fused_walk": 0, "paged_decode_fused_q8_walk": 0,
                 "paged_decode_fused_cp_walk": 0, "paged_decode_fused_cp_q8_walk": 0,
                 "paged_decode_tp": 0, "paged_decode_tp_q8": 0,
                 "paged_decode_cp_tp": 0, "paged_decode_cp_tp_q8": 0}

MAX_HEAD_DIM = 256
# (row, key) pairs one block of the FMA paged kernel takes on, about: a
# decode block (one row) walks ~512 keys, a 64-row chunk-prefill tile one
# page; longer page walks split across blocks
PAGED_SPLIT_KEYS = 512
# rows of the GQA group x window one block of the paged kernels holds
PAGED_ROW_TILE = 64
# the chunk window takes the tensor-core kernel from one warp's 16 rows
PAGED_MMA_MIN_ROWS = 16
# keys per tile of the tensor-core chunk kernel
PAGED_MMA_KEYS = 64
# blocks the chunk kernel's grid fills: three (~70 KB of shared memory
# each at d 128) per SM of an H100 (132 SMs), one wave
PAGED_MMA_BLOCKS = 396
# blocks the decode walk's grid fills: four waves of three per SM, so a
# long slot's walk splits into short ones while short slots' blocks finish
# at once (a throwaway sweep on the H100 of one and two waves against four
# and eight favoured four)
PAGED_WALK_BLOCKS = 1584
# the q tile of K1's Hopper kernel (two warpgroups of 64 rows)
FLASH_WGMMA_ROWS = 128
# rows per page of a dense cache's page view (`dense_page_view`): the
# paged engine's page size, so K2 splits a dense walk as it splits a paged
# one
DENSE_PAGE_ROWS = 128

# the kernels' dtype codes (csrc/common.cuh); bfloat16 and float16, the
# 16-bit types, take the tensor-core paths
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
HALF_DTYPES = (torch.bfloat16, torch.float16)


def reset_launch_counts():
    """Zero every launch count and every fallback count."""
    for name in launch_counts:
        launch_counts[name] = 0
    reset_fallback_counts()


# The reference's kernel names (`_PALLAS_KERNELS`, flash_attention.py:
# 1826-1830) and their dispatch counts with the reference's meaning: one
# per compiled shape (`_log_pallas_call`, :1848), that is one per launch
# site in a StepGraph trace (its warm run; the capture and every replay
# add nothing) or per launch outside a graph.  `launch_counts` keeps
# counting every launch, replays included.  `/metrics` renders these as
# `paddle_flash_pallas_calls_total{kernel=}`.
PALLAS_KERNELS = ("flash_fwd", "flash_bwd", "decode", "paged_decode_fused",
                  "paged_decode_fused_q8", "paged_decode_fused_cp",
                  "paged_decode_fused_cp_q8")
_PALLAS_NAME = {"dense_decode": "decode"}  # K6 under the reference's name
pallas_calls = dict.fromkeys(PALLAS_KERNELS, 0)


def reset_pallas_calls():
    for name in pallas_calls:
        pallas_calls[name] = 0


def _dispatched(what):
    """One launch of the kernel `what` (a `launch_counts` base name): its
    launch count and its per-compiled-shape dispatch count."""
    launch_counts[what] += 1
    name = _PALLAS_NAME.get(what, what)
    pallas_calls[name] = pallas_calls.get(name, 0) + 1


def _dtype_code(t, what):
    """The kernels' dtype code of t: 0 float32, 1 bfloat16, 2 float16;
    any other dtype raises TypeError."""
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"{what}: dtype {t.dtype} not supported (float32, bfloat16 or "
            "float16)"
        ) from None


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _on_cuda(tensors, what):
    """True for CUDA tensors, False for CPU tensors; raises on a mix or on
    any other device."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return False
    if kinds == {"cuda"}:
        if len({t.device for t in tensors}) != 1:
            raise ValueError(f"{what}: tensors on different CUDA devices")
        return True
    raise ValueError(f"{what}: tensors on unsupported devices {sorted(kinds)}")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


_FLASH_PATHS = {"fma": 0, "mma": 1, "wgmma": 2}
_PAGED_PATHS = {"fma": 0, "mma": 1, "walk": 2}


def flash_path(rows, d, dtype):
    """The kernel K1, K6 and K3 launch for `rows` query rows of head_dim `d`:
    "wgmma" (TMA + `wgmma`, a 128-row tile per block) for bfloat16 or
    float16 with d 64 or 128 and at least FLASH_WGMMA_ROWS rows; "mma"
    (`mma.sync`, 64-row tiles) for the other 16-bit shapes with d <= 128;
    "fma" for float32 and d > 128.  float16 takes the path bfloat16 takes."""
    half = dtype in HALF_DTYPES
    if half and d in (64, 128) and rows >= FLASH_WGMMA_ROWS:
        return "wgmma"
    return "mma" if half and d <= 128 else "fma"


def paged_path(rows, d, dtype):
    """The kernel K2, K4 and K5 launch for a GQA group x window of `rows` =
    rep * sq rows, for a bfloat16 or float16 q with d 64 or 128: "mma" (the
    tensor-core chunk window) from PAGED_MMA_MIN_ROWS rows -- every chunk
    prefill of a served Llama -- and "walk" (the decode walk: cp.async
    ring, dot products in registers) below -- every decode step and verify
    window; "fma" (the page walk on FMAs) for float32 and other d."""
    if dtype not in HALF_DTYPES or d not in (64, 128):
        return "fma"
    return "mma" if rows >= PAGED_MMA_MIN_ROWS else "walk"


def walk_row_tile(rows):
    """Rows one decode-walk block holds: 1, 4, or 8 (so 9-15 rows take two
    blocks)."""
    return 1 if rows == 1 else 4 if rows <= 4 else 8


def paged_splits(path, b, hk, rows, P, ps, cp=1):
    """Blocks each cp shard's page walk splits into (`P` the shard's table
    width).  FMA: a block of r rows (at most one row tile) does r times a
    decode block's work per key, so it walks about PAGED_SPLIT_KEYS / r
    keys, at least one page.  The tensor-core chunk window and the decode
    walk: the host does not know the live length (pos lies on the card), so
    it splits only to fill the card -- one wave of PAGED_MMA_BLOCKS blocks
    for the chunk window, at most one split per 64-key tile of the table;
    PAGED_WALK_BLOCKS for the walk, at most one split per page -- and each
    block divides the live key tiles among the splits itself."""
    if path == "fma":
        keys = PAGED_SPLIT_KEYS // min(rows, PAGED_ROW_TILE)
        return -(-P // max(1, keys // ps))
    if path == "walk":
        blocks = cp * b * hk * -(-rows // walk_row_tile(rows))
        return max(1, min(P, PAGED_WALK_BLOCKS // blocks))
    tiles = -(-(P * ps) // PAGED_MMA_KEYS)
    blocks = cp * b * hk * -(-rows // PAGED_ROW_TILE)
    return max(1, min(tiles, PAGED_MMA_BLOCKS // blocks))


# ---------------------------------------------------------------------------
# K1: flash-attention forward
# ---------------------------------------------------------------------------


def _check_flash(q, k, v):
    """q [b, s, h, d] against k, v [b, lk, hk, d]: lk may differ from s
    (the ring's gathered keys)."""
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "flash_fwd: q, k, v must be [b, s, h, d]")
    b, s, h, d = q.shape
    _require(k.shape == v.shape, "flash_fwd: k and v shapes differ")
    _require(k.shape[0] == b and k.shape[1] >= 1 and k.shape[3] == d,
             f"flash_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} must share "
             "batch and head_dim")
    _require(h % k.shape[2] == 0,
             f"flash_fwd: {h} q heads not a multiple of {k.shape[2]} kv heads")
    _require(d <= MAX_HEAD_DIM, f"flash_fwd: head_dim {d} > {MAX_HEAD_DIM}")
    _require(q.dtype == k.dtype == v.dtype, "flash_fwd: q, k, v dtypes differ")
    _dtype_code(q, "flash_fwd")


def _check_masking(q, k, segments, kbias, what):
    """`segments` [b, s] int32 and `kbias` [b, s] float32, each optional,
    on q's device; either needs keys as long as the queries (the ids are
    shared by both)."""
    b, s = q.shape[0], q.shape[1]
    _require((segments is None and kbias is None) or k.shape[1] == s,
             f"{what}: segments and kbias need sq == sk, got {s} and {k.shape[1]}")
    if segments is not None:
        _require(tuple(segments.shape) == (b, s) and segments.dtype == INDEX_DTYPE,
                 f"{what}: segments must be [b, s] = [{b}, {s}] int32, got "
                 f"{tuple(segments.shape)} {segments.dtype}")
        _require(segments.device == q.device, f"{what}: segments not on q's device")
    if kbias is not None:
        _require(tuple(kbias.shape) == (b, s) and kbias.dtype == torch.float32,
                 f"{what}: kbias must be [b, s] = [{b}, {s}] float32, got "
                 f"{tuple(kbias.shape)} {kbias.dtype}")
        _require(kbias.device == q.device, f"{what}: kbias not on q's device")


def q_block_starts(offsets_and_lens, bq, device):
    """The reference's `q_block_starts` (flash_attention.py:144): per-q-block
    absolute start positions of a q formed by concatenating chunks,
    [(global_offset, rows), ...] -> an int32 tensor on `device`, one entry
    per `bq` rows.  `bq` divides every chunk, so no block straddles two."""
    starts = []
    for off, n in offsets_and_lens:
        _require(n % bq == 0, f"q_block_starts: {bq} does not divide {n} rows")
        starts.extend(range(off, off + n, bq))
    return torch.tensor(starts, dtype=INDEX_DTYPE, device=device)


def _offset_block(q_offset, s):
    """The rows of each block of `q_offset` ([s / bq] int32): bq, a multiple
    of 128 dividing s (a kernel tile of 64 or 128 rows never straddles two
    blocks)."""
    n = q_offset.numel()
    _require(q_offset.dim() == 1 and q_offset.dtype == INDEX_DTYPE and n >= 1
             and s % n == 0 and (s // n) % 128 == 0,
             f"q_offset must be [s / bq] int32 with bq a multiple of 128 "
             f"dividing s = {s}, got {tuple(q_offset.shape)} {q_offset.dtype}")
    return s // n


def q_positions(s, q_offset, device):
    """Absolute positions [s] of the query rows: row i of block j at
    q_offset[j] + i % bq, or i without offsets (the reference's kernels,
    `q_start = qi * block_q`, flash_attention.py:80-86)."""
    rows = torch.arange(s, device=device)
    if q_offset is None:
        return rows
    bq = _offset_block(q_offset, s)
    return q_offset.to(device).long().repeat_interleave(bq) + rows % bq


def _masked_scores(sc, causal, segments, kbias, q_pos=None):
    """The reference's masking of [b, h, sq, sk] float32 scores, already
    scaled (`_blk_mask`, flash_attention.py:51-62, after the key bias of
    :115-124): plus kbias per key, then NEG_INF where the causal fence or
    the segment ids (a query sees only keys of its own id) exclude a pair.
    The causal fence is by absolute position: key j sits at j, query row i
    at q_pos[i] and sees keys j <= q_pos[i].  Without `q_pos` the rows sit
    at 0..sq-1 (top-left, as the reference's kernels without q_offset:
    for sq != sk a causal call passes explicit positions); the XLA path's
    bottom-right alignment is q_pos = i + sk - sq (`attention_plain`)."""
    if kbias is not None:
        sc = sc + kbias[:, None, None, :]
    sq, sk = sc.shape[-2], sc.shape[-1]
    if causal:
        if q_pos is None:
            q_pos = torch.arange(sq, device=sc.device)
        k_ids = torch.arange(sk, device=sc.device)[None, :]
        sc = torch.where(q_pos[:, None] >= k_ids, sc, NEG_INF)
    if segments is not None:
        same = segments[:, None, :, None] == segments[:, None, None, :]
        sc = torch.where(same, sc, NEG_INF)
    return sc


def flash_forward_plain(q, k, v, causal, scale, segments=None, kbias=None,
                        q_offset=None, carry=None, out_dtype=None):
    """Plain version of `flash_fwd`: the reference's dense attention
    (`_dense_attention`, flash_attention.py:1744) on [b, s, h, d] inputs
    against k, v [b, lk, hk, d], masked as `_masked_scores` says (rows at
    the absolute positions of `q_offset`).  A row whose every key is masked
    (a key-padding bias of NEG_INF on all of them) has lse == NEG_INF, so p
    is 1 on every key; its output is the mean of V, as the reference's
    kernel divides by their count (:137-141).  `carry=(out_prev [b, s, h,
    d] f32, lse_prev [b, h, s] f32)` enters as one more key with score
    lse_prev and value out_prev (the reference's `_init`, :89-96).  Returns
    (out [b, s, h, d] in `out_dtype`, default q's dtype, lse [b, h, s]
    float32)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, s, d]
    rep = qt.shape[1] // kt.shape[1]
    if rep != 1:  # GQA: kv head i serves q heads [i*rep, (i+1)*rep)
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qt.float(), kt.float()) * scale
    q_pos = q_positions(q.shape[1], q_offset, q.device) if causal else None
    s = _masked_scores(s, causal, segments, kbias, q_pos)
    out_dtype = out_dtype or q.dtype
    if carry is not None:
        out_prev, lse_prev = carry
        m = torch.maximum(s.amax(-1), lse_prev)
        p = torch.exp(s - m[..., None])
        w = torch.exp(lse_prev - m)  # the carry's weight
        l = (p.sum(-1) + w).clamp_min(1e-30)
        acc = (torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
               + w[..., None] * out_prev.transpose(1, 2))
        out = acc / l[..., None]
        return (out.to(out_dtype).transpose(1, 2).contiguous(),
                m + torch.log(l))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
    if kbias is not None:  # sum(p) is 1 but on rows with no live key
        out = out / p.sum(-1, keepdim=True)
    return out.to(out_dtype).transpose(1, 2).contiguous(), lse


def _check_ring(q, q_offset, carry, out_dtype, what):
    """The ring operands: `q_offset` [s / bq] int32 (see `_offset_block`),
    `carry` (out [b, s, h, d] float32, lse [b, h, s] float32), `out_dtype`
    None or float32, all on q's device."""
    b, s, h, d = q.shape
    if q_offset is not None:
        _offset_block(q_offset, s)
        _require(q_offset.device == q.device, f"{what}: q_offset not on q's device")
    if carry is not None:
        out_prev, lse_prev = carry
        _require(tuple(out_prev.shape) == (b, s, h, d)
                 and out_prev.dtype == torch.float32
                 and tuple(lse_prev.shape) == (b, h, s)
                 and lse_prev.dtype == torch.float32,
                 f"{what}: carry must be (out [b, s, h, d] float32, lse [b, h, "
                 f"s] float32)")
        _require(out_prev.device == q.device and lse_prev.device == q.device,
                 f"{what}: carry not on q's device")
    _require(out_dtype in (None, torch.float32),
             f"{what}: out_dtype must be None or torch.float32")


def flash_forward(q, k, v, causal=True, scale=None, segments=None, kbias=None,
                  q_offset=None, carry=None, out_dtype=None):
    """K1 wrapper.  q: [b, s, h, d]; k, v: [b, lk, hk, d] with h % hk == 0
    (GQA indexes kv head h // rep in-kernel); float32, bfloat16 or
    float16.
    `segments` ([b, s] int32: a query attends only to keys of its own id)
    and `kbias` ([b, s] float32, added to every head's scores of that key)
    are optional, shared by all heads, read in-kernel, and need lk == s.
    The ring operands (the reference's, flash_attention.py:186): `q_offset`
    ([s / bq] int32 on q's device, `q_block_starts`) puts each bq-row block
    of q at its own absolute position, key j at j (without it row i is at
    i; a causal call with lk != s passes it); `carry=(out_prev, lse_prev)`
    merges this call's keys onto a partial result; `out_dtype=
    torch.float32` keeps the output in float32.  The form without ring
    operands and with keys as long as the queries is traced (`torch.export`)
    as the registered op `flash_fwd_op`, so an exported program keeps it;
    computed, it runs the op's body directly, without the dispatcher's host
    cost per call.  Returns (out [b, s, h, d], lse [b, h, s] float32)."""
    _check_flash(q, k, v)
    _check_masking(q, k, segments, kbias, "flash_fwd")
    _check_ring(q, q_offset, carry, out_dtype, "flash_fwd")
    _require(segments is None and kbias is None
             or q_offset is None and carry is None and out_dtype is None,
             "flash_fwd: segments and kbias do not combine with the ring operands")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q_offset is None and carry is None and out_dtype is None and k.shape[1] == q.shape[1]:
        fn = flash_fwd_op if _traced(q) else _flash_fwd
        return fn(q, k, v, bool(causal), float(scale), segments, kbias)
    if not _on_cuda((q, k, v), "flash_fwd"):
        return flash_forward_plain(q, k, v, causal, scale, segments, kbias,
                                   q_offset, carry, out_dtype)
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "flash_fwd: q, k, v must be contiguous")
    from ._build import check, lib

    b, s, h, d = q.shape
    lk = k.shape[1]
    path = flash_path(s, d, q.dtype)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    bq = 0 if q_offset is None else _offset_block(q_offset, s)
    if carry is not None:
        carry = tuple(x.contiguous() for x in carry)
    code = lib().ptt_flash_fwd_ring(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(_contiguous_or_none(q_offset)),
        *(_ptr(x) for x in (carry or (None, None))), b, s, lk, h, k.shape[2],
        d, bq, int(bool(causal)), float(scale), _dtype_code(q, "flash_fwd"),
        _FLASH_PATHS[path], int(out.dtype == torch.float32), _stream(q),
    )
    check(code, f"flash_fwd ring ({path})")
    _count_flash("flash_fwd", path, None, None, q_offset, carry)
    _nan.check_written("flash_fwd", (out, lse))
    return out, lse


def _traced(t):
    """Whether `t` is a value being traced (`torch.export`, a compiler)
    rather than computed."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor) or torch.compiler.is_compiling()


@torch.library.custom_op("paddle_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: float, segments: Optional[torch.Tensor],
                 kbias: Optional[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's non-ring form as a registered op, `paddle_tpu_torch::flash_fwd`:
    (out [b, s, h, d] in q's dtype, lse [b, h, s] float32) of q against k, v
    of q's length, with the optional segment ids and key bias, inputs
    checked by `flash_forward`.  Being an op of torch's dispatcher, it stays
    one node of a `torch.export` program (`inference.export`, `jit.save`),
    where plain tensor code would be traced into the einsums of its plain
    version; a program loaded on the card then launches the kernel.  Its
    body is `_flash_fwd`."""
    return _flash_fwd(q, k, v, causal, scale, segments, kbias)


def _flash_fwd(q, k, v, causal, scale, segments, kbias):
    """`flash_fwd_op`'s body: a CPU tensor runs `flash_forward_plain`; a
    CUDA tensor launches the kernel (counted in `launch_counts`, its
    outputs handed to FLAGS_check_nan_inf's check) or raises."""
    if not _on_cuda((q, k, v), "flash_fwd"):
        return flash_forward_plain(q, k, v, causal, scale, segments, kbias)
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "flash_fwd: q, k, v must be contiguous")
    from ._build import check, lib

    b, s, h, d = q.shape
    path = flash_path(s, d, q.dtype)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    segments, kbias = _contiguous_or_none(segments), _contiguous_or_none(kbias)
    out = torch.empty_like(q)
    code = lib().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, int(causal), scale,
        _dtype_code(q, "flash_fwd"), _FLASH_PATHS[path], _ptr(segments),
        _ptr(kbias), _stream(q),
    )
    check(code, f"flash_fwd ({path})")
    _count_flash("flash_fwd", path, segments, kbias)
    _nan.check_written("flash_fwd", (out, lse))
    return out, lse


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, segments, kbias):
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


def _contiguous_or_none(t):
    return None if t is None else t.contiguous()


def _ptr(t):
    """A tensor's device address for a nullable kernel operand (None: the
    null pointer)."""
    return None if t is None else t.data_ptr()


def _count_flash(what, path, segments, kbias, q_offset=None, extra=None):
    """One launch of K1 or K3 (`what`), under its path's and its operands'
    counts: `extra` is K1's carry or K3's delta."""
    _dispatched(what)
    if path == "wgmma":
        launch_counts[what + "_wgmma"] += 1
    if segments is not None or kbias is not None:
        launch_counts[what + "_masked"] += 1
    if q_offset is not None:
        launch_counts[what + "_offset"] += 1
    if extra is not None:
        launch_counts[what + ("_carry" if what == "flash_fwd" else "_delta")] += 1


# ---------------------------------------------------------------------------
# K3: flash-attention backward
# ---------------------------------------------------------------------------


def flash_backward_plain(q, k, v, out, lse, g, causal, scale, segments=None,
                         kbias=None, q_offset=None, delta=None):
    """Plain version of `flash_bwd`: the math of the reference's
    `_flash_backward` (flash_attention.py:1763-1814) on [b, s, h, d] inputs
    against k, v [b, lk, hk, d], with its rounding points: p rounded to the
    input dtype before p^T g, ds rounded before ds k and ds^T q, every
    product summed in float32.  The scores are masked as the forward masked
    them (rows at the absolute positions of `q_offset`), and p = exp(s -
    lse) is recomputed from the forward's lse (on a row with no live key,
    1 on every key, as in the reference's kernel).  `delta` ([b, h, s]
    float32, rowsum(g * out)) is used as given, and `out` then not read.
    dk/dv are summed over each GQA group in float32 and rounded once.
    Returns (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    b, s, h, d = q.shape
    hk, lk = k.shape[2], k.shape[1]
    rep = h // hk
    qt, gt = (x.transpose(1, 2).float() for x in (q, g))  # [b, h, s, d]
    kt = k.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    vt = v.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    if delta is None:
        delta = (gt * out.transpose(1, 2).float()).sum(-1)  # [b, h, s]
    sc = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    q_pos = q_positions(s, q_offset, q.device) if causal else None
    sc = _masked_scores(sc, causal, segments, kbias, q_pos)
    p = torch.exp(sc - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), gt)
    dp = torch.einsum("bhqd,bhkd->bhqk", gt, vt)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kt)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qt)
    dk = dk.reshape(b, hk, rep, lk, d).sum(2)
    dv = dv.reshape(b, hk, rep, lk, d).sum(2)
    return tuple(x.transpose(1, 2).to(dt).contiguous() for x in (dq, dk, dv))


def flash_backward(q, k, v, out, lse, g, causal=True, scale=None,
                   segments=None, kbias=None, q_offset=None, delta=None):
    """K3 wrapper.  q, out, g: [b, s, h, d]; k, v: [b, lk, hk, d] (GQA read
    in place, dk/dv summed over each group in-kernel); lse: [b, h, s]
    float32 from `flash_forward`; `segments`, `kbias` and `q_offset` as the
    forward got them (p is recomputed under the same mask).  `delta` ([b,
    h, s] float32, rowsum(g * out)): given, the kernel's pre-pass is
    skipped and `out` may be None (the ring computes it once for all its
    hops).  The kernel is `flash_path(s, d, dtype)`'s, as for K1: the wgmma
    + TMA kernels for bfloat16 or float16 with d 64 or 128 and at least 128
    rows.
    Returns (dq, dk, dv) shaped and typed like q, k, v."""
    _check_flash(q, k, v)
    _check_masking(q, k, segments, kbias, "flash_bwd")
    _check_ring(q, q_offset, None, None, "flash_bwd")
    _require(segments is None and kbias is None
             or q_offset is None and delta is None,
             "flash_bwd: segments and kbias do not combine with the ring operands")
    b, s, h, d = q.shape
    lk = k.shape[1]
    _require(delta is not None or out is not None,
             "flash_bwd: out is needed without delta")
    _require(g.shape == q.shape and (out is None or out.shape == q.shape),
             "flash_bwd: out and g must be shaped like q")
    _require(g.dtype == q.dtype and (out is None or out.dtype == q.dtype),
             "flash_bwd: out and g must be typed like q")
    _require(lse.shape == (b, h, s) and lse.dtype == torch.float32,
             "flash_bwd: lse must be [b, h, s] float32")
    _require(delta is None or (delta.shape == (b, h, s)
                               and delta.dtype == torch.float32),
             "flash_bwd: delta must be [b, h, s] float32")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    given = [t for t in (q, k, v, out, lse, g, delta) if t is not None]
    if not _on_cuda(given, "flash_bwd"):
        return flash_backward_plain(q, k, v, out, lse, g, causal, scale,
                                    segments, kbias, q_offset, delta)
    _require(all(t.is_contiguous() for t in given),
             "flash_bwd: inputs must be contiguous")
    from ._build import check, lib

    path = flash_path(s, d, q.dtype)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q_offset is not None or delta is not None or lk != s:
        bq = 0 if q_offset is None else _offset_block(q_offset, s)
        scratch = delta if delta is not None else torch.empty(
            (b, h, s), dtype=torch.float32, device=q.device)
        code = lib().ptt_flash_bwd_ring(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out), lse.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            scratch.data_ptr(), _ptr(_contiguous_or_none(q_offset)), b, s, lk,
            h, k.shape[2], d, bq, int(bool(causal)), float(scale),
            _dtype_code(q, "flash_bwd"), _FLASH_PATHS[path],
            int(delta is not None), _stream(q),
        )
        check(code, f"flash_bwd ring ({path})")
        _count_flash("flash_bwd", path, None, None, q_offset, delta)
        _nan.check_written("flash_bwd", (dq, dk, dv))
        return dq, dk, dv
    segments, kbias = _contiguous_or_none(segments), _contiguous_or_none(kbias)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    code = lib().ptt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, s, h, k.shape[2], d,
        int(bool(causal)), float(scale), _dtype_code(q, "flash_bwd"),
        _FLASH_PATHS[path], _ptr(segments), _ptr(kbias), _stream(q),
    )
    check(code, f"flash_bwd ({path})")
    _count_flash("flash_bwd", path, segments, kbias)
    _nan.check_written("flash_bwd", (dq, dk, dv))
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the hand-written backward (the counterpart of the
    reference's `custom_vjp` around `_flash_attention_core`,
    flash_attention.py:1967-2057).  The forward runs `flash_forward` and
    saves (q, k, v, out, lse), never the probabilities; the backward runs
    `flash_backward` under the same segment ids and key bias, which get no
    gradient (the reference's `_flash_bwd_rule` returns None for both).
    Inputs arrive non-contiguous (q and k after RoPE, the output gradient
    from the reshape before o_proj): both kernels take contiguous tensors,
    so the copies are made here."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, segments=None, kbias=None):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale,
                                 segments=segments, kbias=kbias)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.segments, ctx.kbias = segments, kbias
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale,
                                    segments=ctx.segments, kbias=ctx.kbias)
        return dq, dk, dv, None, None, None, None


# ---------------------------------------------------------------------------
# dispatch: the kernels, or the reference's XLA path as plain torch ops
# ---------------------------------------------------------------------------

# Why an attention call did not take K1/K3 (the reference's
# `_FALLBACK_REASONS` that apply here, flash_attention.py:1829-1839), and
# how often since the last reset; `_log_pallas_fallback` (:1857) counts
# the same, and `/metrics` renders them as
# `paddle_flash_fallbacks_total{reason=}`
FALLBACK_REASONS = ("attn_mask not key-padding", "q/k shapes differ",
                    "head_dim > 256")
fallback_counts = dict.fromkeys(FALLBACK_REASONS, 0)


def reset_fallback_counts():
    for reason in fallback_counts:
        fallback_counts[reason] = 0


def key_padding_bias(mask, b, sk):
    """The reference's `_key_padding_bias` (flash_attention.py:1894): an
    additive mask broadcast over the query rows and heads -- shape [mb, 1,
    1, sk] with mb 1 or b -- becomes a [b, sk] float32 per-key bias for the
    kernels; any other mask (or none) gives None."""
    if mask is None or mask.dim() != 4 or mask.shape[1] != 1 or mask.shape[2] != 1:
        return None
    mb = mask.shape[0]
    if mb not in (1, b) or mask.shape[3] != sk:
        return None
    return mask.reshape(mb, sk).float().expand(b, sk).contiguous()


def flash_viable(q, k, mask, kbias):
    """The reference's `_pallas_viable` (flash_attention.py:1939): whether
    an attention call takes K1/K3, and if not, the reason.  A mask that did
    not lower to a key bias, or q and k of different batch, length or head
    width (cross attention, a cache), take the plain path; GQA is fine (the
    kernels read kv heads in place, where the reference repeats them
    first)."""
    if mask is not None and kbias is None:
        return False, "attn_mask not key-padding"
    if (q.shape[0], q.shape[1], q.shape[3]) != (k.shape[0], k.shape[1], k.shape[3]):
        return False, "q/k shapes differ"
    if q.shape[3] > MAX_HEAD_DIM:
        return False, "head_dim > 256"
    return True, None


def attention_plain(q, k, v, mask=None, causal=False, scale=None, segment_ids=None):
    """The reference's XLA path (`_blockwise_attention` and
    `_flash_backward`, flash_attention.py:1703, :1763, reached from :1987)
    as plain torch ops: scores in float32, the causal fence with the
    rectangular offset sk - sq, the additive `mask` (broadcast to [b, h,
    sq, sk]) plus NEG_INF between segments, softmax, p rounded to v's dtype
    before p.v; autograd differentiates it.  q: [b, sq, h, d]; k, v: [b,
    sk, hk, d].  Returns [b, sq, h, d]."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rep = qt.shape[1] // kt.shape[1]
    if rep != 1:
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qt.float(), kt.float()) * scale
    sq, sk = q.shape[1], k.shape[1]  # bottom-right: the last row sees every key
    s = _masked_scores(s, causal, None, None,
                       torch.arange(sq, device=s.device) + (sk - sq))
    if mask is not None:
        s = s + mask.float()
    if segment_ids is not None:
        same = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        s = s + torch.where(same, 0.0, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
    return out.to(q.dtype).transpose(1, 2)


def sdpa(q, k, v, mask=None, causal=False, scale=None, segment_ids=None):
    """Scaled dot-product attention on [b, s, h, d] (the port's
    `sdpa_array`, flash_attention.py:2060; GQA when k and v have fewer
    heads).  `mask`: an additive mask broadcastable to [b, h, sq, sk];
    `segment_ids`: [b, s] ids, a query attends only to keys of its own id.
    Where `flash_viable` holds -- no mask or a key-padding mask ([b or 1,
    1, 1, sk], lowered to a per-key bias), q and k of one shape -- the call
    runs the `flash_fwd` kernel and, when autograd records and an input
    requires grad, `FlashAttention`, so the backward runs `flash_bwd`.
    Other shapes take `attention_plain` under autograd, counted in
    `fallback_counts`: the choice follows the shape, never a failure."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kbias = key_padding_bias(mask, q.shape[0], k.shape[1])
    viable, reason = flash_viable(q, k, mask, kbias)
    if not viable:
        fallback_counts[reason] += 1
        return attention_plain(q, k, v, mask, causal, scale, segment_ids)
    segments = None if segment_ids is None else segment_ids.to(INDEX_DTYPE)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, segments, kbias)
    return flash_forward(q, k, v, causal=causal, scale=scale, segments=segments,
                         kbias=kbias)[0]


def cu_seqlens_to_segment_ids(cu_seqlens, total_len):
    """[n + 1] cumulative lengths -> [total_len] int32 segment ids (the
    reference's, flash_attention.py:2082): position i gets the index of the
    sequence it lies in; a padding tail past cu[-1] gets n."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int64)
    pos = torch.arange(total_len, dtype=torch.int64, device=cu.device)
    return torch.searchsorted(cu[1:].contiguous(), pos, right=True).to(INDEX_DTYPE)


def flash_attn_varlen_array(q, k, v, cu_seqlens, causal=True, scale=None):
    """Packed varlen attention (the reference's `flash_attn_varlen_array`,
    flash_attention.py:2090): q, k, v [total, h, d] hold the sequences one
    after another, `cu_seqlens` [n + 1] their cumulative lengths; each
    sequence attends only to itself, through the segment ids of
    `cu_seqlens_to_segment_ids`.  Returns [total, h, d]."""
    seg = cu_seqlens_to_segment_ids(cu_seqlens, q.shape[0]).to(q.device)[None]
    return sdpa(q[None], k[None], v[None], None, causal, scale, segment_ids=seg)[0]


def flash_attn_varlen(query, key, value, cu_seqlens_q, cu_seqlens_k=None,
                      causal=True, scale=None):
    """The varlen entry (the reference's `flash_attn_varlen`,
    flash_attention.py:2143): self-attention layouts only, so a
    `cu_seqlens_k` other than `cu_seqlens_q` raises NotImplementedError,
    and so does a distinct one inside a `jit.to_static` step, where its
    values cannot be read (the reference's refusal, :2160)."""
    if cu_seqlens_k is not None and cu_seqlens_k is not cu_seqlens_q:
        from ..framework.core import active_static_call

        if active_static_call() is not None:
            raise NotImplementedError(
                "flash_attn_varlen: cu_seqlens_k equality cannot be verified "
                "under @to_static tracing; pass cu_seqlens_k as the same tensor "
                "object as cu_seqlens_q (or omit it) — only self-attention "
                "layouts are supported")
        cq, ck = torch.as_tensor(cu_seqlens_q), torch.as_tensor(cu_seqlens_k)
        if cq.shape != ck.shape or not bool((cq.cpu() == ck.cpu()).all()):
            raise NotImplementedError(
                "flash_attn_varlen: distinct cu_seqlens_k is not supported "
                "(self-attention layouts only); pass equal cu_seqlens"
            )
    return flash_attn_varlen_array(query, key, value, cu_seqlens_q, causal, scale)


# ---------------------------------------------------------------------------
# K2: paged decode
# ---------------------------------------------------------------------------


def paged_gather_kv(arena, tables, max_len):
    """Gather a paged arena [num_pages, page_size, kv_h, d] back into dense
    per-sequence buffers [b, max_len, kv_h, d] through the page tables
    ([b, P] int32) -- the reference's oracle (flash_attention.py:800)."""
    b = tables.shape[0]
    g = arena[tables.long()]  # [b, P, page_size, kv_h, d]
    return g.reshape(b, -1, arena.shape[2], arena.shape[3])[:, :max_len]


def capturing():
    """True while this thread captures a CUDA graph (False without CUDA)."""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def _require_device_operand(x, device, what):
    """Inside a capture a host scalar would be uploaded from pageable memory
    (which a capture refuses) or baked into the graph: every caller there
    passes a tensor already on the kernel's device."""
    if capturing() and not (isinstance(x, torch.Tensor) and x.device == device):
        raise ValueError(
            f"{what}: got a host value ({type(x).__name__}) under CUDA graph "
            f"capture; pass a tensor on {device}"
        )


def _pos_vector(pos, b, device, what):
    _require_device_operand(pos, device, what)
    pos = torch.as_tensor(pos, dtype=INDEX_DTYPE, device=device)
    return pos.reshape(-1).expand(b) if pos.numel() == 1 else pos.reshape(b)


def decode_attention_plain(q, k, v, pos, scale=None):
    """Cached attention against dense buffers: the dense math of the
    reference's `decode_attention_array` (flash_attention.py:771-787), and
    the plain version of `dense_decode`.  No serving or generate path
    reaches it on a CUDA tensor (it upcasts the whole cache to float32):
    `decode_attention` runs K6 or K2.  q: [b, sq, h, d]; k, v: [b, L,
    kv_h, d]; pos: int, a one-element or [b] int32 tensor.  Row i of slot s
    attends cache rows j <= pos[s] + i; scores and softmax in float32, p
    rounded to v's dtype before p.v.  Returns [b, sq, h, d]."""
    b, sq, h, d = q.shape
    L, hk = k.shape[1], k.shape[2]
    rep = h // hk
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    q5 = q.permute(0, 2, 1, 3).reshape(b, hk, rep, sq, d)
    kt = k.permute(0, 2, 1, 3)  # [b, hk, L, d] -- never repeated
    vt = v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5.float(), kt.float()) * scale
    p_ = _pos_vector(pos, b, q.device, "decode_attention")
    q_ids = p_.view(b, 1, 1, 1, 1) + torch.arange(sq, device=q.device).view(sq, 1)
    k_ids = torch.arange(L, device=q.device).view(1, L)
    s = torch.where(q_ids >= k_ids, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vt.float())
    return out.to(q.dtype).reshape(b, h, sq, d).permute(0, 2, 1, 3)


# ---------------------------------------------------------------------------
# K6: cached attention against a dense static cache
# ---------------------------------------------------------------------------


def takes_dense_decode(sq, d, L, per_row_pos):
    """The reference's dispatch rule (`decode_attention_array`,
    flash_attention.py:738-744): its Pallas kernel, and so `dense_decode`
    here, runs for a scalar position, at least 64 query rows, head_dim <=
    256 and a cache length that is a multiple of 128; everything else takes
    the reference's dense math, which `decode_attention` runs as K2 over
    the cache's page view.  On the serving paths that is the prefill of
    lock-step generation and nothing else: single-token and per-slot
    decode steps take K2."""
    return not per_row_pos and sq >= 64 and d <= MAX_HEAD_DIM and L % 128 == 0


def _check_dense_decode(q, k, v, pos, what):
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             f"{what}: q must be [b, sq, h, d], k and v [b, L, kv_h, d]")
    b, sq, h, d = q.shape
    _require(k.shape == v.shape, f"{what}: k and v shapes differ")
    _require(k.shape[0] == b and k.shape[3] == d,
             f"{what}: q {tuple(q.shape)} and cache {tuple(k.shape)} must share "
             "batch and head_dim")
    _require(h % k.shape[2] == 0,
             f"{what}: {h} q heads not a multiple of {k.shape[2]} kv heads")
    _require(d <= MAX_HEAD_DIM, f"{what}: head_dim {d} > {MAX_HEAD_DIM}")
    _require(q.dtype == k.dtype == v.dtype, f"{what}: q, k, v dtypes differ")
    _require(pos.numel() == 1 and pos.dtype == INDEX_DTYPE,
             f"{what}: pos must be one int32")
    _dtype_code(q, what)


def dense_decode(q, k, v, pos, scale=None):
    """K6 wrapper.  q: [b, sq, h, d] (any sq: the kernel masks the ragged
    tile itself); k, v: [b, L, kv_h, d] cache buffers with h % kv_h == 0
    (GQA reads kv head h // rep in place, one launch for every head); pos:
    the cache position of q row 0, a one-element int32 tensor on q's device
    (an int is uploaded) that the kernel reads itself, so launching never
    waits for the device.  Row i attends cache rows j <= pos + i.  Returns
    [b, sq, h, d]."""
    what = "dense_decode"
    _require_device_operand(pos, q.device, what)
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor(int(pos), dtype=INDEX_DTYPE, device=q.device)
    _check_dense_decode(q, k, v, pos, what)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda((q, k, v, pos), what):
        return decode_attention_plain(q, k, v, pos, scale)
    _require(k.is_contiguous() and v.is_contiguous(),
             f"{what}: cache buffers must be contiguous")
    from ._build import check, lib

    q, pos = q.contiguous(), pos.contiguous()
    b, sq, h, d = q.shape
    path = flash_path(sq, d, q.dtype)
    out = torch.empty_like(q)
    code = lib().ptt_dense_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        pos.data_ptr(), b, sq, h, k.shape[2], d, k.shape[1], float(scale),
        _dtype_code(q, what), _FLASH_PATHS[path], _stream(q),
    )
    check(code, f"{what} ({path})")
    _dispatched(what)
    if path == "wgmma":
        launch_counts[what + "_wgmma"] += 1
    _nan.check_written(what, (out,))
    return out


def dense_page_size(L):
    """Rows per page of a dense cache's page view: DENSE_PAGE_ROWS where
    the cache length L is a multiple of it, else L (one page per
    sequence)."""
    return DENSE_PAGE_ROWS if L % DENSE_PAGE_ROWS == 0 else L


def dense_page_table(b, L, device):
    """The page table of the page view of a dense [b, L, kv_h, d] cache:
    [b, L / ps] int32 with t[s, j] = s * L / ps + j, so sequence s's pages
    are its own rows, in order.  Every entry names a page of the view, so
    it needs no `check_table_bounds`."""
    n = L // dense_page_size(L)
    return torch.arange(b * n, dtype=INDEX_DTYPE, device=device).reshape(b, n)


def dense_page_view(cache):
    """A dense [b, L, kv_h, d] cache as a paged arena [b * L / ps, ps, kv_h,
    d] over the same memory (a view; a copy only of a non-contiguous CPU
    tensor, which the tests pass)."""
    b, L, hk, d = cache.shape
    ps = dense_page_size(L)
    return cache.reshape(b * L // ps, ps, hk, d)


def decode_attention(q, k, v, pos, scale=None, table=None):
    """Cached attention against dense buffers, the reference's dispatcher
    `decode_attention_array` (flash_attention.py:698).  q: [b, sq, h, d];
    k, v: [b, L, kv_h, d]; pos: a scalar (an int or a 0-d int32 tensor:
    the lock-step position) or a [b] int32 tensor (per-slot positions).
    `dense_decode` (K6) where `takes_dense_decode` holds, the reference's
    rule; everything else -- decode steps, short prefills, per-slot
    positions, where the reference runs its XLA math -- goes through
    `paged_decode_fused` (K2) over the caches' page view
    (`dense_page_view`) under `table`, the cache's `dense_page_table` (made
    here when None), with max_len L: key j is seen by row i iff j <= pos +
    i, as in the dense math.  On a CUDA tensor the kernel runs or raises;
    on the CPU both wrappers run their plain versions.  A head wider than
    MAX_HEAD_DIM, which no kernel takes and no model of the port has, runs
    the dense math itself.  Returns [b, sq, h, d]."""
    per_row = getattr(pos, "ndim", 0) == 1
    b, L = k.shape[0], k.shape[1]
    if takes_dense_decode(q.shape[1], q.shape[3], L, per_row):
        return dense_decode(q, k, v, pos, scale)
    if q.shape[3] > MAX_HEAD_DIM:
        return decode_attention_plain(q, k, v, pos, scale)
    if k.is_cuda:
        _require(k.is_contiguous() and v.is_contiguous(),
                 "decode_attention: cache buffers must be contiguous")
    if table is None:
        table = dense_page_table(b, L, k.device)
    return paged_decode_fused(q, dense_page_view(k), dense_page_view(v), table,
                              pos, L, scale)


def _check_paged(q, arena_k, arena_v, tables, pos, what):
    _require(q.dim() == 4, f"{what}: q must be [b, sq, h, d]")
    b, sq, h, d = q.shape
    _require(arena_k.dim() == 4 and arena_k.shape == arena_v.shape,
             f"{what}: arenas must be [pages, page_size, kv_h, d]")
    _require(arena_k.shape[3] == d, f"{what}: head_dim differs")
    hk = arena_k.shape[2]
    _require(h % hk == 0, f"{what}: {h} q heads not a multiple of {hk} kv heads")
    _require(d <= MAX_HEAD_DIM, f"{what}: head_dim {d} > {MAX_HEAD_DIM}")
    _require(tables.dim() == 2 and tables.shape[0] == b,
             f"{what}: tables must be [b, P]")
    _require(tables.dtype == INDEX_DTYPE and pos.dtype == INDEX_DTYPE,
             f"{what}: tables and pos must be int32")
    _require(pos.shape == (b,), f"{what}: pos must be [b]")
    _dtype_code(q, what)


def _check_scales(arena_k, k_scale, v_scale):
    want = (*arena_k.shape[:3], 1)
    _require(arena_k.dtype == torch.int8,
             "paged_decode_fused_q8: arenas must be int8")
    _require(tuple(k_scale.shape) == want and tuple(v_scale.shape) == want,
             f"paged_decode_fused_q8: scales must be {list(want)}")
    _require(k_scale.dtype == v_scale.dtype == torch.float32,
             "paged_decode_fused_q8: scales must be float32")


def _paged_attention(q, k, v, pos, max_len, scale):
    """The masked attention of the paged kernels on gathered per-sequence
    K/V [b, W, kv_h, d] (W = table width in rows): key jid is seen by
    window row w iff jid <= pos + w and jid < max_len; scores and softmax
    in float32, p cast to v's dtype before p.v (bf16 for K2, float32 for
    K4's dequantized V).  Returns [b, sq, h, d] in q's dtype."""
    b, sq, h, d = q.shape
    width, hk = k.shape[1], k.shape[2]
    q5 = q.permute(0, 2, 1, 3).reshape(b, hk, h // hk, sq, d)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5.float(), kt.float()) * scale
    w = torch.arange(sq, device=q.device).view(sq, 1)
    jid = torch.arange(width, device=q.device).view(1, width)
    seen = (jid <= pos.view(b, 1, 1, 1, 1) + w) & (jid < max_len)
    p = torch.softmax(torch.where(seen, s, NEG_INF), dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vt.float())
    return out.to(q.dtype).reshape(b, h, sq, d).permute(0, 2, 1, 3)


def paged_decode_plain(q, arena_k, arena_v, tables, pos, max_len, scale):
    """Plain version of `paged_decode_fused`: gather the whole table width,
    then `_paged_attention`.  Returns [b, sq, h, d]."""
    width = tables.shape[1] * arena_k.shape[1]
    k = paged_gather_kv(arena_k, tables, width)
    v = paged_gather_kv(arena_v, tables, width)
    return _paged_attention(q, k, v, pos, max_len, scale)


def _dequant_gather(arena, scales, tables, width):
    """int8 rows gathered through the tables times their gathered float32
    scales: the reference's `int8 * scale` dequant, [b, width, kv_h, d]."""
    return (paged_gather_kv(arena, tables, width).float()
            * paged_gather_kv(scales, tables, width))


def paged_decode_q8_plain(q, arena_k, arena_v, k_scale, v_scale, tables, pos,
                          max_len, scale):
    """Plain version of `paged_decode_fused_q8`: dequantize the gathered
    table width, then `_paged_attention` in float32 (p is not rounded: V
    is float32).  Returns [b, sq, h, d] in q's dtype."""
    width = tables.shape[1] * arena_k.shape[1]
    k = _dequant_gather(arena_k, k_scale, tables, width)
    v = _dequant_gather(arena_v, v_scale, tables, width)
    return _paged_attention(q, k, v, pos, max_len, scale)


def _count(code, what, path, *outs):
    """Raise on a failed paged launch, else count it (and its path) and hand
    what it wrote, `outs`, to FLAGS_check_nan_inf's check."""
    from ._build import check

    check(code, f"{what} ({path})")
    _dispatched(what)
    if path != "fma":
        launch_counts[f"{what}_{path}"] += 1
    _nan.check_written(what, outs)


def _paged_workspace(q, hk, splits, cp=1):
    """float32 workspace [b, hk, cp * splits, rows, d + 2] where the cp
    shards' and splits' partials merge (empty for one of them)."""
    b, sq, h, d = q.shape
    n = cp * splits
    n = b * hk * n * (h // hk) * sq * (d + 2) if n > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=q.device)


def paged_decode_fused(q, arena_k, arena_v, tables, pos, max_len, scale=None):
    """K2 wrapper.  q: [b, sq, h, d] (any GQA group x window: the kernel
    tiles its rows by 64); arena_k/v: [pages, page_size, kv_h, d];
    tables: [b, P] int32 page ids (each must name a real page: the kernel
    indexes the arena by the raw value, see `check_table_bounds`); pos: [b]
    int32.  Returns [b, sq, h, d]."""
    what = "paged_decode_fused"
    pos = _pos_vector(pos, q.shape[0], q.device, what)
    _check_paged(q, arena_k, arena_v, tables, pos, what)
    _require(q.dtype == arena_k.dtype == arena_v.dtype,
             f"{what}: q and arena dtypes differ")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda((q, arena_k, arena_v, tables, pos), what):
        return paged_decode_plain(q, arena_k, arena_v, tables, pos, max_len, scale)
    from ._build import lib

    q, tables, pos = q.contiguous(), tables.contiguous(), pos.contiguous()
    _require(arena_k.is_contiguous() and arena_v.is_contiguous(),
             f"{what}: arenas must be contiguous")
    b, sq, h, d = q.shape
    hk, ps, P = arena_k.shape[2], arena_k.shape[1], tables.shape[1]
    path = paged_path((h // hk) * sq, d, q.dtype)
    out = torch.empty_like(q)
    splits = paged_splits(path, b, hk, (h // hk) * sq, P, ps)
    ws = _paged_workspace(q, hk, splits)
    code = lib().ptt_paged_decode(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr() if splits > 1 else None, splits, _PAGED_PATHS[path], b,
        sq, h, hk, d, ps, P, int(max_len), float(scale), _dtype_code(q, what),
        _stream(q),
    )
    _count(code, what, path, out)
    return out


def paged_decode_fused_q8(q, arena_k, arena_v, k_scale, v_scale, tables, pos,
                          max_len, scale=None):
    """K4 wrapper: `paged_decode_fused` over an int8 arena.  arena_k/v:
    [pages, page_size, kv_h, d] int8; k_scale/v_scale: [pages, page_size,
    kv_h, 1] float32, addressed by the same tables; q float32, bfloat16 or
    float16.
    Returns [b, sq, h, d] in q's dtype."""
    what = "paged_decode_fused_q8"
    pos = _pos_vector(pos, q.shape[0], q.device, what)
    _check_paged(q, arena_k, arena_v, tables, pos, what)
    _check_scales(arena_k, k_scale, v_scale)
    _require(arena_v.dtype == torch.int8, f"{what}: arenas must be int8")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda((q, arena_k, arena_v, k_scale, v_scale, tables, pos), what):
        return paged_decode_q8_plain(q, arena_k, arena_v, k_scale, v_scale,
                                     tables, pos, max_len, scale)
    from ._build import lib

    q, tables, pos = q.contiguous(), tables.contiguous(), pos.contiguous()
    _require(all(t.is_contiguous() for t in (arena_k, arena_v, k_scale, v_scale)),
             f"{what}: arenas and scales must be contiguous")
    b, sq, h, d = q.shape
    hk, ps, P = arena_k.shape[2], arena_k.shape[1], tables.shape[1]
    path = paged_path((h // hk) * sq, d, q.dtype)
    out = torch.empty_like(q)
    splits = paged_splits(path, b, hk, (h // hk) * sq, P, ps)
    ws = _paged_workspace(q, hk, splits)
    code = lib().ptt_paged_decode_q8(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), tables.data_ptr(),
        pos.data_ptr(), out.data_ptr(), ws.data_ptr() if splits > 1 else None,
        splits, _PAGED_PATHS[path], b, sq, h, hk, d, ps, P, int(max_len),
        float(scale), _dtype_code(q, what), _stream(q),
    )
    _count(code, what, path, out)
    return out


# ---------------------------------------------------------------------------
# K2 and K4 per head shard, for tensor-parallel decode
# ---------------------------------------------------------------------------


def _per_shard(what, launch, qs, *shards):
    """One `launch` per rank over rank r's operands; counts the launches of
    ranks on the card under `what` (a subset of K2's, K4's or K5's
    count)."""
    if len({len(qs), *(len(x) for x in shards)}) != 1:
        raise ValueError(f"{what}: one q, arena (and scale) shard per rank")
    outs = []
    for q, *ops in zip(qs, *shards):
        outs.append(launch(q, *ops))
        if q.device.type == "cuda":
            launch_counts[what] += 1
    return outs


def paged_decode_tp(qs, arenas_k, arenas_v, tables, pos, max_len, scale=None):
    """Tensor-parallel paged attention (the reference's
    `_fused_paged_decode_tp`, flash_attention.py:1116): one K2 launch
    (`paged_decode_fused`) per rank, over the rank's q heads qs[r] [b, sq,
    h/N, d] and its arena shard arenas_k[r] / arenas_v[r] [pages, page_size,
    kv_h/N, d]; the ranks share tables [b, P] and pos [b].  Rank r's q heads
    are the rep-block of its kv heads (q head hk*rep + j belongs to kv head
    hk, so contiguous head ranges keep each pair on one rank), and each
    launch is K2 over a model of h/N heads.  On CPU tensors each rank runs
    the plain version, `paged_decode_plain`.  Returns the ranks' outputs
    [b, sq, h/N, d]."""
    return _per_shard(
        "paged_decode_tp",
        lambda q, k, v: paged_decode_fused(q, k, v, tables, pos, max_len, scale),
        qs, arenas_k, arenas_v)


def paged_decode_q8_tp(qs, arenas_k, arenas_v, k_scales, v_scales, tables, pos,
                       max_len, scale=None):
    """`paged_decode_tp` over int8 pages (the reference's
    `_fused_paged_decode_quant_tp`, flash_attention.py:1148): one K4 launch
    (`paged_decode_fused_q8`) per rank; the scale arenas shard with their kv
    heads (k_scales[r] [pages, page_size, kv_h/N, 1]).  On CPU tensors each
    rank runs `paged_decode_q8_plain`."""
    return _per_shard(
        "paged_decode_tp_q8",
        lambda q, k, v, ks, vs: paged_decode_fused_q8(q, k, v, ks, vs, tables, pos,
                                                      max_len, scale),
        qs, arenas_k, arenas_v, k_scales, v_scales)


# ---------------------------------------------------------------------------
# K5: paged decode partials, for context-parallel decode
# ---------------------------------------------------------------------------


def cp_softmax_combine(acc, m, l, eps=1e-30):
    """Merge per-shard online-softmax partials into finished attention (the
    reference's `cp_softmax_combine`, flash_attention.py:1386).  acc [cp,
    ..., d], m and l [cp, ..., 1], float32, over DISJOINT key sets stacked
    on axis 0:

        m* = max_s m_s
        out = sum_s acc_s e^(m_s - m*) / max(sum_s l_s e^(m_s - m*), eps)

    A shard that saw no key of a row (m_s = -1e30 or -inf) drops out, since
    e^(m_s - m*) = 0 for the finite m* that shard 0, which holds token 0,
    guarantees.  On one card the shards' partials are merged here with
    torch ops; across cards the sums become all-reduces."""
    m_star = m.amax(dim=0)
    corr = torch.exp(m - m_star[None])
    l_star = (l * corr).sum(dim=0)
    acc_star = (acc * corr).sum(dim=0)
    return acc_star / torch.clamp(l_star, min=eps)


def cp_local_tables(tables, cp, per_shard, page_size):
    """Per cp shard s, (local table [b, P/cp] int32, page_base [P/cp]
    int32) from the global page table `tables` ([b, P] int32), as the
    reference derives them (flash_attention.py:1451-1457).  Sequence page k
    lives on shard k % cp, so shard s's columns are k = s + cp*j; a global
    id g in its range becomes the local row g - s*per_shard, and anything
    else (unmapped columns, scratch) local row 0, the shard's own scratch
    page, which the position fence masks.  page_base[j] = (s + cp*j) *
    page_size is the first token position of local column j."""
    P = tables.shape[1]
    if P % cp:
        raise ValueError(f"page table width {P} does not divide into cp={cp} shards")
    out = []
    for s in range(cp):
        cols = s + cp * torch.arange(P // cp, dtype=INDEX_DTYPE, device=tables.device)
        loc = tables[:, s::cp] - s * per_shard
        loc = torch.where((loc > 0) & (loc < per_shard), loc, 0).to(INDEX_DTYPE)
        out.append((loc.contiguous(), cols * page_size))
    return out


def paged_decode_partials_plain(q, arena_k, arena_v, tables, page_base, pos,
                                max_len, scale, k_scale=None, v_scale=None):
    """Plain version of `paged_decode_partials`: gather the shard's pages
    through the local table; key jid = page_base[col] + lane is seen by
    row r (window offset w = r % sq) iff jid <= pos + w and jid < max_len.
    Returns float32 acc [b, hk, rep*sq, d], m and l [b, hk, rep*sq, 1]: m
    the row max of the seen scores (-1e30 for a row that sees none), l =
    sum e^(s - m), acc = sum e^(s - m) v over the seen keys, p cast to v's
    dtype before p.v (bf16 pages; int8 pages dequantize to float32)."""
    b, sq, h, d = q.shape
    ps, hk = arena_k.shape[1], arena_k.shape[2]
    width = tables.shape[1] * ps
    if k_scale is not None:
        k = _dequant_gather(arena_k, k_scale, tables, width)
        v = _dequant_gather(arena_v, v_scale, tables, width)
    else:
        k = paged_gather_kv(arena_k, tables, width)
        v = paged_gather_kv(arena_v, tables, width)
    R = (h // hk) * sq
    q4 = q.permute(0, 2, 1, 3).reshape(b, hk, R, d)  # row r: member r // sq
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrd,bgkd->bgrk", q4.float(), kt.float()) * scale
    lane = torch.arange(ps, device=q.device)
    jid = (page_base.long()[:, None] + lane).reshape(1, width)
    w = (torch.arange(R, device=q.device) % sq).view(R, 1)
    seen = (jid <= pos.view(b, 1, 1, 1) + w) & (jid < max_len)
    s = torch.where(seen, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(seen, torch.exp(s - m), 0.0)
    acc = torch.einsum("bgrk,bgkd->bgrd", p.to(v.dtype).float(), vt.float())
    return acc, m, p.sum(dim=-1, keepdim=True)


def paged_decode_partials(q, arena_k, arena_v, tables, page_base, pos,
                          max_len, scale=None, k_scale=None, v_scale=None):
    """K5 wrapper: one cp shard's page walk.  q: [b, sq, h, d]; arena_k/v:
    the shard's pages [per_shard, page_size, kv_h, d] (a contiguous slice
    of the global arena), int8 with float32 k_scale/v_scale [per_shard,
    page_size, kv_h, 1] for the int8 variant; tables: [b, P_l] int32 LOCAL
    page ids (each must name a page of the shard, see `cp_local_tables`);
    page_base: [P_l] int32; pos: [b] int32.  Returns float32 (acc [b, hk,
    rep*sq, d], m, l [b, hk, rep*sq, 1]), un-normalised.  A row that sees
    no key has m = -1e30; its l and acc are whatever the masked scores gave
    and must not be read without the combine's e^(m - m*)."""
    quant = k_scale is not None
    what = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
    pos = _pos_vector(pos, q.shape[0], q.device, what)
    _check_paged(q, arena_k, arena_v, tables, pos, what)
    _require(page_base.shape == (tables.shape[1],) and page_base.dtype == INDEX_DTYPE,
             f"{what}: page_base must be [P] int32")
    if quant:
        _check_scales(arena_k, k_scale, v_scale)
        _require(arena_v.dtype == torch.int8, f"{what}: arenas must be int8")
    else:
        _require(q.dtype == arena_k.dtype == arena_v.dtype,
                 f"{what}: q and arena dtypes differ")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scales = (k_scale, v_scale) if quant else ()
    if not _on_cuda((q, arena_k, arena_v, *scales, tables, page_base, pos), what):
        return paged_decode_partials_plain(q, arena_k, arena_v, tables, page_base,
                                           pos, max_len, scale, k_scale, v_scale)
    from ._build import lib

    q, tables = q.contiguous(), tables.contiguous()
    page_base, pos = page_base.contiguous(), pos.contiguous()
    _require(all(t.is_contiguous() for t in (arena_k, arena_v, *scales)),
             f"{what}: arenas and scales must be contiguous")
    b, sq, h, d = q.shape
    hk, ps, P = arena_k.shape[2], arena_k.shape[1], tables.shape[1]
    R = (h // hk) * sq
    acc = torch.empty((b, hk, R, d), dtype=torch.float32, device=q.device)
    m = torch.empty((b, hk, R, 1), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    path = paged_path(R, d, q.dtype)
    splits = paged_splits(path, b, hk, R, P, ps)
    ws = _paged_workspace(q, hk, splits)
    ptrs = [q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr()]
    ptrs += [t.data_ptr() for t in scales]
    ptrs += [tables.data_ptr(), page_base.data_ptr(), pos.data_ptr(),
             acc.data_ptr(), m.data_ptr(), l.data_ptr(),
             ws.data_ptr() if splits > 1 else None]
    fn = (lib().ptt_paged_decode_partials_q8 if quant
          else lib().ptt_paged_decode_partials)
    code = fn(*ptrs, splits, _PAGED_PATHS[path], b, sq, h, hk, d, ps, P,
              int(max_len), float(scale), _dtype_code(q, what), _stream(q))
    _count(code, what, path, acc, m, l)
    return acc, m, l


def cp_stacked_tables(tables, cp, per_shard, page_size):
    """`cp_local_tables` stacked for the one-launch K5: (local tables [cp,
    b, P/cp] int32, page_base [cp, P/cp] int32); shard s's are [s]."""
    local = cp_local_tables(tables, cp, per_shard, page_size)
    return (torch.stack([loc for loc, _ in local]).contiguous(),
            torch.stack([base for _, base in local]).contiguous())


def paged_decode_cp(q, arena_k, arena_v, tables, pos, max_len, cp, scale=None,
                    k_scale=None, v_scale=None, local=None):
    """Context-parallel paged attention (the reference's
    `_fused_paged_decode_cp_impl`, flash_attention.py:1411): the arena's
    page axis splits into `cp` equal shards, shard s owning global pages
    [s*per_shard, (s+1)*per_shard) with its scratch page first; `local` is
    `cp_stacked_tables` of `tables` (derived here when None).  On the card
    one launch walks every shard (grid axis shard x split, each block over
    its shard's slice of the arena, the scale arenas likewise) and the
    split combine merges all shards' partials into the output in q's dtype:
    `ptt_paged_decode_cp`.  On the CPU each shard runs
    `paged_decode_partials` over the view arena[s*per_shard:(s+1)*per_shard]
    and `cp_softmax_combine` merges them, as the reference does.  tables:
    [b, P] GLOBAL page ids in the round-robin layout (sequence page k on
    shard k % cp).  Returns [b, sq, h, d]."""
    num_pages, ps = arena_k.shape[0], arena_k.shape[1]
    if num_pages % cp or tables.shape[1] % cp:
        raise ValueError(
            f"context-parallel paged attention needs the pool ({num_pages} "
            f"pages) and the table width ({tables.shape[1]}) to divide into "
            f"cp={cp} shards"
        )
    per_shard = num_pages // cp
    if local is None:
        local = cp_stacked_tables(tables, cp, per_shard, ps)
    loc, base = local
    pos = _pos_vector(pos, q.shape[0], q.device, "paged_decode_cp")
    quant = k_scale is not None
    scales = (k_scale, v_scale) if quant else ()
    what = "paged_decode_fused_cp_q8" if quant else "paged_decode_fused_cp"
    b, sq, h, d = q.shape
    if not _on_cuda((q, arena_k, arena_v, *scales, loc, base, pos), what):
        parts = []
        for s in range(cp):
            sl = slice(s * per_shard, (s + 1) * per_shard)
            sc = (k_scale[sl], v_scale[sl]) if quant else (None, None)
            parts.append(paged_decode_partials(q, arena_k[sl], arena_v[sl], loc[s],
                                               base[s], pos, max_len, scale, *sc))
        acc, m, l = (torch.stack(x) for x in zip(*parts))
        out = cp_softmax_combine(acc, m, l)  # [b, hk, rep*sq, d]
        return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)
    _check_paged(q, arena_k, arena_v, loc[0], pos, what)
    _require(loc.shape[0] == cp and base.shape == (cp, loc.shape[2])
             and base.dtype == INDEX_DTYPE,
             f"{what}: local tables must be [cp, b, P] and page_base [cp, P] int32")
    if quant:
        _check_scales(arena_k, k_scale, v_scale)
        _require(arena_v.dtype == torch.int8, f"{what}: arenas must be int8")
    else:
        _require(q.dtype == arena_k.dtype == arena_v.dtype,
                 f"{what}: q and arena dtypes differ")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    from ._build import lib

    q, loc, base, pos = q.contiguous(), loc.contiguous(), base.contiguous(), pos.contiguous()
    _require(all(t.is_contiguous() for t in (arena_k, arena_v, *scales)),
             f"{what}: arenas and scales must be contiguous")
    hk, P = arena_k.shape[2], loc.shape[2]
    rows = (h // hk) * sq
    path = paged_path(rows, d, q.dtype)
    splits = paged_splits(path, b, hk, rows, P, ps, cp)
    ws = _paged_workspace(q, hk, splits, cp)
    out = torch.empty_like(q)
    ptrs = [q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr()]
    ptrs += [t.data_ptr() for t in scales]
    ptrs += [loc.data_ptr(), base.data_ptr(), pos.data_ptr(), out.data_ptr(),
             ws.data_ptr()]
    fn = lib().ptt_paged_decode_cp_q8 if quant else lib().ptt_paged_decode_cp
    code = fn(*ptrs, cp, per_shard, splits, _PAGED_PATHS[path], b, sq, h, hk, d,
              ps, P, int(max_len), float(scale), _dtype_code(q, what), _stream(q))
    _count(code, what, path, out)
    return out


def paged_decode_cp_tp(qs, arenas_k, arenas_v, tables, pos, max_len, cp,
                       scale=None, k_scales=None, v_scales=None, local=None):
    """Tensor x context parallel paged attention (the reference's
    `_fused_paged_decode_cp_impl` under a ('cp', 'mp') mesh,
    flash_attention.py:1411-1496): one `paged_decode_cp` launch (K5, every
    cp shard of the rank's arena in one launch, then the split combine)
    per rank, over the rank's q heads qs[r] [b, sq, h/N, d] and its arena
    shard arenas_k[r] / arenas_v[r] [pages, page_size, kv_h/N, d], whose
    page axis splits into the cp shards exactly as a whole arena's does
    (int8 arenas with their scale shards k_scales[r] / v_scales[r]).  The
    ranks share the global tables [b, P], pos [b] and one `local`
    (`cp_stacked_tables` of tables, derived here when None): page ids and
    shard ranges are the same on every rank.

    The reference computes (acc, m, l) per (cp shard, mp rank) and merges
    them over cp with a pmax and two psums; a kv head's rows never meet
    another head's, so merging rank r's cp partials inside rank r's launch
    is the same function, head for head: the output of rank r is the
    reference's output for q heads [r*h/N, (r+1)*h/N).  On CPU tensors
    each rank runs `paged_decode_cp`'s plain path (`paged_decode_partials`
    per shard, `cp_softmax_combine`).  Returns the ranks' outputs [b, sq,
    h/N, d]."""
    quant = k_scales is not None
    if quant != (v_scales is not None):
        raise ValueError("k_scales and v_scales must be given together")
    if local is None:
        per_shard = arenas_k[0].shape[0] // cp
        local = cp_stacked_tables(tables, cp, per_shard, arenas_k[0].shape[1])
    if quant:
        return _per_shard(
            "paged_decode_cp_tp_q8",
            lambda q, k, v, ks, vs: paged_decode_cp(q, k, v, tables, pos, max_len, cp,
                                                    scale, ks, vs, local),
            qs, arenas_k, arenas_v, k_scales, v_scales)
    return _per_shard(
        "paged_decode_cp_tp",
        lambda q, k, v: paged_decode_cp(q, k, v, tables, pos, max_len, cp, scale,
                                        local=local),
        qs, arenas_k, arenas_v)


def paged_decode_attention(q, arena_k, arena_v, tables, pos, max_len,
                           scale=None, kernel="auto", k_scale=None,
                           v_scale=None, cp=1, local=None):
    """Paged-decode attention dispatcher (the reference's
    `paged_decode_attention_array`, flash_attention.py:1553).  "fused" runs
    `paged_decode_fused`, or `paged_decode_fused_q8` when k_scale/v_scale
    are given (an int8 arena); each raises on a shape it does not take.
    With cp > 1 it runs `paged_decode_cp` (K5, every shard in one launch
    on the card; `local` its precomputed `cp_stacked_tables`), and a pool or
    table width
    that does not divide by cp raises ValueError (the reference falls back
    to the gather there; the port has no silent fallback).  "auto", the
    reference flag's default, is an alias of "fused" because the port has
    no silent fallback to the oracle.  "gather" runs the explicit oracle
    over the global arena: `paged_gather_kv` then the dense
    `decode_attention`, dequantizing first under int8 (q in float32, cast
    back at the end)."""
    if kernel not in ("auto", "fused", "gather"):
        raise ValueError(
            f"paged decode kernel must be auto|fused|gather, got {kernel!r}"
        )
    quant = k_scale is not None
    if quant != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be given together")
    if kernel != "gather":
        if cp > 1:
            return paged_decode_cp(q, arena_k, arena_v, tables, pos, max_len, cp,
                                   scale, k_scale, v_scale, local)
        if quant:
            return paged_decode_fused_q8(q, arena_k, arena_v, k_scale, v_scale,
                                         tables, pos, max_len, scale)
        return paged_decode_fused(q, arena_k, arena_v, tables, pos, max_len, scale)
    if quant:
        k = _dequant_gather(arena_k, k_scale, tables, max_len)
        v = _dequant_gather(arena_v, v_scale, tables, max_len)
        return decode_attention(q.float(), k, v, pos, scale).to(q.dtype)
    return decode_attention(
        q, paged_gather_kv(arena_k, tables, max_len),
        paged_gather_kv(arena_v, tables, max_len), pos, scale,
    )
