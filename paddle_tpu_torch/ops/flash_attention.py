"""Attention for the PyTorch/CUDA port: the counterpart of
`paddle_tpu/ops/flash_attention.py`.

Layout at the public functions is the reference's `[batch, seq, heads,
head_dim]`.  Six hand-written Hopper kernels carry the serving and
training paths:

- `flash_fwd` (csrc/flash_fwd.cu, replaces `_flash_fwd_kernel`): causal
  prompt attention at the fresh-prefill site and every training forward,
  through `sdpa`.
- `flash_bwd` (csrc/flash_bwd.cu, replaces `_pallas_flash_backward`): the
  attention gradient of a training step, through the `FlashAttention`
  autograd Function that `sdpa` uses when grad is recorded.
- `paged_decode_fused` (csrc/paged_decode.cu, replaces
  `_fused_paged_decode_forward`): every decode step and every chunk
  prefill of a prefix-cache hit, reading the K/V page arena through the
  page tables in-kernel.
- `paged_decode_fused_q8` (csrc/paged_decode.cu, replaces
  `_fused_paged_decode_quant_forward`): the same over an int8 arena with
  per-row float32 scales, dequantized in-kernel.
- `dense_decode` (csrc/flash_fwd.cu, K1's kernels with a query offset read
  from the device; replaces `_pallas_decode_forward`): cached attention
  against a dense static KV cache, taken by `decode_attention` where the
  reference takes its Pallas kernel -- the prefill of lock-step
  generation.
- `paged_decode_partials` (csrc/paged_decode.cu, K2's page walk with a
  token position per table column and un-normalised output; replaces
  `_fused_paged_decode_partials_forward`): context-parallel paged
  attention, one launch per cp shard over that shard's page range, the
  shards merged by `cp_softmax_combine` (`paged_decode_cp`).

Each kernel has a plain PyTorch version here.  A wrapper takes the plain
version only for a tensor on the CPU (the tests); for a CUDA tensor it
launches the kernel or raises.  `launch_counts` counts kernel launches, so a
run can show that the main path went through the kernels.

Where a kernel has more than one implementation, one function here picks it
from the shape and passes the choice to the C entry point, which raises on
a shape the choice does not fit (never another kernel): `flash_path` for K1
and K6 (the `wgmma` + TMA kernel, `mma.sync`, or FMA) and `paged_path` for
K2, K4 and K5 (the tensor-core chunk window, or the FMA page walk).  The
`*_wgmma` and `*_mma` counts are the launches that took the tensor-core
kernels, a subset of their kernel's count.
"""

from __future__ import annotations

import math

import torch

from ..framework.core import INDEX_DTYPE

NEG_INF = -1e30  # the reference's mask value (flash_attention.py:36)

# K5's two counts carry the reference's names (`_log_pallas_call`,
# flash_attention.py:1608) but count kernel launches: one per cp shard, so
# cp times the reference's count of cp dispatches
launch_counts = {"flash_fwd": 0, "paged_decode_fused": 0,
                 "paged_decode_fused_q8": 0, "flash_bwd": 0, "dense_decode": 0,
                 "paged_decode_fused_cp": 0, "paged_decode_fused_cp_q8": 0,
                 "flash_fwd_wgmma": 0, "dense_decode_wgmma": 0,
                 "paged_decode_fused_mma": 0, "paged_decode_fused_q8_mma": 0,
                 "paged_decode_fused_cp_mma": 0, "paged_decode_fused_cp_q8_mma": 0}

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
# the q tile of K1's Hopper kernel (two warpgroups of 64 rows)
FLASH_WGMMA_ROWS = 128

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for name in launch_counts:
        launch_counts[name] = 0


def _dtype_code(t, what):
    try:
        return _DTYPE_CODES[t.dtype]
    except KeyError:
        raise TypeError(
            f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)"
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


def flash_path(rows, d, dtype):
    """The kernel K1 and K6 launch for `rows` query rows of head_dim `d`:
    "wgmma" (TMA + `wgmma`, a 128-row tile per block) for bfloat16 with d 64
    or 128 and at least FLASH_WGMMA_ROWS rows; "mma" (`mma.sync`, 64-row
    tiles) for the other bfloat16 shapes with d <= 128; "fma" for float32
    and d > 128."""
    if dtype == torch.bfloat16 and d in (64, 128) and rows >= FLASH_WGMMA_ROWS:
        return "wgmma"
    return "mma" if dtype == torch.bfloat16 and d <= 128 else "fma"


def paged_path(rows, d, dtype):
    """The kernel K2, K4 and K5 launch for a GQA group x window of `rows` =
    rep * sq rows: "mma" (the tensor-core chunk window) for a bfloat16 q
    with d 64 or 128 and at least PAGED_MMA_MIN_ROWS rows -- every chunk
    prefill of a served Llama -- and "fma" (the page walk on FMAs: decode,
    the verify window, float32) otherwise."""
    if dtype == torch.bfloat16 and d in (64, 128) and rows >= PAGED_MMA_MIN_ROWS:
        return "mma"
    return "fma"


def paged_splits(path, b, hk, rows, P, ps):
    """Blocks a slot's page walk splits into.  FMA: a block of r rows (at
    most one row tile) does r times a decode block's work per key, so it
    walks about PAGED_SPLIT_KEYS / r keys, at least one page.  Tensor-core
    chunk window: a 64-row block takes a 64-key tile in about the time the
    FMA block took a few keys, so splitting by keys would leave most splits
    idle; the host does not know the live length (pos lies on the card), so
    it splits only to fill one wave of the card (at most PAGED_MMA_BLOCKS
    blocks), at most one split per 64-key tile of the table, and each block
    divides the live tiles among the splits itself."""
    if path == "fma":
        keys = PAGED_SPLIT_KEYS // min(rows, PAGED_ROW_TILE)
        return -(-P // max(1, keys // ps))
    tiles = -(-(P * ps) // PAGED_MMA_KEYS)
    blocks = b * hk * -(-rows // PAGED_ROW_TILE)
    return max(1, min(tiles, PAGED_MMA_BLOCKS // blocks))


# ---------------------------------------------------------------------------
# K1: flash-attention forward
# ---------------------------------------------------------------------------


def _check_flash(q, k, v):
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "flash_fwd: q, k, v must be [b, s, h, d]")
    b, s, h, d = q.shape
    _require(k.shape == v.shape, "flash_fwd: k and v shapes differ")
    _require(k.shape[0] == b and k.shape[1] == s and k.shape[3] == d,
             f"flash_fwd: q {tuple(q.shape)} and k {tuple(k.shape)} must share "
             "batch, seq and head_dim")
    _require(h % k.shape[2] == 0,
             f"flash_fwd: {h} q heads not a multiple of {k.shape[2]} kv heads")
    _require(d <= MAX_HEAD_DIM, f"flash_fwd: head_dim {d} > {MAX_HEAD_DIM}")
    _require(q.dtype == k.dtype == v.dtype, "flash_fwd: q, k, v dtypes differ")
    _dtype_code(q, "flash_fwd")


def flash_forward_plain(q, k, v, causal, scale):
    """Plain version of `flash_fwd`: the reference's dense attention
    (`_dense_attention`, flash_attention.py:1744) on [b, s, h, d] inputs.
    Returns (out [b, s, h, d] in q's dtype, lse [b, h, s] float32)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # [b, h, s, d]
    rep = qt.shape[1] // kt.shape[1]
    if rep != 1:  # GQA: kv head i serves q heads [i*rep, (i+1)*rep)
        kt = kt.repeat_interleave(rep, dim=1)
        vt = vt.repeat_interleave(rep, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", qt.float(), kt.float()) * scale
    sq, sk = s.shape[-2], s.shape[-1]
    if causal:
        q_ids = torch.arange(sq, device=s.device)[:, None]
        k_ids = torch.arange(sk, device=s.device)[None, :]
        s = torch.where(q_ids >= k_ids - (sk - sq), s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vt.float())
    return out.to(q.dtype).transpose(1, 2).contiguous(), lse


def flash_forward(q, k, v, causal=True, scale=None):
    """K1 wrapper.  q: [b, s, h, d]; k, v: [b, s, hk, d] with h % hk == 0
    (GQA indexes kv head h // rep in-kernel); float32 or bfloat16.  Returns
    (out [b, s, h, d], lse [b, h, s] float32)."""
    _check_flash(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda((q, k, v), "flash_fwd"):
        return flash_forward_plain(q, k, v, causal, scale)
    _require(q.is_contiguous() and k.is_contiguous() and v.is_contiguous(),
             "flash_fwd: q, k, v must be contiguous")
    from ._build import check, lib

    b, s, h, d = q.shape
    path = flash_path(s, d, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    code = lib().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, int(bool(causal)),
        float(scale), _dtype_code(q, "flash_fwd"), _FLASH_PATHS[path], _stream(q),
    )
    check(code, f"flash_fwd ({path})")
    launch_counts["flash_fwd"] += 1
    if path == "wgmma":
        launch_counts["flash_fwd_wgmma"] += 1
    return out, lse


# ---------------------------------------------------------------------------
# K3: flash-attention backward
# ---------------------------------------------------------------------------


def flash_backward_plain(q, k, v, out, lse, g, causal, scale):
    """Plain version of `flash_bwd`: the math of the reference's
    `_flash_backward` (flash_attention.py:1763-1814) on [b, s, h, d] inputs,
    with its rounding points: p rounded to the input dtype before p^T g, ds
    rounded before ds k and ds^T q, every product summed in float32.  dk/dv
    are summed over each GQA group in float32 and rounded once.  Returns
    (dq, dk, dv) in q's dtype."""
    dt = q.dtype
    b, s, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    qt, gt, ot = (x.transpose(1, 2).float() for x in (q, g, out))  # [b, h, s, d]
    kt = k.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    vt = v.transpose(1, 2).float().repeat_interleave(rep, dim=1)
    delta = (gt * ot).sum(-1)  # [b, h, s]
    sc = torch.einsum("bhqd,bhkd->bhqk", qt, kt) * scale
    if causal:
        ids = torch.arange(s, device=q.device)
        sc = torch.where(ids[:, None] >= ids[None, :], sc, NEG_INF)
    p = torch.exp(sc - lse[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(dt).float(), gt)
    dp = torch.einsum("bhqd,bhkd->bhqk", gt, vt)
    ds = (p * (dp - delta[..., None]) * scale).to(dt).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kt)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qt)
    dk = dk.reshape(b, hk, rep, s, d).sum(2)
    dv = dv.reshape(b, hk, rep, s, d).sum(2)
    return tuple(x.transpose(1, 2).to(dt).contiguous() for x in (dq, dk, dv))


def flash_backward(q, k, v, out, lse, g, causal=True, scale=None):
    """K3 wrapper.  q, out, g: [b, s, h, d]; k, v: [b, s, hk, d] (GQA read
    in place, dk/dv summed over each group in-kernel); lse: [b, h, s]
    float32 from `flash_forward`.  Returns (dq, dk, dv) shaped and typed
    like q, k, v."""
    _check_flash(q, k, v)
    b, s, h, d = q.shape
    _require(out.shape == q.shape and g.shape == q.shape,
             "flash_bwd: out and g must be shaped like q")
    _require(out.dtype == q.dtype and g.dtype == q.dtype,
             "flash_bwd: out and g must be typed like q")
    _require(lse.shape == (b, h, s) and lse.dtype == torch.float32,
             "flash_bwd: lse must be [b, h, s] float32")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not _on_cuda((q, k, v, out, lse, g), "flash_bwd"):
        return flash_backward_plain(q, k, v, out, lse, g, causal, scale)
    _require(all(t.is_contiguous() for t in (q, k, v, out, lse, g)),
             "flash_bwd: inputs must be contiguous")
    from ._build import check, lib

    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    code = lib().ptt_flash_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), delta.data_ptr(), b, s, h, k.shape[2], d,
        int(bool(causal)), float(scale), _dtype_code(q, "flash_bwd"), _stream(q),
    )
    check(code, "flash_bwd")
    launch_counts["flash_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Attention with the hand-written backward (the counterpart of the
    reference's `custom_vjp` around `_flash_attention_core`,
    flash_attention.py:1967-2057).  The forward runs `flash_forward` and
    saves (q, k, v, out, lse), never the probabilities; the backward runs
    `flash_backward`.  Inputs arrive non-contiguous (q and k after RoPE, the
    output gradient from the reshape before o_proj): both kernels take
    contiguous tensors, so the copies are made here."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, g.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def sdpa(q, k, v, causal=False, scale=None):
    """Scaled dot-product attention on [b, s, h, d] (the port's
    `sdpa_array`): self-attention through the `flash_fwd` kernel, and,
    when autograd records and an input requires grad, through
    `FlashAttention` so the backward runs the `flash_bwd` kernel."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        return FlashAttention.apply(q, k, v, causal, scale)
    return flash_forward(q, k, v, causal=causal, scale=scale)[0]


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


def _pos_vector(pos, b, device):
    pos = torch.as_tensor(pos, dtype=INDEX_DTYPE, device=device)
    return pos.reshape(-1).expand(b) if pos.numel() == 1 else pos.reshape(b)


def decode_attention_plain(q, k, v, pos, scale=None):
    """Cached attention against dense buffers: the dense math of the
    reference's `decode_attention_array` (flash_attention.py:771-787), and
    the plain version of `dense_decode`.  q: [b, sq, h, d]; k, v: [b, L,
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
    p_ = _pos_vector(pos, b, q.device)
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
    the dense math.  On the serving paths that is the prefill of lock-step
    generation and nothing else: single-token and per-slot decode steps
    stay dense."""
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
    launch_counts[what] += 1
    if path == "wgmma":
        launch_counts[what + "_wgmma"] += 1
    return out


def decode_attention(q, k, v, pos, scale=None):
    """Cached attention against dense buffers, the reference's dispatcher
    `decode_attention_array` (flash_attention.py:698).  q: [b, sq, h, d];
    k, v: [b, L, kv_h, d]; pos: a scalar (an int or a 0-d int32 tensor:
    the lock-step position) or a [b] int32 tensor (per-slot positions).
    `dense_decode` where `takes_dense_decode` holds -- on a CUDA tensor the
    kernel runs or raises -- else the dense math, as the reference's XLA
    path.  Returns [b, sq, h, d]."""
    per_row = getattr(pos, "ndim", 0) == 1
    if takes_dense_decode(q.shape[1], q.shape[3], k.shape[1], per_row):
        return dense_decode(q, k, v, pos, scale)
    return decode_attention_plain(q, k, v, pos, scale)


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


def _count(code, what, path):
    """Raise on a failed paged launch, else count it (and its path)."""
    from ._build import check

    check(code, f"{what} ({path})")
    launch_counts[what] += 1
    if path == "mma":
        launch_counts[what + "_mma"] += 1


def _paged_workspace(q, hk, splits):
    """float32 workspace [b, hk, splits, rows, d + 2] where the splits'
    partials merge (empty for one split)."""
    b, sq, h, d = q.shape
    n = b * hk * splits * (h // hk) * sq * (d + 2) if splits > 1 else 0
    return torch.empty(n, dtype=torch.float32, device=q.device)


def paged_decode_fused(q, arena_k, arena_v, tables, pos, max_len, scale=None):
    """K2 wrapper.  q: [b, sq, h, d] (any GQA group x window: the kernel
    tiles its rows by 64); arena_k/v: [pages, page_size, kv_h, d];
    tables: [b, P] int32 page ids (each must name a real page: the kernel
    indexes the arena by the raw value, see `check_table_bounds`); pos: [b]
    int32.  Returns [b, sq, h, d]."""
    what = "paged_decode_fused"
    pos = _pos_vector(pos, q.shape[0], q.device)
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
        ws.data_ptr() if splits > 1 else None, splits, int(path == "mma"), b,
        sq, h, hk, d, ps, P, int(max_len), float(scale), _dtype_code(q, what),
        _stream(q),
    )
    _count(code, what, path)
    return out


def paged_decode_fused_q8(q, arena_k, arena_v, k_scale, v_scale, tables, pos,
                          max_len, scale=None):
    """K4 wrapper: `paged_decode_fused` over an int8 arena.  arena_k/v:
    [pages, page_size, kv_h, d] int8; k_scale/v_scale: [pages, page_size,
    kv_h, 1] float32, addressed by the same tables; q float32 or bfloat16.
    Returns [b, sq, h, d] in q's dtype."""
    what = "paged_decode_fused_q8"
    pos = _pos_vector(pos, q.shape[0], q.device)
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
        splits, int(path == "mma"), b, sq, h, hk, d, ps, P, int(max_len),
        float(scale), _dtype_code(q, what), _stream(q),
    )
    _count(code, what, path)
    return out


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
    pos = _pos_vector(pos, q.shape[0], q.device)
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
    code = fn(*ptrs, splits, int(path == "mma"), b, sq, h, hk, d, ps, P,
              int(max_len), float(scale), _dtype_code(q, what), _stream(q))
    _count(code, what, path)
    return acc, m, l


def paged_decode_cp(q, arena_k, arena_v, tables, pos, max_len, cp, scale=None,
                    k_scale=None, v_scale=None, local=None):
    """Context-parallel paged attention (the reference's
    `_fused_paged_decode_cp_impl`, flash_attention.py:1411): the arena's
    page axis splits into `cp` equal shards, shard s owning global pages
    [s*per_shard, (s+1)*per_shard) with its scratch page first.  One K5
    launch per shard over the view arena[s*per_shard:(s+1)*per_shard] (no
    copy; the scale arenas likewise) with its local table and page_base
    (`local`: `cp_local_tables` of `tables`, derived here when None), then
    `cp_softmax_combine` over the shards, cast to q's dtype.  tables: [b,
    P] GLOBAL page ids in the round-robin layout (sequence page k on shard
    k % cp).  Returns [b, sq, h, d]."""
    num_pages, ps = arena_k.shape[0], arena_k.shape[1]
    if num_pages % cp or tables.shape[1] % cp:
        raise ValueError(
            f"context-parallel paged attention needs the pool ({num_pages} "
            f"pages) and the table width ({tables.shape[1]}) to divide into "
            f"cp={cp} shards"
        )
    per_shard = num_pages // cp
    if local is None:
        local = cp_local_tables(tables, cp, per_shard, ps)
    pos = _pos_vector(pos, q.shape[0], q.device)
    parts = []
    for s, (loc, base) in enumerate(local):
        sl = slice(s * per_shard, (s + 1) * per_shard)
        scales = (k_scale[sl], v_scale[sl]) if k_scale is not None else (None, None)
        parts.append(paged_decode_partials(q, arena_k[sl], arena_v[sl], loc, base,
                                           pos, max_len, scale, *scales))
    acc, m, l = (torch.stack(x) for x in zip(*parts))
    b, sq, h, d = q.shape
    out = cp_softmax_combine(acc, m, l)  # [b, hk, rep*sq, d]
    return out.reshape(b, h, sq, d).permute(0, 2, 1, 3).to(q.dtype)


def paged_decode_attention(q, arena_k, arena_v, tables, pos, max_len,
                           scale=None, kernel="auto", k_scale=None,
                           v_scale=None, cp=1, local=None):
    """Paged-decode attention dispatcher (the reference's
    `paged_decode_attention_array`, flash_attention.py:1553).  "fused" runs
    `paged_decode_fused`, or `paged_decode_fused_q8` when k_scale/v_scale
    are given (an int8 arena); each raises on a shape it does not take.
    With cp > 1 it runs `paged_decode_cp` (K5 per shard, then the combine;
    `local` its precomputed `cp_local_tables`), and a pool or table width
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
