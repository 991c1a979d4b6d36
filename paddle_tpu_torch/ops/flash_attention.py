"""Attention for the PyTorch/CUDA port: the counterpart of
`paddle_tpu/ops/flash_attention.py`.

Layout at the public functions is the reference's `[batch, seq, heads,
head_dim]`.  Two hand-written Hopper kernels carry the serving path:

- `flash_fwd` (csrc/flash_fwd.cu, replaces `_flash_fwd_kernel`): causal
  prompt attention at the fresh-prefill site, through `sdpa`.
- `paged_decode_fused` (csrc/paged_decode.cu, replaces
  `_fused_paged_decode_forward`): every decode step, reading the K/V page
  arena through the page tables in-kernel.

Each kernel has a plain PyTorch version here.  A wrapper takes the plain
version only for a tensor on the CPU (the tests); for a CUDA tensor it
launches the kernel or raises.  `launch_counts` counts kernel launches, so a
run can show that the main path went through the kernels.
"""

from __future__ import annotations

import math

import torch

from ..framework.core import INDEX_DTYPE

NEG_INF = -1e30  # the reference's mask value (flash_attention.py:36)

launch_counts = {"flash_fwd": 0, "paged_decode_fused": 0}

# the fused kernel holds one kv head's GQA group x window in one block
MAX_PAGED_ROWS = 64
MAX_HEAD_DIM = 256
# keys one block of the fused kernel walks, about: longer page walks split
PAGED_SPLIT_KEYS = 512

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
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    code = lib().ptt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, s, h, k.shape[2], d, int(bool(causal)),
        float(scale), _dtype_code(q, "flash_fwd"), _stream(q),
    )
    check(code, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return out, lse


def sdpa(q, k, v, causal=False, scale=None):
    """Scaled dot-product attention on [b, s, h, d] (the port's
    `sdpa_array`): self-attention through the `flash_fwd` kernel."""
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


def decode_attention(q, k, v, pos, scale=None):
    """Cached attention against dense buffers: the dense math of the
    reference's `decode_attention_array` (flash_attention.py:771-787).
    q: [b, sq, h, d]; k, v: [b, L, kv_h, d]; pos: int or [b] int32.  Row i
    of slot s attends cache rows j <= pos[s] + i.  Returns [b, sq, h, d]."""
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


def _check_paged(q, arena_k, arena_v, tables, pos):
    _require(q.dim() == 4, "paged_decode_fused: q must be [b, sq, h, d]")
    b, sq, h, d = q.shape
    _require(arena_k.dim() == 4 and arena_k.shape == arena_v.shape,
             "paged_decode_fused: arenas must be [pages, page_size, kv_h, d]")
    _require(arena_k.shape[3] == d, "paged_decode_fused: head_dim differs")
    hk = arena_k.shape[2]
    _require(h % hk == 0,
             f"paged_decode_fused: {h} q heads not a multiple of {hk} kv heads")
    _require(d <= MAX_HEAD_DIM, f"paged_decode_fused: head_dim {d} > {MAX_HEAD_DIM}")
    _require((h // hk) * sq <= MAX_PAGED_ROWS,
             f"paged_decode_fused: rep * sq = {(h // hk) * sq} rows > "
             f"{MAX_PAGED_ROWS}")
    _require(tables.dim() == 2 and tables.shape[0] == b,
             "paged_decode_fused: tables must be [b, P]")
    _require(tables.dtype == INDEX_DTYPE and pos.dtype == INDEX_DTYPE,
             "paged_decode_fused: tables and pos must be int32")
    _require(pos.shape == (b,), "paged_decode_fused: pos must be [b]")
    _require(q.dtype == arena_k.dtype == arena_v.dtype,
             "paged_decode_fused: q and arena dtypes differ")
    _dtype_code(q, "paged_decode_fused")


def paged_decode_plain(q, arena_k, arena_v, tables, pos, max_len, scale):
    """Plain version of `paged_decode_fused`: the kernel's masks over the
    whole table width -- key jid is seen by window row w iff
    jid <= pos + w and jid < max_len -- then a dense softmax.  Returns
    [b, sq, h, d]."""
    b, sq, h, d = q.shape
    width = tables.shape[1] * arena_k.shape[1]
    k = paged_gather_kv(arena_k, tables, width)
    v = paged_gather_kv(arena_v, tables, width)
    hk = k.shape[2]
    q5 = q.permute(0, 2, 1, 3).reshape(b, hk, h // hk, sq, d)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    s = torch.einsum("bgrqd,bgkd->bgrqk", q5.float(), kt.float()) * scale
    w = torch.arange(sq, device=q.device).view(sq, 1)
    jid = torch.arange(width, device=q.device).view(1, width)
    seen = (jid <= pos.view(b, 1, 1, 1, 1) + w) & (jid < max_len)
    p = torch.softmax(torch.where(seen, s, NEG_INF), dim=-1)
    out = torch.einsum("bgrqk,bgkd->bgrqd", p.to(v.dtype).float(), vt.float())
    return out.to(q.dtype).reshape(b, h, sq, d).permute(0, 2, 1, 3)


def paged_decode_fused(q, arena_k, arena_v, tables, pos, max_len, scale=None):
    """K2 wrapper.  q: [b, sq, h, d]; arena_k/v: [pages, page_size, kv_h, d];
    tables: [b, P] int32 page ids (each must name a real page: the kernel
    indexes the arena by the raw value, see `check_table_bounds`); pos: [b]
    int32.  Returns [b, sq, h, d]."""
    pos = _pos_vector(pos, q.shape[0], q.device)
    _check_paged(q, arena_k, arena_v, tables, pos)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not _on_cuda((q, arena_k, arena_v, tables, pos), "paged_decode_fused"):
        return paged_decode_plain(q, arena_k, arena_v, tables, pos, max_len, scale)
    from ._build import check, lib

    q, tables, pos = q.contiguous(), tables.contiguous(), pos.contiguous()
    _require(arena_k.is_contiguous() and arena_v.is_contiguous(),
             "paged_decode_fused: arenas must be contiguous")
    b, sq, h, d = q.shape
    hk, ps, P = arena_k.shape[2], arena_k.shape[1], tables.shape[1]
    out = torch.empty_like(q)
    # a long page walk splits across blocks of ~PAGED_SPLIT_KEYS keys; their
    # partials merge in a float32 workspace [b, hk, splits, rows, d + 2]
    splits = -(-P // max(1, PAGED_SPLIT_KEYS // ps))
    ws = torch.empty(b * hk * splits * (h // hk) * sq * (d + 2) if splits > 1 else 0,
                     dtype=torch.float32, device=q.device)
    code = lib().ptt_paged_decode(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr() if splits > 1 else None, splits, b, sq, h, hk, d, ps,
        P, int(max_len), float(scale), _dtype_code(q, "paged_decode_fused"),
        _stream(q),
    )
    check(code, "paged_decode_fused")
    launch_counts["paged_decode_fused"] += 1
    return out


def paged_decode_attention(q, arena_k, arena_v, tables, pos, max_len,
                           scale=None, kernel="auto"):
    """Paged-decode attention dispatcher (the reference's
    `paged_decode_attention_array`, flash_attention.py:1553).  "fused" runs
    `paged_decode_fused` (which raises on a shape it does not take); "auto",
    the reference flag's default, is an alias of "fused" because the port
    has no silent fallback to the oracle; "gather" runs the explicit
    oracle: `paged_gather_kv` then the dense `decode_attention`."""
    if kernel not in ("auto", "fused", "gather"):
        raise ValueError(
            f"paged decode kernel must be auto|fused|gather, got {kernel!r}"
        )
    if kernel == "gather":
        return decode_attention(
            q, paged_gather_kv(arena_k, tables, max_len),
            paged_gather_kv(arena_v, tables, max_len), pos, scale,
        )
    return paged_decode_fused(q, arena_k, arena_v, tables, pos, max_len, scale)
