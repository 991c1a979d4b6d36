"""Llama for the PyTorch/CUDA port (counterpart of
`paddle_tpu/models/llama.py`): the model, rotary embeddings, the paged KV
views the serving engine drives, and the dense static KV cache of
lock-step `generate` and the dense slot-pool engine.

Linear layers are `torch.nn.Linear`, whose weight is `[out, in]`; the
reference stores `[in, out]`, so `models.convert.load_reference_state`
transposes them.  Attention goes through `ops.flash_attention`: the
full-sequence forward and the fresh paged prefill run the `flash_fwd`
kernel (under context parallelism, `context_parallel_degree` on a `sep`
mesh, ring attention's K1 and K3 launches; with `sep_degree`, Ulysses);
the paged decode step and the chunk prefill of a prefix-cache hit
the `paged_decode_fused` kernel, or `paged_decode_fused_q8` over an int8
arena (under tensor parallelism one launch per rank over its head shard,
`paged_decode_tp`), and under context parallelism one `paged_decode_partials` launch
per cp shard (the speculative verify window is a decode step of k + 1
rows); a training backward the `flash_bwd` kernel.  Against a static
cache, a lock-step prefill of 64+ rows runs the `dense_decode` kernel and
shorter chunks and decode steps (the slot pool's too) `paged_decode_fused`
over the cache's page view (`decode_attention`); the slot pool's prefill
runs `flash_fwd` over its bucket.  The cache writes
update the arena and cache tensors in place (the reference rebinds new
immutable arrays).
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..distributed import mesh as _mesh
from ..distributed.fleet.meta_parallel.mp_layers import (
    ColumnParallelLinear,
    ParallelCrossEntropy,
    RowParallelLinear,
    VocabParallelEmbedding,
)
from ..distributed.fleet.meta_parallel.ring_attention import (
    ring_flash_attention,
    ulysses_attention,
)
from ..framework.core import INDEX_DTYPE, resolve_device, to_torch_dtype
from ..incubate.recompute import recompute
from ..nn.norm import RMSNorm
from ..ops.flash_attention import (
    decode_attention,
    dense_page_table,
    paged_decode_attention,
    paged_decode_q8_tp,
    paged_decode_tp,
    sdpa,
)
from ._utils import lockstep_generate, sequence_ce


@dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # long-context parallelism over the 'sep' mesh axis (the reference's
    # llama.py:44-49): sep_degree routes full-sequence attention through
    # Ulysses, context_parallel_degree through ring attention
    sep_degree: int = 1
    context_parallel_degree: int = 1
    # training: re-run each decoder layer's forward in the backward instead
    # of keeping its activations (the reference's use_recompute, llama.py:49)
    use_recompute: bool = False
    # tensor-parallel serving (the reference's llama.py:42): the column- and
    # row-parallel projections, the vocabulary-split embedding and lm_head
    tensor_parallel_degree: int = 1

    @staticmethod
    def llama2_7b(**overrides):
        return LlamaConfig(**overrides)

    @staticmethod
    def tiny(**overrides):
        base = dict(
            vocab_size=256,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            num_key_value_heads=4,
            max_position_embeddings=256,
        )
        base.update(overrides)
        return LlamaConfig(**base)

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


# ---------------------------------------------------------------------------
# rotary embeddings (rotate-half convention, tables in float32)
# ---------------------------------------------------------------------------


def rope_cache(config, device):
    """cos/sin tables [max_pos, head_dim], duplicated to the full head dim
    (rotate-half), computed in float64 on the host as the reference does."""
    dim = config.head_dim
    inv_freq = 1.0 / (
        config.rope_theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
    )
    t = np.arange(config.max_position_embeddings, dtype=np.float64)
    emb = np.concatenate([np.outer(t, inv_freq)] * 2, axis=-1)
    return (
        torch.from_numpy(np.cos(emb).astype(np.float32)).to(device),
        torch.from_numpy(np.sin(emb).astype(np.float32)).to(device),
    )


def _rotate(x, c, s):
    half = x.shape[-1] // 2
    rh = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * c + rh * s


def apply_rotary_pos_emb(q, k, cos, sin, position_offset=0):
    """q, k: [b, s, h, d].  `position_offset` is an int (all rows start
    there), a 0-d int32 tensor (the same, kept on the device: lock-step
    generation's position) or a [b] int32 tensor of per-row offsets (the
    engine's slots, each at its own position).  The tensor gathers clamp
    out-of-range positions, as the reference's JAX gather and dynamic slice
    do (llama.py:110-116)."""
    s = q.shape[1]
    if isinstance(position_offset, torch.Tensor):
        idx = position_offset.long().reshape(-1, 1) + torch.arange(s, device=q.device)
        idx = idx.clamp(0, cos.shape[0] - 1)
        c = cos[idx][:, :, None, :].to(q.dtype)  # [b or 1, s, 1, d]
        si = sin[idx][:, :, None, :].to(q.dtype)
    else:
        off = int(position_offset)
        if off < 0 or off + s > cos.shape[0]:
            raise ValueError(
                f"rope positions [{off}, {off + s}) exceed the table of "
                f"{cos.shape[0]}"
            )
        c = cos[off:off + s][None, :, None, :].to(q.dtype)
        si = sin[off:off + s][None, :, None, :].to(q.dtype)
    return _rotate(q, c, si), _rotate(k, c, si)


# ---------------------------------------------------------------------------
# dense static KV cache
# ---------------------------------------------------------------------------


class StaticKVCache:
    """Preallocated `[b, max_len, kv_heads, head_dim]` K/V buffers on
    `device`, zero at first, written in place at the current position, so a
    decode step never changes a shape (reference: llama.py:138).  Lock-step
    generation holds one per layer with a row per sequence; the dense
    slot-pool engine one with a row per slot.  `table` is the page table of
    the buffers' page view (`ops.flash_attention.dense_page_table`), built
    here once on the device: attention outside `dense_decode`'s shapes
    reads the cache through it with `paged_decode_fused`, and a captured
    step finds it already on the card."""

    def __init__(self, b, max_len, kv_heads, head_dim, dtype=torch.float32,
                 device=None):
        self.max_len = int(max_len)
        shape = (int(b), self.max_len, int(kv_heads), int(head_dim))
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)
        self.table = dense_page_table(int(b), self.max_len, self.k.device)


def _cache_write(cache, new, pos):
    """Write a chunk's K or V rows `new` [b, s, kv_heads, d] into `cache`
    [b, L, kv_heads, d] in place (reference: llama.py:156).  `pos`: the
    position of the chunk's row 0, a 0-d int32 tensor or an int (lock-step:
    every row at one position, written through a device index so nothing
    waits for the device), or a [b] int32 tensor (the slot pool: row b at
    its own position)."""
    s = new.shape[1]
    ar = torch.arange(s, device=cache.device)
    if isinstance(pos, torch.Tensor) and pos.dim() == 1:
        rows = pos.long()[:, None] + ar  # [b, s]
        bidx = torch.arange(cache.shape[0], device=cache.device)[:, None]
        cache[bidx, rows] = new.to(cache.dtype)
    else:
        idx = torch.as_tensor(pos, device=cache.device).long() + ar
        cache.index_copy_(1, idx, new.to(cache.dtype))


class SlotView:
    """Write view of ONE slot of a pooled StaticKVCache, for the dense
    slot-pool engine's prefill (reference: llama.py:180): the prompt's K/V
    land in rows [0, bucket) of pool row `slot` (a [1] int32 tensor on the
    pool's device: data, as the engine's captured prefill takes it), while
    attention runs over the fresh prompt alone.  Rows past the true prompt
    length hold padding until decode overwrites them; they are never
    attended before, because decode writes row pos first and masks j >
    pos."""

    def __init__(self, pool, slot):
        self.pool = pool
        self.slot = slot


def _slot_write(pool, new, slot):
    """Write a [1, s, kv_heads, d] chunk into rows [0, s) of pool row
    `slot` ([1] int32) of a [slots, max_len, kv_heads, d] buffer, in place
    (reference: llama.py:193), indexing on the device."""
    pool.narrow(1, 0, new.shape[1]).index_copy_(0, slot.long(), new.to(pool.dtype))


# ---------------------------------------------------------------------------
# paged KV cache
# ---------------------------------------------------------------------------


class PagedKVCache:
    """One layer's paged K/V arena: `[num_pages, page_size, kv_heads,
    head_dim]` tensors addressed through per-slot page tables.  Page 0 is
    scratch: inactive slots' all-zero table rows and every redirected write
    land there (see inference/paging.py).

    quant="int8" stores K and V as int8 and adds float32 `k_scale` /
    `v_scale` arenas `[num_pages, page_size, kv_heads, 1]`: one symmetric
    scale per (token row, kv head), written by the same scatters and
    addressed by the same tables.  Everything starts at zero, as in the
    reference (so scratch rows dequantize to exactly 0)."""

    def __init__(self, num_pages, page_size, kv_heads, head_dim,
                 dtype=torch.float32, device=None, quant="none"):
        self.page_size = int(page_size)
        self.quant = str(quant)
        shape = (int(num_pages), self.page_size, int(kv_heads), int(head_dim))
        if self.quant == "int8":
            dtype = torch.int8
            scales = (*shape[:3], 1)
            self.k_scale = torch.zeros(scales, dtype=torch.float32, device=device)
            self.v_scale = torch.zeros(scales, dtype=torch.float32, device=device)
        else:
            self.k_scale = self.v_scale = None
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)


class PagedPrefillView:
    """Prefill into a paged arena; its K/V rows scatter into the pages of
    `table` ([max_pages_per_seq] int32 tensor).  Fresh prefill (`start` is
    None): the prompt attends to itself causally.  Chunk prefill (`start` a
    [1] int32 tensor): a prefix-cache hit prefills only the unshared suffix
    at rope offset `start`, and suffix row i attends positions j <= start + i
    of the whole sequence, shared pages included, through the paged kernel
    (`kernel` as in `paged_decode_attention`, `max_len` its position
    fence).  Rows at or past `true_len` (bucket padding; an int, or a [1]
    int32 tensor on the arena's device, as the engine's captured prefills
    pass it) and rows whose page index overruns the table land on scratch
    page 0.  Under context
    parallelism (`cp` > 1) the chunk's attention runs over every shard;
    `local` is `cp_stacked_tables` of the [1, P] table, derived once per
    forward by the caller and shared by every layer's view.  The writes address global
    page ids either way."""

    def __init__(self, arena, table, true_len, max_len=None, start=None,
                 kernel="auto", cp=1, local=None):
        self.arena = arena
        self.table = table
        self.true_len = (true_len if isinstance(true_len, torch.Tensor)
                         else int(true_len))
        self.max_len = max_len
        self.start = start
        self.kernel = kernel
        self.cp = int(cp)
        self.local = local


class PagedDecodeView:
    """Decode over the paged arena: `tables` is the [slots,
    max_pages_per_seq] int32 page table; slot s writes its token (or its
    verify window's rows) at page tables[s, pos // page_size], row pos %
    page_size, and attends its pages through the fused kernel (or the
    gather oracle).  With `cp` > 1 attention runs K5 over every shard in
    one launch, through `local` (`cp_stacked_tables` of `tables`, derived
    once per forward and shared by every layer's view)."""

    def __init__(self, arena, tables, max_len, kernel="auto", cp=1, local=None):
        self.arena = arena
        self.tables = tables
        self.max_len = int(max_len)
        self.kernel = kernel
        self.cp = int(cp)
        self.local = local


def _prefill_rows(table, s, true_len, ps, start):
    """(page, row) of each of a prefill chunk's s rows: row i lands at
    global index start + i (start 0 for a fresh prefill); rows with
    i >= true_len (an int or a [1] tensor) or a page index beyond the table
    go to scratch page 0.
    Several may hit the same scratch row, which is harmless because page 0
    is never attended past the position fence."""
    i = torch.arange(s, device=table.device)
    gidx = i if start is None else start.long()[0] + i
    entry = gidx // ps
    P = table.shape[0]
    valid = (i < true_len) & (entry < P)
    pg = torch.where(valid, table.long()[entry.clamp(max=P - 1)], 0)
    return pg, gidx % ps


def _rope_page_scatter(arena_k, arena_v, q, k, v, cos, sin, table, true_len,
                       start=None):
    """Prefill cache write (reference: llama.py:311): RoPE on q/k at offset
    0, or at the per-row positions start + i of a chunk (the gather clamps
    as the reference's does), then row i of the [1, s, kv_heads, d] chunk
    lands where `_prefill_rows` says.  Updates the arenas in place; returns
    (q_rot, k_rot)."""
    q_rot, k_rot = apply_rotary_pos_emb(q, k, cos, sin, 0 if start is None else start)
    pg, row = _prefill_rows(table, q.shape[1], true_len, arena_k.shape[1], start)
    arena_k[pg, row] = k_rot[0].to(arena_k.dtype)
    arena_v[pg, row] = v[0].to(arena_v.dtype)
    return q_rot, k_rot


def _quantize_kv_rows(x):
    """Symmetric per-row int8 quantization of KV rows [..., head_dim]
    (reference: llama.py:361): scale = max|x| / 127 over the head dim in
    float32, zero rows pinned to scale 1 so they dequantize to exactly 0,
    round half to even, clip to +-127.  Returns (int8 values, float32
    scales [..., 1])."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0.0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(xf / scale), -127.0, 127.0).to(torch.int8), scale


def _rope_page_scatter_quant(arena_k, arena_v, k_scale, v_scale, q, k, v, cos,
                             sin, table, true_len, start=None):
    """`_rope_page_scatter` for an int8 arena (reference: llama.py:377): the
    same RoPE and addresses, with K/V rows quantized per (row, kv head) and
    their scales scattered through the same (page, row) indices.  Returns
    the full-precision (q_rot, k_rot): a fresh prefill's own attention runs
    on them."""
    q_rot, k_rot = apply_rotary_pos_emb(q, k, cos, sin, 0 if start is None else start)
    pg, row = _prefill_rows(table, q.shape[1], true_len, arena_k.shape[1], start)
    kq, ksc = _quantize_kv_rows(k_rot[0])
    vq, vsc = _quantize_kv_rows(v[0])
    arena_k[pg, row] = kq
    arena_v[pg, row] = vq
    k_scale[pg, row] = ksc
    v_scale[pg, row] = vsc
    return q_rot, k_rot


def _decode_rows(tables, pos, sq, ps):
    """(page, row) of slot s's window row i: page tables[s, (pos[s] + i) //
    page_size], row (pos[s] + i) % page_size.  Inactive slots run at pos 0
    over an all-zero table row, i.e. scratch page 0.  For sq > 1, rows whose
    page entry overruns the table are redirected to scratch; a single row
    never overruns (pos < pages * page_size by the engine's admission
    math)."""
    t = tables.long()
    p = pos.long()
    if sq == 1:
        return t.gather(1, (p // ps)[:, None])[:, 0], p % ps
    idx = p[:, None] + torch.arange(sq, device=p.device)[None, :]
    entry = idx // ps
    P = t.shape[1]
    return torch.where(entry < P, t.gather(1, entry.clamp(max=P - 1)), 0), idx % ps


def _page_decode_write(arena, new, tables, pos):
    """Decode cache write (reference: llama.py:431): slot s's [sq, kv_heads,
    d] rows land where `_decode_rows` says.  In place."""
    pg, row = _decode_rows(tables, pos, new.shape[1], arena.shape[1])
    src = new[:, 0] if new.shape[1] == 1 else new
    arena[pg, row] = src.to(arena.dtype)


def _page_decode_write_quant(arena, scales, new, tables, pos):
    """`_page_decode_write` for an int8 arena (reference: llama.py:472): the
    rows quantize per (row, kv head), then values and scales land at the
    same addresses.  In place."""
    pg, row = _decode_rows(tables, pos, new.shape[1], arena.shape[1])
    nq, ns = _quantize_kv_rows(new[:, 0] if new.shape[1] == 1 else new)
    arena[pg, row] = nq
    scales[pg, row] = ns


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _use_tp(config):
    """Whether a Llama built from `config` takes the tensor-parallel layers
    (reference: llama.py:71-72): a degree above 1, or an installed mesh
    whose 'mp' axis is."""
    return config.tensor_parallel_degree > 1 or _mesh.axis_size("mp") > 1


def _lora_add(lora, target, y, x, rank=None):
    """Base projection output `y` (computed from `x`) plus the
    batched-gather LoRA delta of `target` (reference: llama.py:512).  `lora`
    is a per-layer arena view carrying the dispatch's [b] int32 adapter
    slots as data; None (training, non-LoRA serving) passes `y` through and
    adds no operation.  Under tensor parallelism `rank` names the rank whose
    shards `y` and `x` are (`lora.AdapterArena.shard_for_tp`)."""
    return y if lora is None else lora.add(target, y, x, rank=rank)


def _linears(tp, device, dtype):
    """(column, row) Linear factories: the parallel layers under tensor
    parallelism, `torch.nn.Linear` otherwise; no bias either way."""
    kw = dict(device=device, dtype=dtype)
    if tp:
        return (lambda i, o: ColumnParallelLinear(i, o, has_bias=False,
                                                  gather_output=False, **kw),
                lambda i, o: RowParallelLinear(i, o, has_bias=False,
                                               input_is_parallel=True, **kw))
    plain = lambda i, o: nn.Linear(i, o, bias=False, **kw)  # noqa: E731
    return plain, plain


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        self.tp = _use_tp(config)
        col, row = _linears(self.tp, device, dtype)
        self.gate_proj = col(h, i)
        self.up_proj = col(h, i)
        self.down_proj = row(i, h)

    def forward(self, x, lora=None):
        if self.tp:
            # rank r: its gate/up column blocks, then its down_proj partial
            # (LoRA deltas on its shards); the partials meet in the reduce
            parts = []
            for r in range(self.gate_proj.ranks):
                g = _lora_add(lora, "gate_proj", self.gate_proj.rank_output(x, r), x, r)
                u = _lora_add(lora, "up_proj", self.up_proj.rank_output(x, r), x, r)
                h = F.silu(g) * u
                parts.append(_lora_add(lora, "down_proj",
                                       self.down_proj.partial(h, r), h, r))
            return self.down_proj.reduce(parts)
        h = (F.silu(_lora_add(lora, "gate_proj", self.gate_proj(x), x))
             * _lora_add(lora, "up_proj", self.up_proj(x), x))
        return _lora_add(lora, "down_proj", self.down_proj(h), h)


def _paged_read_tp(qs, views, pos, max_len, table=None):
    """Rank r's paged attention of qs[r] over views[r]'s arena shard, every
    rank's in one call: `paged_decode_tp` (K2 per head shard) or, over int8
    pages, `paged_decode_q8_tp` (K4); the "gather" oracle per rank.  The
    ranks share the page table and positions."""
    v0 = views[0]
    tables = v0.tables if table is None else table
    if v0.kernel == "gather":
        return [paged_decode_attention(q, v.arena.k, v.arena.v, tables, pos, max_len,
                                       kernel="gather", k_scale=v.arena.k_scale,
                                       v_scale=v.arena.v_scale)
                for q, v in zip(qs, views)]
    ks = [v.arena.k for v in views]
    vs = [v.arena.v for v in views]
    if v0.arena.quant == "int8":
        return paged_decode_q8_tp(qs, ks, vs, [v.arena.k_scale for v in views],
                                  [v.arena.v_scale for v in views], tables, pos,
                                  max_len)
    return paged_decode_tp(qs, ks, vs, tables, pos, max_len)


class LlamaAttention(nn.Module):
    def __init__(self, config, rope, device=None, dtype=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        self.tp = _use_tp(config)
        col, row = _linears(self.tp, device, dtype)
        self.q_proj = col(h, h)
        self.k_proj = col(h, kv_out)
        self.v_proj = col(h, kv_out)
        self.o_proj = row(h, h)
        self.rope = rope  # (cos, sin), shared by every layer

    def forward(self, x, cache=None, pos=None, lora=None):
        """`lora`: a per-layer arena view (serving under LoRA): q, k and v
        take their deltas before RoPE, o_proj after attention, as in the
        reference (llama.py:564-691)."""
        if self.tp:
            return self._forward_tp(x, cache, pos, lora)
        b, s = x.shape[0], x.shape[1]
        q = _lora_add(lora, "q_proj", self.q_proj(x), x).view(
            b, s, self.num_heads, self.head_dim)
        k = _lora_add(lora, "k_proj", self.k_proj(x), x).view(
            b, s, self.num_kv_heads, self.head_dim)
        v = _lora_add(lora, "v_proj", self.v_proj(x), x).view(
            b, s, self.num_kv_heads, self.head_dim)
        q, k = self._write(q, k, v, cache, pos)
        out = self._read(q, k, v, cache, pos)
        out = out.reshape(b, s, self.num_heads * self.head_dim)
        return _lora_add(lora, "o_proj", self.o_proj(out), out)

    def _forward_tp(self, x, cache, pos, lora):
        """Tensor parallelism: rank r runs q heads [r*h/N, (r+1)*h/N) and kv
        heads [r*hk/N, (r+1)*hk/N) -- the rep-block of its kv heads, so each
        q head stays with its kv head under GQA -- with RoPE, the writes into
        its own arena shard (`cache[r]`, one view per rank) and attention
        over its heads: a fresh prefill through K1, a decode step, verify
        window or chunk prefill through K2 (K4 over int8 pages), one launch
        per rank.  The ranks' o_proj partials meet in the reduce."""
        b, s = x.shape[0], x.shape[1]
        R = self.q_proj.ranks
        hq, hk, d = self.num_heads // R, self.num_kv_heads // R, self.head_dim
        if cache is None or isinstance(cache, list):
            views = [None] * R if cache is None else cache
        elif R == 1:  # one rank over a whole cache (an engine at tp 1)
            views = [cache]
        else:
            raise TypeError(
                f"a model on {R} 'mp' ranks takes one cache view per rank")
        qs, ks, vs = [], [], []
        for r in range(R):
            q = _lora_add(lora, "q_proj", self.q_proj.rank_output(x, r), x, r)
            k = _lora_add(lora, "k_proj", self.k_proj.rank_output(x, r), x, r)
            v = _lora_add(lora, "v_proj", self.v_proj.rank_output(x, r), x, r)
            q, k, v = q.view(b, s, hq, d), k.view(b, s, hk, d), v.view(b, s, hk, d)
            q, k = self._write(q, k, v, views[r], pos)
            qs.append(q)
            ks.append(k)
            vs.append(v)
        v0 = views[0]
        if isinstance(v0, PagedDecodeView):
            outs = _paged_read_tp(qs, views, pos, v0.max_len)
        elif isinstance(v0, PagedPrefillView) and v0.start is not None:
            outs = _paged_read_tp(qs, views, v0.start, v0.max_len,
                                  table=v0.table.reshape(1, -1))
        else:
            outs = [self._read(q, k, v, c, pos)
                    for q, k, v, c in zip(qs, ks, vs, views)]
        parts = []
        for r, out in enumerate(outs):
            out = out.reshape(b, s, hq * d)
            parts.append(_lora_add(lora, "o_proj", self.o_proj.partial(out, r), out, r))
        return self.o_proj.reduce(parts)

    def _write(self, q, k, v, cache, pos):
        """RoPE on q and k at the cache view's positions and the K/V writes
        into the view's arena or cache.  Returns the rotated (q, k)."""
        cos, sin = self.rope
        if isinstance(cache, PagedPrefillView):
            a = cache.arena
            if a.quant == "int8":
                # the scatter quantizes on write; a fresh prefill's own
                # attention still runs on the full-precision k/v
                return _rope_page_scatter_quant(
                    a.k, a.v, a.k_scale, a.v_scale, q, k, v, cos, sin,
                    cache.table, cache.true_len, cache.start,
                )
            return _rope_page_scatter(a.k, a.v, q, k, v, cos, sin, cache.table,
                                      cache.true_len, cache.start)
        if isinstance(cache, PagedDecodeView):
            a = cache.arena
            q, k = apply_rotary_pos_emb(q, k, cos, sin, pos)
            if a.quant == "int8":
                _page_decode_write_quant(a.k, a.k_scale, k, cache.tables, pos)
                _page_decode_write_quant(a.v, a.v_scale, v, cache.tables, pos)
            else:
                _page_decode_write(a.k, k, cache.tables, pos)
                _page_decode_write(a.v, v, cache.tables, pos)
            return q, k
        if isinstance(cache, SlotView):
            q, k = apply_rotary_pos_emb(q, k, cos, sin, 0)
            _slot_write(cache.pool.k, k, cache.slot)
            _slot_write(cache.pool.v, v, cache.slot)
            return q, k
        if isinstance(cache, StaticKVCache):
            q, k = apply_rotary_pos_emb(q, k, cos, sin, pos)
            _cache_write(cache.k, k, pos)
            _cache_write(cache.v, v, pos)
            return q, k
        if cache is None:
            return apply_rotary_pos_emb(q, k, cos, sin, 0)
        raise TypeError(f"unsupported cache view {type(cache).__name__}")

    def _read(self, q, k, v, cache, pos):
        """Attention of the rotated q over what `_write` left: [b, s, heads,
        d]."""
        if isinstance(cache, PagedPrefillView):
            a = cache.arena
            if cache.start is None:
                return sdpa(q, k, v, causal=True)
            # chunk prefill: the suffix attends the whole sequence through
            # the pages, its own rows written just above
            return paged_decode_attention(
                q, a.k, a.v, cache.table.reshape(1, -1), cache.start,
                cache.max_len, kernel=cache.kernel, k_scale=a.k_scale,
                v_scale=a.v_scale, cp=cache.cp, local=cache.local,
            )
        if isinstance(cache, PagedDecodeView):
            a = cache.arena
            return paged_decode_attention(
                q, a.k, a.v, cache.tables, pos, cache.max_len,
                kernel=cache.kernel, k_scale=a.k_scale, v_scale=a.v_scale,
                cp=cache.cp, local=cache.local,
            )
        if isinstance(cache, SlotView):
            # the slot pool's prefill: the prompt attends to itself through
            # flash_fwd while its K/V land in the slot's pool row
            return sdpa(q, k, v, causal=True)
        if isinstance(cache, StaticKVCache):
            # validity comes from pos (row i sees j <= pos + i), never from
            # a mask array
            return decode_attention(q, cache.k, cache.v, pos, table=cache.table)
        return self._dispatch_attention(q, k, v)

    def _dispatch_attention(self, q, k, v):
        """Route by config (the reference's llama.py:711-745): ring (context
        parallel) > Ulysses (sep) > flash.  Both long-context paths ride the
        'sep' mesh axis and fall back to `sdpa` when the mesh has none."""
        cfg = self.config
        sep_n = _mesh.axis_size("sep")
        want_ring = sep_n > 1 and cfg.context_parallel_degree > 1
        want_ulysses = sep_n > 1 and cfg.sep_degree > 1
        if want_ring or want_ulysses:
            # ring and Ulysses take equal q/k head counts: GQA kv heads are
            # repeated first
            if self.num_kv_heads != self.num_heads:
                rep = self.num_heads // self.num_kv_heads
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
            if want_ring:
                return ring_flash_attention(q, k, v, causal=True)
            if self.num_heads % sep_n == 0:
                return ulysses_attention(q, k, v, causal=True)
            warnings.warn(
                f"sep_degree set but num_attention_heads ({self.num_heads}) is "
                f"not divisible by the sep mesh axis ({sep_n}); falling back "
                "to flash attention"
            )
        return sdpa(q, k, v, causal=True)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, rope, device=None, dtype=None):
        super().__init__()
        self.config = config
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, rope, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, eps, device, dtype
        )
        self.mlp = LlamaMLP(config, device, dtype)

    def _block(self, x, cache=None, pos=None, lora=None):
        h = x + self.self_attn(self.input_layernorm(x), cache, pos, lora=lora)
        return h + self.mlp(self.post_attention_layernorm(h), lora=lora)

    def forward(self, x, cache=None, pos=None, lora=None):
        if cache is None and self.config.use_recompute and self.training:
            # reference: llama.py:769-772 (incubate/recompute.py:47)
            return recompute(self._block, x)
        return self._block(x, cache, pos, lora)


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        rope = rope_cache(config, device)
        emb = VocabParallelEmbedding if _use_tp(config) else nn.Embedding
        self.embed_tokens = emb(
            config.vocab_size, config.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, rope, device, dtype)
             for _ in range(config.num_hidden_layers)]
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device, dtype)

    def forward(self, input_ids, caches=None, pos=None, lora=None):
        """input_ids: [b, s] int32.  `caches`: None (plain causal forward)
        or one cache view per layer (paged views, `SlotView`s or
        `StaticKVCache`s; under tensor parallelism a list of the ranks'
        views per layer, rank r's over its arena shard); `pos`: [b] int32 positions for decode views, the
        chunk's position for a `StaticKVCache` (a 0-d int32 tensor or int,
        or [b] per slot).  `lora`: an adapter arena's view of the rows'
        arena slots (`lora.AdapterArena.view`), or None.  Returns the final
        hidden states [b, s, hidden]."""
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, None if caches is None else caches[i], pos,
                      None if lora is None else lora.layer(i))
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM.  `device=None` means the CUDA card (raises when CUDA
    is absent; pass device="cpu" for the plain PyTorch path).  Weights are
    random, drawn from a torch.Generator seeded with `seed` on the model's
    device (reference-style Xavier-normal Linears, normal embeddings); load
    real or reference weights with `models.convert`.

    Built with `tensor_parallel_degree` > 1 (or under an installed mesh
    whose 'mp' axis is), the projections are `ColumnParallelLinear` (q, k,
    v, gate, up) and `RowParallelLinear` (o, down), the embedding and the
    lm_head split over the vocabulary (reference: llama.py:521-830): the same
    parameter names, shapes and seeded values as the one-rank model, and
    until `shard_llama_for_tp` binds it to an 'mp' mesh it runs as one rank.
    `logits` gathers the lm_head's vocabulary blocks."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.llama = LlamaModel(config, device, dtype)
        if _use_tp(config):
            # the vocabulary-split head; the sharded log-sum-exp loss
            self.lm_head = ColumnParallelLinear(
                config.hidden_size, config.vocab_size, has_bias=False,
                gather_output=False, device=device, dtype=dtype)
            self.parallel_ce = ParallelCrossEntropy(ignore_index=-100)
        else:
            self.lm_head = nn.Linear(
                config.hidden_size, config.vocab_size, bias=False, device=device,
                dtype=dtype,
            )
            self.parallel_ce = None
        self.init_weights(seed)
        self.eval()

    @property
    def device(self):
        return self.lm_head.weight.device

    @property
    def tp_ranks(self):
        """The ranks the model runs on: the 'mp' degree it is bound to, 1
        for a model without tensor parallelism."""
        return self.lm_head.ranks if self.parallel_ce is not None else 1

    def logits(self, hidden):
        """The lm_head's logits of hidden [..., hidden_size]: [..., vocab],
        the ranks' vocabulary blocks gathered under tensor parallelism."""
        out = self.lm_head(hidden)
        return self.lm_head.gather(out) if isinstance(out, list) else out

    @torch.no_grad()
    def init_weights(self, seed):
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                fan_out, fan_in = mod.weight.shape
                mod.weight.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                                   generator=gen)
            elif isinstance(mod, nn.Embedding):
                mod.weight.normal_(0.0, 1.0, generator=gen)
            elif isinstance(mod, RMSNorm):
                mod.weight.fill_(1.0)

    def forward(self, input_ids, labels=None):
        """Full-sequence causal forward: logits [b, s, vocab].  With
        `labels` ([b, s] ids, -100 ignored) returns (loss, logits), the loss
        the mean cross-entropy of `sequence_ce` on float32 logits at the
        same positions (no shift; reference llama.py:833-839)."""
        hidden = self.llama(input_ids)
        if self.parallel_ce is None:
            logits = self.lm_head(hidden)
            return logits if labels is None else (sequence_ce(logits, labels), logits)
        parts = self.lm_head(hidden)
        logits = self.lm_head.gather(parts)
        if labels is None:
            return logits
        # the reference's sequence_ce through ParallelCrossEntropy: the mean
        # over the tokens whose label is not -100
        per_tok = self.parallel_ce(parts, labels)[..., 0]
        valid = (labels != -100).sum().clamp(min=1).float()
        return per_tok.sum() / valid, logits

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens=16, temperature=0.0, top_k=0,
                 top_p=1.0, decode_strategy=None, num_beams=1, seed=None,
                 eos_token_id=None, length_penalty=0.0):
        """Greedy, sampling or beam search over per-layer static KV caches
        (reference: llama.py:841, through `_utils.lockstep_generate`): the
        prompt [b, s0] is prefilled at position 0 in one step (`dense_decode`
        for s0 >= 64), then one decode step per token.  Returns prompt +
        generated ids [b, s0 + n] on the model's device."""

        def forward_step(toks, caches, pos):
            hidden = self.llama(toks, caches=caches, pos=pos)
            return self.logits(hidden[:, -1])

        return lockstep_generate(
            self, input_ids, max_new_tokens, temperature, forward_step,
            kv_heads=self.config.num_key_value_heads, top_k=top_k, top_p=top_p,
            decode_strategy=decode_strategy, num_beams=num_beams, seed=seed,
            eos_token_id=eos_token_id, length_penalty=length_penalty,
        )


def shard_llama_for_tp(model, mesh=None):
    """Bind a tensor-parallel Llama's parallel layers to the 'mp' axis of
    `mesh` (default: the installed mesh; reference: llama.py:862-906): rank
    r then computes with its column and row blocks of every projection, its
    vocabulary block of the embedding and the lm_head.  The blocks are views
    of the model's weights, so binding copies nothing.  Without a mesh
    whose 'mp' axis is above 1 the layers run as one rank; a model without
    parallel layers is left as it is.  The mesh's ranks must be on the
    model's device.  Returns the model."""
    mesh = _mesh.get_mesh() if mesh is None else mesh
    if mesh is not None and mesh.mp > 1 and mesh.device != model.device:
        raise ValueError(
            f"the 'mp' ranks run on {mesh.device} but the model lives on "
            f"{model.device}")
    sharded = (ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding)
    for mod in model.modules():
        if isinstance(mod, sharded):
            mod.shard(mesh)
    return model


def to_index_tensor(x, device):
    """Host ids/positions/tables -> int32 tensor on `device`."""
    return torch.as_tensor(np.asarray(x), dtype=INDEX_DTYPE).to(device)
