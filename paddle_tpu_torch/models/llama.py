"""Llama for the PyTorch/CUDA port (counterpart of
`paddle_tpu/models/llama.py`): the model, rotary embeddings, and the paged
KV views the serving engine drives.

Linear layers are `torch.nn.Linear`, whose weight is `[out, in]`; the
reference stores `[in, out]`, so `models.convert.load_reference_state`
transposes them.  Attention goes through `ops.flash_attention`: the
full-sequence forward and the fresh paged prefill run the `flash_fwd`
kernel, the paged decode step the `paged_decode_fused` kernel.  The paged
cache writes update the arena tensors in place (the reference rebinds new
immutable arrays).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..framework.core import INDEX_DTYPE, resolve_device, to_torch_dtype
from ..nn.norm import RMSNorm
from ..ops.flash_attention import paged_decode_attention, sdpa


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
    there) or a [b] int32 tensor of per-row offsets (the engine's slots,
    each at its own position).  The per-row gather clamps out-of-range
    positions, as the reference's JAX gather does (llama.py:110)."""
    s = q.shape[1]
    if isinstance(position_offset, torch.Tensor) and position_offset.dim() == 1:
        idx = position_offset.long()[:, None] + torch.arange(s, device=q.device)
        idx = idx.clamp(0, cos.shape[0] - 1)
        c = cos[idx][:, :, None, :].to(q.dtype)  # [b, s, 1, d]
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
# paged KV cache
# ---------------------------------------------------------------------------


class PagedKVCache:
    """One layer's paged K/V arena: `[num_pages, page_size, kv_heads,
    head_dim]` tensors addressed through per-slot page tables.  Page 0 is
    scratch: inactive slots' all-zero table rows and every redirected write
    land there (see inference/paging.py)."""

    def __init__(self, num_pages, page_size, kv_heads, head_dim,
                 dtype=torch.float32, device=None):
        self.page_size = int(page_size)
        shape = (int(num_pages), self.page_size, int(kv_heads), int(head_dim))
        self.k = torch.zeros(shape, dtype=dtype, device=device)
        self.v = torch.zeros(shape, dtype=dtype, device=device)


class PagedPrefillView:
    """Fresh prefill into a paged arena: the prompt attends to itself
    causally while its K/V rows scatter into the pages of `table`
    ([max_pages_per_seq] int32 tensor).  Rows at or past `true_len` (bucket
    padding) and rows whose page index overruns the table land on scratch
    page 0."""

    def __init__(self, arena, table, true_len):
        self.arena = arena
        self.table = table
        self.true_len = int(true_len)


class PagedDecodeView:
    """Decode over the paged arena: `tables` is the [slots,
    max_pages_per_seq] int32 page table; slot s writes its token at page
    tables[s, pos // page_size], row pos % page_size, and attends its pages
    through the fused kernel (or the gather oracle)."""

    def __init__(self, arena, tables, max_len, kernel="auto"):
        self.arena = arena
        self.tables = tables
        self.max_len = int(max_len)
        self.kernel = kernel


def _rope_page_scatter(arena_k, arena_v, q, k, v, cos, sin, table, true_len):
    """Prefill cache write (reference: llama.py:311): RoPE on q/k at offset
    0, then row i of the [1, s, kv_heads, d] chunk lands at page
    table[i // page_size], row i % page_size.  Rows with i >= true_len or a
    page index beyond the table go to scratch page 0; several may hit the
    same scratch row, which is harmless because page 0 is never attended
    past the position fence.  Updates the arenas in place; returns
    (q_rot, k_rot)."""
    ps = arena_k.shape[1]
    s = q.shape[1]
    q_rot, k_rot = apply_rotary_pos_emb(q, k, cos, sin, 0)
    i = torch.arange(s, device=q.device)
    entry = i // ps
    P = table.shape[0]
    valid = (i < true_len) & (entry < P)
    pg = torch.where(valid, table.long()[entry.clamp(max=P - 1)], 0)
    row = i % ps
    arena_k[pg, row] = k_rot[0].to(arena_k.dtype)
    arena_v[pg, row] = v[0].to(arena_v.dtype)
    return q_rot, k_rot


def _page_decode_write(arena, new, tables, pos):
    """Decode cache write (reference: llama.py:431): slot s's [sq, kv_heads,
    d] rows land at page tables[s, (pos[s] + i) // page_size], row
    (pos[s] + i) % page_size.  Inactive slots run at pos 0 over an all-zero
    table row, i.e. scratch page 0.  For sq > 1, rows whose page entry
    overruns the table are redirected to scratch.  In place."""
    ps = arena.shape[1]
    t = tables.long()
    p = pos.long()
    if new.shape[1] == 1:
        # pos < pages * page_size by the engine's admission math
        pg = t.gather(1, (p // ps)[:, None])[:, 0]
        arena[pg, p % ps] = new[:, 0].to(arena.dtype)
        return
    sq = new.shape[1]
    idx = p[:, None] + torch.arange(sq, device=p.device)[None, :]
    entry = idx // ps
    P = t.shape[1]
    pg = torch.where(entry < P, t.gather(1, entry.clamp(max=P - 1)), 0)
    arena[pg, idx % ps] = new.to(arena.dtype)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class LlamaMLP(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        h, i = config.hidden_size, config.intermediate_size
        kw = dict(bias=False, device=device, dtype=dtype)
        self.gate_proj = nn.Linear(h, i, **kw)
        self.up_proj = nn.Linear(h, i, **kw)
        self.down_proj = nn.Linear(i, h, **kw)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaAttention(nn.Module):
    def __init__(self, config, rope, device=None, dtype=None):
        super().__init__()
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        kv_out = self.num_kv_heads * self.head_dim
        kw = dict(bias=False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(h, h, **kw)
        self.k_proj = nn.Linear(h, kv_out, **kw)
        self.v_proj = nn.Linear(h, kv_out, **kw)
        self.o_proj = nn.Linear(h, h, **kw)
        self.rope = rope  # (cos, sin), shared by every layer

    def forward(self, x, cache=None, pos=None):
        b, s = x.shape[0], x.shape[1]
        q = self.q_proj(x).view(b, s, self.num_heads, self.head_dim)
        k = self.k_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        v = self.v_proj(x).view(b, s, self.num_kv_heads, self.head_dim)
        cos, sin = self.rope
        if isinstance(cache, PagedPrefillView):
            q, k = _rope_page_scatter(
                cache.arena.k, cache.arena.v, q, k, v, cos, sin, cache.table,
                cache.true_len,
            )
            out = sdpa(q, k, v, causal=True)
        elif isinstance(cache, PagedDecodeView):
            q, k = apply_rotary_pos_emb(q, k, cos, sin, pos)
            _page_decode_write(cache.arena.k, k, cache.tables, pos)
            _page_decode_write(cache.arena.v, v, cache.tables, pos)
            out = paged_decode_attention(
                q, cache.arena.k, cache.arena.v, cache.tables, pos,
                cache.max_len, kernel=cache.kernel,
            )
        elif cache is None:
            q, k = apply_rotary_pos_emb(q, k, cos, sin, 0)
            out = sdpa(q, k, v, causal=True)
        else:
            raise TypeError(f"unsupported cache view {type(cache).__name__}")
        return self.o_proj(out.reshape(b, s, self.num_heads * self.head_dim))


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config, rope, device=None, dtype=None):
        super().__init__()
        eps = config.rms_norm_eps
        self.input_layernorm = RMSNorm(config.hidden_size, eps, device, dtype)
        self.self_attn = LlamaAttention(config, rope, device, dtype)
        self.post_attention_layernorm = RMSNorm(
            config.hidden_size, eps, device, dtype
        )
        self.mlp = LlamaMLP(config, device, dtype)

    def forward(self, x, cache=None, pos=None):
        h = x + self.self_attn(self.input_layernorm(x), cache, pos)
        return h + self.mlp(self.post_attention_layernorm(h))


class LlamaModel(nn.Module):
    def __init__(self, config, device=None, dtype=None):
        super().__init__()
        self.config = config
        rope = rope_cache(config, device)
        self.embed_tokens = nn.Embedding(
            config.vocab_size, config.hidden_size, device=device, dtype=dtype
        )
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, rope, device, dtype)
             for _ in range(config.num_hidden_layers)]
        )
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps, device, dtype)

    def forward(self, input_ids, caches=None, pos=None):
        """input_ids: [b, s] int32.  `caches`: None (plain causal forward)
        or one paged view per layer; `pos`: [b] int32 positions for decode
        views.  Returns the final hidden states [b, s, hidden]."""
        x = self.embed_tokens(input_ids)
        for i, layer in enumerate(self.layers):
            x = layer(x, None if caches is None else caches[i], pos)
        return self.norm(x)


class LlamaForCausalLM(nn.Module):
    """Llama causal LM.  `device=None` means the CUDA card (raises when CUDA
    is absent; pass device="cpu" for the plain PyTorch path).  Weights are
    random, drawn from a torch.Generator seeded with `seed` on the model's
    device (reference-style Xavier-normal Linears, normal embeddings); load
    real or reference weights with `models.convert`."""

    def __init__(self, config, device=None, dtype=torch.float32, seed=0):
        super().__init__()
        device = resolve_device(device)
        dtype = to_torch_dtype(dtype)
        self.config = config
        self.llama = LlamaModel(config, device, dtype)
        self.lm_head = nn.Linear(
            config.hidden_size, config.vocab_size, bias=False, device=device,
            dtype=dtype,
        )
        self.init_weights(seed)
        self.eval()

    @property
    def device(self):
        return self.lm_head.weight.device

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

    def forward(self, input_ids):
        """Full-sequence causal forward: logits [b, s, vocab]."""
        return self.lm_head(self.llama(input_ids))


def to_index_tensor(x, device):
    """Host ids/positions/tables -> int32 tensor on `device`."""
    return torch.as_tensor(np.asarray(x), dtype=INDEX_DTYPE).to(device)
