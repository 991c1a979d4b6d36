"""Transformer layers of the port (counterpart of
`paddle_tpu/nn/transformer.py`): `MultiHeadAttention`,
`TransformerEncoderLayer` and `TransformerEncoder`.

Attention goes through `functional.scaled_dot_product_attention`, so a
key-padding `attn_mask` ([b or 1, 1, 1, s]) or `segment_ids` reach the
`flash_fwd`/`flash_bwd` kernels (as a per-key bias or segment ids); any
other mask takes the reference's XLA path as plain torch ops.  Linear
weights are `[out, in]` (`models.convert.load_reference_state` transposes
the reference's).
"""

from __future__ import annotations

import collections
import copy

from torch import nn

from . import functional as F
from .common import Dropout
from .norm import LayerNorm

_CACHE_NOT_PORTED = ("MultiHeadAttention's Cache and StaticCache are not ported "
                     "yet (ROADMAP.md Queue 1, item 19: the transformer layers' "
                     "incremental caches)")


class MultiHeadAttention(nn.Module):
    """Multi-head attention (reference: nn/transformer.py:27-79) over [b, s,
    embed_dim] inputs: q/k/v projections, `scaled_dot_product_attention`
    (not causal; `attn_mask` and `segment_ids` as it takes them; dropout on
    its output in training), the output projection.  `bias_attr=False`
    drops the biases; `weight_attr` and `need_weights` are accepted and
    unused, as in the reference.  `generator`: the dropout's
    torch.Generator."""

    Cache = collections.namedtuple("Cache", ["k", "v"])
    StaticCache = collections.namedtuple("StaticCache", ["k", "v"])

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None, vdim=None,
                 need_weights=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=None, generator=None):
        super().__init__()
        self.embed_dim = embed_dim
        self.kdim = kdim or embed_dim
        self.vdim = vdim or embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = float(dropout)
        self.need_weights = need_weights
        self.generator = generator
        kw = dict(bias=bias_attr is not False, device=device, dtype=dtype)
        self.q_proj = nn.Linear(embed_dim, embed_dim, **kw)
        self.k_proj = nn.Linear(self.kdim, embed_dim, **kw)
        self.v_proj = nn.Linear(self.vdim, embed_dim, **kw)
        self.out_proj = nn.Linear(embed_dim, embed_dim, **kw)

    def _shape(self, x):
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def gen_cache(self, key, value=None, type=None):
        raise NotImplementedError(_CACHE_NOT_PORTED)

    def forward(self, query, key=None, value=None, attn_mask=None, cache=None,
                segment_ids=None):
        if cache is not None:
            raise NotImplementedError(_CACHE_NOT_PORTED)
        key = query if key is None else key
        value = query if value is None else value
        q = self._shape(self.q_proj(query))
        k = self._shape(self.k_proj(key))
        v = self._shape(self.v_proj(value))
        out = F.scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            is_causal=False, training=self.training, segment_ids=segment_ids,
            generator=self.generator,
        )
        b, s = out.shape[0], out.shape[1]
        return self.out_proj(out.reshape(b, s, self.embed_dim))


class TransformerEncoderLayer(nn.Module):
    """Post-norm (or, with `normalize_before`, pre-norm) encoder layer
    (reference: nn/transformer.py:84-121): self-attention with `src_mask`,
    then a feed-forward of `activation` ("relu" or "gelu"), each with
    dropout and a residual."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 layer_norm_eps=1e-5, device=None, dtype=None, generator=None):
        super().__init__()
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        act_dropout = dropout if act_dropout is None else act_dropout
        self.normalize_before = normalize_before
        kw = dict(device=device, dtype=dtype)
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr,
                                            generator=generator, **kw)
        bias = bias_attr is not False
        self.linear1 = nn.Linear(d_model, dim_feedforward, bias=bias, **kw)
        self.dropout = Dropout(act_dropout, generator=generator)
        self.linear2 = nn.Linear(dim_feedforward, d_model, bias=bias, **kw)
        self.norm1 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.norm2 = LayerNorm(d_model, layer_norm_eps, **kw)
        self.dropout1 = Dropout(dropout, generator=generator)
        self.dropout2 = Dropout(dropout, generator=generator)
        self.activation = nn.ReLU() if activation == "relu" else nn.GELU()

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_CACHE_NOT_PORTED)
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = residual + self.dropout1(self.self_attn(src, src, src, src_mask))
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self.dropout(self.activation(self.linear1(src))))
        src = residual + self.dropout2(src)
        if not self.normalize_before:
            src = self.norm2(src)
        return src

    def gen_cache(self, src):
        raise NotImplementedError(_CACHE_NOT_PORTED)


class TransformerEncoder(nn.Module):
    """`num_layers` copies of `encoder_layer` (the first is the layer
    itself, the rest deep copies, so all start from the same weights, as in
    the reference: nn/transformer.py:124-149), then `norm` if given."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        # the copies share the first layer's dropout generators
        shared = {id(m.generator): m.generator for m in encoder_layer.modules()
                  if getattr(m, "generator", None) is not None}
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer, dict(shared))
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm

    def forward(self, src, src_mask=None, cache=None):
        if cache is not None:
            raise NotImplementedError(_CACHE_NOT_PORTED)
        out = src
        for layer in self.layers:
            out = layer(out, src_mask)
        return out if self.norm is None else self.norm(out)

    def gen_cache(self, src):
        raise NotImplementedError(_CACHE_NOT_PORTED)


__all__ = ["MultiHeadAttention", "TransformerEncoderLayer", "TransformerEncoder"]
