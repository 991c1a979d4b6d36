"""Functional ops of the port (counterpart of
`paddle_tpu/nn/functional/__init__.py`), as far as BERT and the
transformer layers use them.

The reference's AMP casts at dispatch (white-list ops take the AMP dtype,
black-list ops float32); the port makes those casts here, where they land:
`layer_norm` takes its statistics in float32 and returns the activation
dtype (under `amp.auto_cast` its bf16 / fp16 inputs go to float32 first),
`cross_entropy` works on float32 logits.
"""

from __future__ import annotations

import numbers

import torch
from torch.nn import functional as F

from ..framework.core import amp_cast
from ..ops.flash_attention import NEG_INF, sdpa


def gelu(x, approximate=False):
    """GELU (reference :58, `jax.nn.gelu`): the exact erf form, or the tanh
    approximation with `approximate`."""
    return F.gelu(x, approximate="tanh" if approximate else "none")


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """Layer normalisation over the trailing `normalized_shape` dims
    (reference :695): mean and biased variance in float32, the normalised
    value cast back to x's dtype, then times the weight and plus the bias,
    both cast to that dtype (float32 norm parameters never promote a bf16
    stream)."""
    if isinstance(normalized_shape, numbers.Integral):
        normalized_shape = (int(normalized_shape),)
    dims = tuple(range(-len(tuple(normalized_shape)), 0))
    # a black op under amp.auto_cast: bf16 / fp16 inputs in float32
    x, weight, bias = (amp_cast("layer_norm", t) for t in (x, weight, bias))
    x32 = x.float()
    mean = x32.mean(dim=dims, keepdim=True)
    var = x32.var(dim=dims, unbiased=False, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).to(x.dtype)
    if weight is not None:
        out = out * weight.to(x.dtype)
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            generator=None):
    """Dropout (reference :942).  Keeps each entry (or, with `axis`, each
    slice along those axes) with probability 1 - p, drawn from the
    torch.Generator `generator` on x's device (None: torch's default);
    "upscale_in_train" divides the kept entries by 1 - p, and at inference
    "downscale_in_infer" multiplies by 1 - p.  JAX's keys and torch's
    generators draw different masks from one seed."""
    if mode not in ("upscale_in_train", "downscale_in_infer"):
        raise ValueError(f"dropout mode must be upscale_in_train or "
                         f"downscale_in_infer, got {mode!r}")
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * (1 - p)
        return x
    if p == 1.0:
        return torch.zeros_like(x)
    shape = list(x.shape)
    if axis is not None:
        axes = [axis] if isinstance(axis, int) else list(axis)
        shape = [n if i in axes else 1 for i, n in enumerate(shape)]
    keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
    if mode == "upscale_in_train":
        return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)
    return torch.where(keep, x, 0.0).to(x.dtype)


_NOT_PORTED = ("is not ported yet (ROADMAP.md Queue 1, slice 6: the rest of "
               "the surface)")


def cross_entropy(input, label, weight=None, ignore_index=-100, reduction="mean",
                  soft_label=False, axis=-1, use_softmax=True, label_smoothing=0.0):
    """Softmax cross-entropy over the last axis with integer labels, as
    BERT's heads use it (reference :1007): float32 log-softmax, each loss
    clamped at 0, labels equal to `ignore_index` left out; "mean" divides by
    max(valid count, 1).  Returns float32.  Class weights, soft labels,
    another axis, `use_softmax=False` and label smoothing raise."""
    if weight is not None or soft_label or axis not in (-1, input.dim() - 1) \
            or not use_softmax or label_smoothing:
        raise NotImplementedError(
            "cross_entropy with class weights, soft labels, another axis, "
            f"use_softmax=False or label smoothing {_NOT_PORTED}")
    logits = input.float()
    idx = label.long()
    if idx.dim() == logits.dim() and idx.shape[-1] == 1:
        idx = idx.squeeze(-1)
    valid = idx != ignore_index
    safe = torch.where(valid, idx, 0)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, safe[..., None])[..., 0]
    loss = torch.where(valid, (lse - picked).clamp(min=0.0), 0.0)
    if reduction == "mean":
        return loss.sum() / valid.sum().clamp(min=1).float()
    if reduction == "sum":
        return loss.sum()
    if reduction == "none":
        return loss
    raise ValueError(f"reduction must be mean, sum or none, got {reduction!r}")


def scaled_dot_product_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, segment_ids=None,
                                 generator=None):
    """Attention on [batch, seq, heads, head_dim] (reference :1332, through
    `ops/flash_attention.py:2098`).  A boolean `attn_mask` (True: attend)
    becomes additive (0 or NEG_INF); `segment_ids` ([b, s]) confine each
    query to keys of its own id.  Both reach the `flash_fwd`/`flash_bwd`
    kernels when the mask is a key-padding one (`ops.flash_attention.sdpa`
    decides).  With `dropout_p` in training, the output (as in the
    reference, not the probabilities) goes through `dropout`."""
    if attn_mask is not None and attn_mask.dtype == torch.bool:
        attn_mask = torch.where(attn_mask, 0.0, NEG_INF).to(torch.float32)
    out = sdpa(query, key, value, attn_mask, is_causal, segment_ids=segment_ids)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=training, generator=generator)
    return out


__all__ = ["gelu", "layer_norm", "dropout", "cross_entropy",
           "scaled_dot_product_attention"]
