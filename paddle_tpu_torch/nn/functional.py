"""Functional ops of the port (counterpart of
`paddle_tpu/nn/functional/__init__.py`), as far as BERT, the transformer
layers and the vision models (LeNet, ResNet, VGG) use them.

The reference's AMP casts at dispatch (white-list ops take the AMP dtype,
black-list ops float32); the port makes those casts here, where they land:
`layer_norm` takes its statistics in float32 and returns the activation
dtype (under `amp.auto_cast` its bf16 / fp16 inputs go to float32 first),
`cross_entropy` works on float32 logits, the convolutions cast their
inputs to the AMP dtype under the active AMP state (`amp.auto_cast`, or a
model's forward after `amp.decorate(level="O2")`), and `batch_norm` takes
its weight and bias in float32 whatever the activation's dtype.

The convolutions, pools and norms run as torch ops (cuDNN on the card),
as the reference runs them as XLA ops, with the reference's semantics
where torch's differ:

- padding: an int or a tuple, "SAME" / "VALID" at any stride and dilation
  (lax's rule: total = max((ceil(in / s) - 1) s + (k - 1) d + 1 - in, 0),
  low = total // 2), `[lo, hi]` pairs, paddle's 4-pair lists in the data
  layout's order; an asymmetric pad (or a pool pad past k / 2) is an
  explicit `F.pad` before a conv or pool with none;
- `data_format` "NHWC" (`NLC`, `NDHWC`): a logical channels-last tensor,
  with OIHW conv weights in both layouts; the op runs on the permuted
  (channels_last) view;
- the conv bias is added after the conv; max pools pad with -inf;
  `exclusive` average pools divide by the count of real elements, "SAME"
  by k^d, `avg_pool1d` always by k (reference :625);
- `batch_norm`: paddle's momentum (running = m running + (1 - m) batch),
  the unbiased variance in the running statistics, statistics and the
  per-channel scale and shift in float32, the output in the input's dtype.

The reference rewrites a strided conv on a 3-channel stem as
space-to-depth plus a dense conv (`_space_to_depth_plan`, :342-408), a
relayout for the TPU's matrix unit; cuDNN picks its own stem kernels for
the same conv, so the port does not carry it.

Arguments the reference takes and silently ignores raise
NotImplementedError naming them when given a value other than the
default (`ceil_mode`, `return_mask`, the channels-last `data_format` of the
ops that assume channels-first, `group_norm`'s and `instance_norm`'s), so
a caller never gets something other than what it asked for.
"""

from __future__ import annotations

import math
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


def mse_loss(input, label, reduction="mean", name=None):
    """Squared error with the label cast to the input's dtype (reference
    :1118): its mean, sum, or the elementwise values for "none"."""
    d = torch.square(input - label.to(input.dtype))
    if reduction == "mean":
        return d.mean()
    if reduction == "sum":
        return d.sum()
    return d


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


def relu(x, name=None):
    return F.relu(x)


# ---------------------------------------------------------------------------
# padding forms (reference :269-292, _pool2d_spec :544-568)
# ---------------------------------------------------------------------------


def _refuse(what, value, default, lines):
    """NotImplementedError for an argument the reference takes and ignores
    (ROADMAP.md Queue 3), when it is given a value other than the default."""
    if value != default:
        raise NotImplementedError(
            f"{what}={value!r} is not accepted: the reference takes it and "
            f"ignores it (paddle_tpu/nn/{lines}), so accepting it would "
            "silently do something other than what was asked")


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _conv_padding(padding, nsp, channels_last=False):
    """"SAME" / "VALID", or one (lo, hi) pair per spatial dim.  A list with
    a pair per dim of the tensor is in the data layout's order (the
    spatial pairs are [2:] channels-first, [1:-1] channels-last); the
    reference's conv reads the last `nsp` pairs whatever the layout
    (ROADMAP.md Queue 3)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, (list, tuple)) and len(padding) \
            and isinstance(padding[0], (list, tuple)):
        pairs = [tuple(int(x) for x in p) for p in padding]
        if len(pairs) == nsp:
            return pairs
        if channels_last and len(pairs) == nsp + 2:
            return pairs[1:-1]
        return pairs[-nsp:]
    p = _tuplize(padding, nsp)
    if len(p) == 2 * nsp:
        return [(p[2 * i], p[2 * i + 1]) for i in range(nsp)]
    return [(pi, pi) for pi in p]


def _explicit_pads(pad, sizes, strides, kernel, dilation):
    """lax's padding: "SAME" keeps ceil(in / s) outputs, the odd pixel on
    the high side; "VALID" none; explicit pairs as they are."""
    if pad == "VALID":
        return [(0, 0)] * len(sizes)
    if pad == "SAME":
        pairs = []
        for n, s, k, d in zip(sizes, strides, kernel, dilation):
            total = max((-(-n // s) - 1) * s + (k - 1) * d + 1 - n, 0)
            pairs.append((total // 2, total - total // 2))
        return pairs
    if isinstance(pad, str):
        raise ValueError(f"padding must be SAME, VALID or explicit, got {pad!r}")
    return list(pad)


def _flat_pads(pairs):
    """(lo, hi) per spatial dim -> F.pad's list, last dim first."""
    return [v for lo_hi in reversed(pairs) for v in lo_hi]


def _channels_first(x, channels_last):
    return x.movedim(-1, 1) if channels_last else x


def _layout_back(y, channels_last):
    return y.movedim(1, -1) if channels_last else y


def _channels_last(data_format, nsp):
    """True for NLC / NHWC / NDHWC, False for NCL / NCHW / NCDHW."""
    forms = {1: ("NCL", "NLC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}[nsp]
    if data_format not in forms:
        raise ValueError(f"data_format must be one of {forms}, got {data_format!r}")
    return data_format == forms[1]


# ---------------------------------------------------------------------------
# convolution (reference :295, :411, :435, :458, :1499, :1918)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _add_bias(out, bias):
    return out if bias is None else out + bias.reshape((1, -1) + (1,) * (out.dim() - 2))


def _conv(op, nsp, x, weight, bias, stride, padding, dilation, groups, data_format):
    """conv{1,2,3}d: the reference's padding forms on torch's conv, the
    bias added after it; weights [out, in / groups, *k] in both layouts."""
    cl = _channels_last(data_format, nsp)
    x, weight, bias = (amp_cast(op, t) for t in (x, weight, bias))
    strides, dil = _tuplize(stride, nsp), _tuplize(dilation, nsp)
    x = _channels_first(x, cl)
    pairs = _explicit_pads(_conv_padding(padding, nsp, cl), x.shape[2:], strides,
                           weight.shape[2:], dil)
    if all(lo == hi >= 0 for lo, hi in pairs):
        pad = tuple(lo for lo, _ in pairs)
    else:
        x, pad = F.pad(x, _flat_pads(pairs)), 0
    out = _CONV[nsp](x, weight, None, strides, pad, dil, groups)
    return _layout_back(_add_bias(out, bias), cl)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    """1-D convolution (reference :411); "NLC" takes the same [out, in /
    groups, k] weight (the reference reads it as [k, in, out] there,
    ROADMAP.md Queue 3)."""
    return _conv("conv1d", 1, x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    """2-D convolution (reference :295)."""
    return _conv("conv2d", 2, x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    """3-D convolution (reference :435, which assumes NCDHW)."""
    _refuse("conv3d data_format", data_format, "NCDHW", "functional/__init__.py:435-455")
    return _conv("conv3d", 3, x, weight, bias, stride, padding, dilation, groups,
                 data_format)


def _conv_transpose(op, nsp, x, weight, bias, stride, pairs, opad, groups, dilation):
    """The transposed conv the reference computes as a conv of the
    stride-dilated input, padded (d (k - 1) - lo, d (k - 1) - hi + opad),
    with the flipped kernel: torch's transposed conv, cropped (or padded
    with zeros) to those pads.  `pairs`: (lo, hi) per dim, or "SAME" /
    "VALID" at stride 1 (lax's padding of that conv; lax refuses a string
    with a dilated input, so the reference cannot take one at a larger
    stride).  Weights [in, out / groups, *k]."""
    x, weight, bias = (amp_cast(op, t) for t in (x, weight, bias))
    strides, dil = _tuplize(stride, nsp), _tuplize(dilation, nsp)
    if isinstance(pairs, str):
        if any(s != 1 for s in strides):
            raise NotImplementedError(
                f"{op}: string padding at a stride above 1 is unsupported (the "
                "reference's lax conv refuses it)")
        reach = [d * (k - 1) for d, k in zip(dil, weight.shape[2:])]
        eff = _explicit_pads(pairs, x.shape[2:], strides, [r + 1 for r in reach], strides)
        pairs, opad = [(r - lo, r - hi) for r, (lo, hi) in zip(reach, eff)], (0,) * nsp
    crops = [(lo, hi - op) for (lo, hi), op in zip(pairs, opad)]
    if all(lo >= 0 and 0 <= lo - hi < max(s, d)
           for (lo, hi), s, d in zip(crops, strides, dil)):
        out = _CONV_T[nsp](x, weight, None, strides, [lo for lo, _ in crops],
                           [lo - hi for lo, hi in crops], groups, dil)
    else:
        out = _CONV_T[nsp](x, weight, None, strides, 0, 0, groups, dil)
        out = F.pad(out, [-c for c in _flat_pads(crops)])
    return _add_bias(out, bias)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCHW", output_size=None,
                     name=None):
    """2-D transposed convolution (reference :458, which assumes NCHW);
    `output_size` picks the output padding that reaches it."""
    _refuse("conv2d_transpose data_format", data_format, "NCHW",
            "functional/__init__.py:458-541")
    strides, dil = _tuplize(stride, 2), _tuplize(dilation, 2)
    pad = _conv_padding(padding, 2)
    if output_size is not None:
        if isinstance(pad, str):
            raise NotImplementedError(
                "conv2d_transpose output_size with string padding is unsupported")
        osz = _tuplize(output_size, 2)
        opad = []
        for i in range(2):
            k, insz = int(weight.shape[2 + i]), int(x.shape[2 + i])
            base = (insz - 1) * strides[i] - pad[i][0] - pad[i][1] + dil[i] * (k - 1) + 1
            extra = int(osz[i]) - base
            if not 0 <= extra < strides[i]:
                raise ValueError(f"requested output_size[{i}]={osz[i]} unreachable "
                                 f"(valid range [{base}, {base + strides[i]}))")
            opad.append(extra)
        output_padding = tuple(opad)
    return _conv_transpose("conv2d_transpose", 2, x, weight, bias, strides, pad,
                           _tuplize(output_padding, 2), groups, dil)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCL", output_size=None,
                     name=None):
    """1-D transposed convolution (reference :1499): NCL, explicit
    padding (an int, [v], [lo, hi] or pairs, the last pair taken)."""
    if output_size is not None:
        raise NotImplementedError(
            "conv1d_transpose output_size is not supported; use "
            "output_padding to resolve the stride ambiguity")
    if data_format != "NCL":
        raise NotImplementedError("conv1d_transpose supports NCL layout only")
    if isinstance(padding, str):
        raise NotImplementedError(
            "conv1d_transpose does not support string padding; pass "
            "explicit int/[lo, hi] padding")
    if isinstance(padding, (list, tuple)):
        if len(padding) == 1:
            pair = (int(padding[0]),) * 2
        elif all(isinstance(e, (list, tuple)) and len(e) == 2 for e in padding):
            pair = tuple(int(v) for v in padding[-1])
        elif len(padding) == 2:
            pair = (int(padding[0]), int(padding[1]))
        else:
            raise ValueError(f"conv1d_transpose pad={padding!r} not understood")
    else:
        pair = (int(padding),) * 2
    return _conv_transpose("conv1d_transpose", 1, x, weight, bias, stride, [pair],
                           _tuplize(output_padding, 1), groups, dilation)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0, output_padding=0,
                     groups=1, dilation=1, data_format="NCDHW", output_size=None,
                     name=None):
    """3-D transposed convolution (reference :1918, which assumes NCDHW):
    explicit padding, one group."""
    _refuse("conv3d_transpose data_format", data_format, "NCDHW",
            "functional/__init__.py:1918-1963")
    if groups != 1:
        raise NotImplementedError("conv3d_transpose: groups > 1 not supported")
    if output_size is not None:
        raise NotImplementedError(
            "conv3d_transpose: output_size not supported; use output_padding")
    pad = _conv_padding(padding, 3)
    if isinstance(pad, str):
        raise NotImplementedError("conv3d_transpose: string padding unsupported")
    return _conv_transpose("conv3d_transpose", 3, x, weight, bias, stride, pad,
                           _tuplize(output_padding, 3), groups, dilation)


# ---------------------------------------------------------------------------
# pooling (reference :544-690, :1859-1916, :1966)
# ---------------------------------------------------------------------------

_MAX_POOL = {2: F.max_pool2d, 3: F.max_pool3d}
_AVG_POOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_geometry(x, kernel_size, stride, padding, nsp, cl):
    """(x channels-first, window, strides, (lo, hi) pads, whether the
    padding was a string).  1-D pools run as 2-D ones over a unit dim."""
    k = _tuplize(kernel_size, nsp)
    s = _tuplize(stride if stride is not None else kernel_size, nsp)
    x = _channels_first(x, cl)
    pad = _conv_padding(padding, nsp, cl)
    pairs = _explicit_pads(pad, x.shape[2:], s, k, (1,) * nsp)
    if nsp == 1:
        x, k, s, pairs = x.unsqueeze(2), (1,) + k, (1,) + s, [(0, 0)] + pairs
    return x, k, s, pairs, isinstance(pad, str)


def _torch_pads(pairs, k):
    """The symmetric pads torch's pools take (each at most k / 2), or None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pairs, k)):
        return [lo for lo, _ in pairs]
    return None


def _max_pool(nsp, x, kernel_size, stride, padding, cl):
    x, k, s, pairs, _ = _pool_geometry(x, kernel_size, stride, padding, nsp, cl)
    pad = _torch_pads(pairs, k)
    if pad is None:
        fill = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        x, pad = F.pad(x, _flat_pads(pairs), value=fill), 0
    out = _MAX_POOL[len(k)](x, k, s, pad)
    return _layout_back(out.squeeze(2) if nsp == 1 else out, cl)


def _avg_pool(nsp, x, kernel_size, stride, padding, exclusive, divisor_override, cl):
    """Window sums (zero padding) over the divisor the reference picks:
    `divisor_override`, else the count of real elements when `exclusive`
    and the padding explicit, else the window's size."""
    x, k, s, pairs, is_str = _pool_geometry(x, kernel_size, stride, padding, nsp, cl)
    pool = _AVG_POOL[len(k)]
    exclusive = exclusive and not is_str
    pad = _torch_pads(pairs, k)
    if pad is not None:
        out = pool(x, k, s, pad, count_include_pad=not exclusive,
                   divisor_override=divisor_override or None)
    else:
        flat = _flat_pads(pairs)
        out = pool(F.pad(x, flat), k, s, 0, divisor_override=1)
        if divisor_override:
            out = out / divisor_override
        elif exclusive:
            ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=out.dtype,
                              device=x.device)
            out = out / pool(F.pad(ones, flat), k, s, 0, divisor_override=1)
        else:
            out = out / math.prod(k)
    return _layout_back(out.squeeze(2) if nsp == 1 else out, cl)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, name=None):
    _refuse("max_pool1d return_mask", return_mask, False, "functional/__init__.py:603")
    _refuse("max_pool1d ceil_mode", ceil_mode, False, "functional/__init__.py:603")
    return _max_pool(1, x, kernel_size, stride, padding, False)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCHW", name=None):
    _refuse("max_pool2d ceil_mode", ceil_mode, False, "functional/__init__.py:571")
    _refuse("max_pool2d return_mask", return_mask, False,
            "functional/__init__.py:580-583, a mask of zeros")
    return _max_pool(2, x, kernel_size, stride, padding, _channels_last(data_format, 2))


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW", name=None):
    _refuse("max_pool3d ceil_mode", ceil_mode, False, "functional/__init__.py:1874")
    _refuse("max_pool3d return_mask", return_mask, False,
            "functional/__init__.py:1883-1886, a mask of zeros")
    return _max_pool(3, x, kernel_size, stride, padding, _channels_last(data_format, 3))


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True, ceil_mode=False,
               name=None):
    """Window sums over k whatever `exclusive` says (reference :625)."""
    _refuse("avg_pool1d ceil_mode", ceil_mode, False, "functional/__init__.py:616")
    return _avg_pool(1, x, kernel_size, stride, padding, False, None, False)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCHW", name=None):
    _refuse("avg_pool2d ceil_mode", ceil_mode, False, "functional/__init__.py:586")
    return _avg_pool(2, x, kernel_size, stride, padding, exclusive, divisor_override,
                     _channels_last(data_format, 2))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False, exclusive=True,
               divisor_override=None, data_format="NCDHW", name=None):
    _refuse("avg_pool3d ceil_mode", ceil_mode, False, "functional/__init__.py:1889")
    return _avg_pool(3, x, kernel_size, stride, padding, exclusive, divisor_override,
                     _channels_last(data_format, 3))


def _adaptive_size(output_size, n):
    return _tuplize(output_size, n) if n > 1 else (
        int(output_size[0] if isinstance(output_size, (list, tuple)) else output_size),)


def adaptive_avg_pool1d(x, output_size, name=None):
    """Means over the windows floor(i l / o) to ceil((i + 1) l / o) (the
    reference's, :676; torch's adaptive pools take the same windows)."""
    return F.adaptive_avg_pool1d(x, _adaptive_size(output_size, 1))


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    """Means over the windows floor(i h / o) to max(start + 1, ceil((i + 1)
    h / o)) per axis (reference :630)."""
    cl = _channels_last(data_format, 2)
    out = F.adaptive_avg_pool2d(_channels_first(x, cl), _adaptive_size(output_size, 2))
    return _layout_back(out, cl)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    """NCDHW means over equal windows; sizes the output does not divide
    raise, as in the reference (:1905)."""
    _refuse("adaptive_avg_pool3d data_format", data_format, "NCDHW",
            "functional/__init__.py:1905-1915")
    out = _adaptive_size(output_size, 3)
    if any(n % o for n, o in zip(x.shape[2:], out)):
        raise NotImplementedError("adaptive_avg_pool3d needs divisible sizes")
    return F.adaptive_avg_pool3d(x, out)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    if return_mask:
        raise NotImplementedError("adaptive_max_pool1d: return_mask unsupported")
    return F.adaptive_max_pool1d(x, _adaptive_size(output_size, 1))


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    """NCHW maxima over the adaptive windows (reference :659)."""
    _refuse("adaptive_max_pool2d return_mask", return_mask, False,
            "functional/__init__.py:659-673")
    return F.adaptive_max_pool2d(x, _adaptive_size(output_size, 2))


# ---------------------------------------------------------------------------
# normalization (reference :751-939)
# ---------------------------------------------------------------------------


def batch_norm(x, running_mean, running_var, weight=None, bias=None, training=False,
               momentum=0.9, epsilon=1e-5, data_format="NCHW", use_global_stats=None,
               name=None):
    """Batch normalisation with the reference's semantics (:751): batch
    statistics in training (unless `use_global_stats`), the running ones
    otherwise; in training `running_mean` and `running_var` (float32) move
    to momentum * running + (1 - momentum) * batch, the variance unbiased;
    statistics, scale and shift in float32 (float64 for a float64 x), the
    output in x's dtype.  The
    channel axis is 1 for an "NC..." `data_format`, else the last."""
    ch_last = not (data_format.startswith("NC") and x.dim() > 1)
    stat = torch.float64 if x.dtype == torch.float64 else torch.float32
    weight, bias = (None if t is None else t.to(stat) for t in (weight, bias))
    use_batch = bool(training and not use_global_stats)
    xc = x.movedim(-1, 1) if ch_last and x.dim() > 2 else x
    out = F.batch_norm(xc, running_mean, running_var, weight, bias, use_batch,
                       1.0 - momentum, epsilon)
    return out.movedim(1, -1) if ch_last and x.dim() > 2 else out


def _affine_after_cast(out, weight, bias, dtype):
    """The normalised value in `dtype`, times the weight and plus the bias,
    both cast to `dtype` (reference :872-883)."""
    shape = (1, -1) + (1,) * (out.dim() - 2)
    out = out.to(dtype)
    if weight is not None:
        out = out * weight.reshape(shape).to(dtype)
    if bias is not None:
        out = out + bias.reshape(shape).to(dtype)
    return out


def group_norm(x, num_groups, epsilon=1e-5, weight=None, bias=None,
               data_format="NCHW", name=None):
    """Group normalisation over NC... (reference :859): float32 statistics
    per (sample, group), biased variance."""
    _refuse("group_norm data_format", data_format, "NCHW", "functional/__init__.py:859")
    n = x.shape[0]
    x32 = x.reshape(n, num_groups, -1).float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, unbiased=False, keepdim=True)
    out = ((x32 - mean) * torch.rsqrt(var + epsilon)).reshape(x.shape)
    return _affine_after_cast(out, weight, bias, x.dtype)


def instance_norm(x, running_mean=None, running_var=None, weight=None, bias=None,
                  use_input_stats=True, momentum=0.9, eps=1e-5, data_format="NCHW",
                  name=None):
    """Instance normalisation over NC... (reference :891): float32
    statistics per (sample, channel), biased variance.  The reference takes
    running statistics, `use_input_stats`, `momentum` and `data_format` and
    uses none of them."""
    where = "functional/__init__.py:891-917"
    for what, t in (("running_mean", running_mean), ("running_var", running_var)):
        _refuse(f"instance_norm {what}", "a tensor" if t is not None else None,
                None, where)
    _refuse("instance_norm use_input_stats", use_input_stats, True, where)
    _refuse("instance_norm momentum", momentum, 0.9, where)
    if not data_format.startswith("NC"):
        _refuse("instance_norm data_format", data_format, "NCHW", where)
    x32 = x.float()
    dims = tuple(range(2, x.dim()))
    mean = x32.mean(dims, keepdim=True)
    var = x32.var(dims, unbiased=False, keepdim=True)
    return _affine_after_cast((x32 - mean) * torch.rsqrt(var + eps), weight, bias,
                              x.dtype)


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0, data_format="NCHW",
                        name=None):
    """x / (k + alpha * s) ** beta, s the sum of squares over `size`
    channels around each (reference :920: alpha, not torch's alpha /
    size), in x's dtype, NC... only."""
    _refuse("local_response_norm data_format", data_format, "NCHW",
            "functional/__init__.py:920-939")
    half = size // 2
    sq = F.pad(torch.square(x).movedim(1, -1), (half, size - half - 1)).movedim(-1, 1)
    acc = torch.zeros_like(x)
    for i in range(size):
        acc = acc + sq.narrow(1, i, x.shape[1])
    return x / (k + alpha * acc) ** beta


__all__ = ["gelu", "relu", "layer_norm", "dropout", "cross_entropy", "mse_loss",
           "scaled_dot_product_attention", "conv1d", "conv2d", "conv3d",
           "conv1d_transpose", "conv2d_transpose", "conv3d_transpose", "max_pool1d",
           "max_pool2d", "max_pool3d", "avg_pool1d", "avg_pool2d", "avg_pool3d",
           "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d", "batch_norm", "group_norm",
           "instance_norm", "local_response_norm"]
