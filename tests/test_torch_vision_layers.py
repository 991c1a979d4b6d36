"""The port's conv functions and layers against the JAX package on the
CPU, and the refusals of the arguments the reference takes and ignores
(the pools and norms: `test_torch_vision_pools_norms.py`).

The same numpy inputs (seeded) go through the reference's function and
the port's, forward and the gradients of sum(out * cot) with respect to
the input and the weight.  Tolerances, float32: convs and transposed
convs 1e-5 (the same sums in another order); pools 1e-6 (one sum or one
max per output); norms 1e-5 (float32 statistics, torch's batch norm
taking them in another order than the reference's shifted single pass).
A channels-last port call is held against the reference's channels-first
call on the transposed data, so each layout meets one semantics.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.nn import functional as JF
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import functional as TF

CONV = dict(atol=1e-5, rtol=1e-5)
POOL = dict(atol=1e-6, rtol=1e-6)
NORM = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX layers draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_REF_CACHE = {}


def _ref(fn, arrays, cot_seed=99, key=None):
    """(out, grads of sum(out * cot) w.r.t. each array) through the JAX
    package; with `key`, computed once per key (the layouts of one case
    share the reference's channels-first run)."""
    if key is not None:
        if key not in _REF_CACHE:
            _REF_CACHE[key] = _ref(fn, arrays, cot_seed)
        return _REF_CACHE[key]
    ts = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]
    out = fn(*ts)
    cot = _rand(out.shape, cot_seed)
    (out * paddle.to_tensor(cot)).sum().backward()
    return out.numpy(), [t.grad.numpy() for t in ts], cot


def _port(fn, arrays, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(np.ascontiguousarray(cot))).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _check(jfn, tfn, arrays, tol, to_port=None, from_port=None, key=None):
    """Hold the port's `tfn` against the reference's `jfn`: forward and
    input gradients.  `to_port` / `from_port` move the first array, the
    output and its cotangent between the reference's layout and the
    port's (channels-first -> channels-last); `key` names the reference's
    run for `_ref`'s cache."""
    out, grads, cot = _ref(jfn, arrays, key=key)
    to_port = to_port or (lambda a: a)
    from_port = from_port or (lambda a: a)
    p_arrays = [to_port(arrays[0])] + list(arrays[1:])
    p_out, p_grads = _port(tfn, p_arrays, to_port(cot))
    np.testing.assert_allclose(from_port(p_out), out, **tol)
    np.testing.assert_allclose(from_port(p_grads[0]), grads[0], **tol)
    for g, r in zip(p_grads[1:], grads[1:]):
        np.testing.assert_allclose(g, r, **tol)


def _cl(nsp):
    """(channels-first -> channels-last, back) for `nsp` spatial dims."""
    return (lambda a: np.ascontiguousarray(np.moveaxis(a, 1, -1)),
            lambda a: np.moveaxis(a, -1, 1))


def _cl_pairs(padding, nsp):
    """A per-dim-of-the-tensor pair list in the channels-last order."""
    if isinstance(padding, list) and len(padding) == nsp + 2 \
            and isinstance(padding[0], list):
        return [padding[0]] + padding[2:] + [padding[1]]
    return padding


# ---------------------------------------------------------------------------
# convolutions
# ---------------------------------------------------------------------------

CONV2D_PADS = [0, 1, (1, 2), [1, 2, 0, 1], [[0, 0], [0, 0], [1, 2], [0, 1]],
               [[2, 0], [1, 1]], "SAME", "VALID"]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", CONV2D_PADS, ids=str)
def test_conv2d_matches_reference(padding, stride, layout):
    """Every padding form at stride 1 (groups 2, dilation (1, 2), bias) and
    stride 2 (no bias, one group), in both layouts."""
    x, w = _rand((2, 4, 9, 8), 1), _rand((6, 2 if stride == 1 else 4, 3, 3), 2)
    kw = (dict(groups=2, dilation=(1, 2)) if stride == 1 else {})
    arrays = [x, w] + ([_rand(6, 3)] if stride == 1 else [])
    jfn = lambda a, b, *c: JF.conv2d(a, b, *c, stride=stride, padding=padding, **kw)
    if layout == "NCHW":
        tfn = lambda a, b, *c: TF.conv2d(a, b, *c, stride=stride, padding=padding, **kw)
        _check(jfn, tfn, arrays, CONV, key=("conv2d", str(padding), stride))
    else:
        pad = _cl_pairs(padding, 2)
        tfn = lambda a, b, *c: TF.conv2d(a, b, *c, stride=stride, padding=pad,
                                         data_format="NHWC", **kw)
        _check(jfn, tfn, arrays, CONV, *_cl(2), key=("conv2d", str(padding), stride))


@pytest.mark.parametrize("layout", ["NCL", "NLC"])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1, [1, 2], [[1, 0]], "SAME", "VALID"], ids=str)
def test_conv1d_matches_reference(padding, stride, layout):
    """conv1d; "NLC" takes the same [out, in, k] weight as "NCL" (the
    reference's NLC reads it as [k, in, out], ROADMAP.md Queue 3), so it
    is held against the reference's NCL."""
    x, w, b = _rand((2, 4, 11), 4), _rand((6, 4, 3), 5), _rand(6, 6)
    jfn = lambda a, c, d: JF.conv1d(a, c, d, stride=stride, padding=padding, dilation=2)
    tfn = lambda a, c, d: TF.conv1d(a, c, d, stride=stride, padding=padding, dilation=2,
                                    data_format=layout)
    _check(jfn, tfn, [x, w, b], CONV, *(_cl(1) if layout == "NLC" else (None, None)),
           key=("conv1d", str(padding), stride))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("padding", [0, 1, [1, 0, 0, 1, 1, 0], "SAME"], ids=str)
def test_conv3d_matches_reference(padding, stride):
    x, w = _rand((1, 2, 5, 6, 5), 7), _rand((3, 2, 3, 2, 3), 8)
    jfn = lambda a, c: JF.conv3d(a, c, stride=stride, padding=padding)
    tfn = lambda a, c: TF.conv3d(a, c, stride=stride, padding=padding)
    _check(jfn, tfn, [x, w], CONV)


@pytest.mark.parametrize("output_padding", [0, 1])
@pytest.mark.parametrize("padding", [0, 1, [1, 2], [1, 2, 0, 1],
                                     [[0, 0], [0, 0], [1, 2], [2, 0]], [[3, 0], [0, 2]]],
                         ids=str)
def test_conv2d_transpose_matches_reference(padding, output_padding):
    """Symmetric pads take torch's transposed conv directly, the others
    its crop or zero extension; with an output padding, two groups and
    dilation 2."""
    groups = 1 + output_padding
    x, w, b = _rand((2, 4, 5, 6), 9), _rand((4, 3, 3, 3), 10), _rand(3 * groups, 11)
    kw = dict(stride=2, padding=padding, output_padding=output_padding, groups=groups,
              dilation=groups)
    _check(lambda a, c, d: JF.conv2d_transpose(a, c, d, **kw),
           lambda a, c, d: TF.conv2d_transpose(a, c, d, **kw), [x, w, b], CONV)


def test_conv2d_transpose_output_size_matches_reference():
    x, w = _rand((1, 3, 5, 5), 12), _rand((3, 2, 3, 3), 13)
    for size in ([9, 9], [10, 10]):
        _check(lambda a, c: JF.conv2d_transpose(a, c, stride=2, padding=1, output_size=size),
               lambda a, c: TF.conv2d_transpose(a, c, stride=2, padding=1, output_size=size),
               [x, w], CONV)
    with pytest.raises(ValueError):
        TF.conv2d_transpose(torch.tensor(x), torch.tensor(w), stride=2, padding=1,
                            output_size=[12, 12])


@pytest.mark.parametrize("output_padding", [0, 1])
@pytest.mark.parametrize("padding", [0, 1, [1, 2], [[0, 0], [2, 0]]], ids=str)
def test_conv1d_transpose_matches_reference(padding, output_padding):
    x, w, b = _rand((2, 3, 7), 14), _rand((3, 4, 3), 15), _rand(4, 16)
    kw = dict(stride=2, padding=padding, output_padding=output_padding)
    _check(lambda a, c, d: JF.conv1d_transpose(a, c, d, **kw),
           lambda a, c, d: TF.conv1d_transpose(a, c, d, **kw), [x, w, b], CONV)


@pytest.mark.parametrize("output_padding", [0, 1])
@pytest.mark.parametrize("padding", [0, 1, [1, 0, 2]], ids=str)
def test_conv3d_transpose_matches_reference(padding, output_padding):
    x, w = _rand((1, 2, 3, 4, 3), 17), _rand((2, 3, 3, 2, 3), 18)
    kw = dict(stride=2, padding=padding, output_padding=output_padding)
    _check(lambda a, c: JF.conv3d_transpose(a, c, **kw),
           lambda a, c: TF.conv3d_transpose(a, c, **kw), [x, w], CONV)


@pytest.mark.parametrize("cls,args,kw,shape", [
    ("Conv1D", (3, 4, 3), dict(padding=1), (2, 3, 9)),
    ("Conv2D", (4, 6, 3), dict(stride=2, padding="SAME", groups=2), (2, 4, 9, 9)),
    ("Conv2D", (3, 4, (3, 1)), dict(padding=[1, 0], bias_attr=False), (2, 3, 7, 7)),
    ("Conv3D", (2, 3, 2), dict(padding=1), (1, 2, 4, 4, 4)),
    ("Conv1DTranspose", (3, 4, 3), dict(stride=2, padding=1, output_padding=1),
     (2, 3, 6)),
    ("Conv2DTranspose", (4, 2, 3), dict(stride=2, padding=1, groups=2), (2, 4, 5, 5)),
    ("Conv3DTranspose", (2, 3, 2), dict(stride=2), (1, 2, 3, 3, 3)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_conv_layers_match_reference(cls, args, kw, shape):
    """The layers: the reference's parameter names and shapes, and its
    outputs and weight gradients on its weights."""
    paddle.seed(5)
    jm = getattr(jnn, cls)(*args, **kw)
    tm = getattr(tnn, cls)(*args, **kw)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    assert list(tm.state_dict()) == list(state)
    load_reference_state(tm, state)
    x = _rand(shape, 19)
    out = jm(paddle.to_tensor(x))
    cot = _rand(out.shape, 20)
    (out * paddle.to_tensor(cot)).sum().backward()
    t_out = tm(torch.from_numpy(x))
    (t_out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(t_out.detach().numpy(), out.numpy(), **CONV)
    for name, p in jm.named_parameters():
        np.testing.assert_allclose(dict(tm.named_parameters())[name].grad.numpy(),
                                   p.grad.numpy(), **CONV)


# ---------------------------------------------------------------------------
# refusals: what the reference takes and ignores
# ---------------------------------------------------------------------------

_X4 = torch.zeros(1, 2, 4, 4)
REFUSED = {
    "max_pool2d ceil_mode": lambda: TF.max_pool2d(_X4, 2, ceil_mode=True),
    "max_pool2d return_mask": lambda: TF.max_pool2d(_X4, 2, return_mask=True),
    "avg_pool2d ceil_mode": lambda: TF.avg_pool2d(_X4, 2, ceil_mode=True),
    "max_pool1d return_mask": lambda: TF.max_pool1d(_X4[0], 2, return_mask=True),
    "avg_pool1d ceil_mode": lambda: TF.avg_pool1d(_X4[0], 2, ceil_mode=True),
    "adaptive_max_pool2d return_mask":
        lambda: TF.adaptive_max_pool2d(_X4, 2, return_mask=True),
    "MaxPool2D ceil_mode": lambda: tnn.MaxPool2D(2, ceil_mode=True),
    "MaxPool2D return_mask": lambda: tnn.MaxPool2D(2, return_mask=True),
    "AdaptiveMaxPool2D return_mask": lambda: tnn.AdaptiveMaxPool2D(2, return_mask=True),
    "MaxPool3D data_format": lambda: tnn.MaxPool3D(2, data_format="NDHWC"),
    "GroupNorm data_format": lambda: tnn.GroupNorm(1, 2, data_format="NHWC"),
    "group_norm data_format": lambda: TF.group_norm(_X4, 1, data_format="NHWC"),
    "instance_norm use_input_stats":
        lambda: TF.instance_norm(_X4, use_input_stats=False),
    "local_response_norm data_format":
        lambda: TF.local_response_norm(_X4, 3, data_format="NHWC"),
    "conv2d_transpose data_format":
        lambda: TF.conv2d_transpose(_X4, torch.zeros(2, 2, 1, 1), data_format="NHWC"),
    "conv3d data_format":
        lambda: TF.conv3d(_X4[None], torch.zeros(2, 2, 1, 1, 1), data_format="NDHWC"),
    "padding_mode": lambda: tnn.Conv2D(2, 2, 3, padding_mode="reflect"),
}


@pytest.mark.parametrize("what", sorted(REFUSED))
def test_ignored_arguments_are_refused(what):
    with pytest.raises(NotImplementedError, match=what.split()[-1]):
        REFUSED[what]()


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv2d_transpose_string_padding_matches_reference(padding):
    """At stride 1 lax pads the flipped-kernel conv by the string; at a
    larger stride it refuses a string with a dilated input, so the
    reference cannot take one there, and the port raises."""
    x, w = _rand((1, 2, 5, 6), 73), _rand((2, 3, 3, 2), 74)
    kw = dict(padding=padding, dilation=2)
    _check(lambda a, c: JF.conv2d_transpose(a, c, **kw),
           lambda a, c: TF.conv2d_transpose(a, c, **kw), [x, w], CONV)
    with pytest.raises(ValueError):
        JF.conv2d_transpose(paddle.to_tensor(x), paddle.to_tensor(w), stride=2,
                            padding=padding).numpy()
    with pytest.raises(NotImplementedError):
        TF.conv2d_transpose(torch.from_numpy(x), torch.from_numpy(w), stride=2,
                            padding=padding)
