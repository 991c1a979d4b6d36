"""The port's pool and norm functions and layers against the JAX package
on the CPU (the convs and the refusals: `test_torch_vision_layers.py`,
whose helpers and tolerances this file shares).

Pools, float32 within 1e-6 (one sum or one max per output): -inf padding
of max pools, pads past k / 2, `exclusive`, `divisor_override`, "SAME",
the adaptive windows, channels-first and channels-last.  Norms within
1e-5: batch norm in train and eval (running `_mean` / `_variance` after
three steps), `use_global_stats`, NHWC; GroupNorm, InstanceNorm, LRN,
SpectralNorm.
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
from test_torch_vision_layers import NORM, POOL, _check, _cl, _cl_pairs, _rand


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX layers draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


# ---------------------------------------------------------------------------
# pools
# ---------------------------------------------------------------------------

POOL_PADS = [0, 1, [1, 0], [0, 1, 2, 1], [[0, 0], [0, 0], [2, 1], [0, 1]], 2, "SAME",
             "VALID"]


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding", POOL_PADS, ids=str)
def test_max_pool2d_matches_reference(padding, layout):
    """-inf padding, pads past k / 2 included; gradients go to the max."""
    x = _rand((2, 3, 9, 8), 21)
    jfn = lambda a: JF.max_pool2d(a, 3, 2, padding)
    key = ("max_pool2d", str(padding))
    if layout == "NCHW":
        _check(jfn, lambda a: TF.max_pool2d(a, 3, 2, padding), [x], POOL, key=key)
    else:
        pad = _cl_pairs(padding, 2)
        _check(jfn, lambda a: TF.max_pool2d(a, 3, 2, pad, data_format="NHWC"), [x], POOL,
               *_cl(2), key=key)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("mode", ["exclusive", "inclusive", "divisor"])
@pytest.mark.parametrize("padding", POOL_PADS, ids=str)
def test_avg_pool2d_matches_reference(padding, mode, layout):
    """exclusive divides by the real elements of explicit pads, "SAME" and
    inclusive by k * k, `divisor_override` by itself."""
    x = _rand((2, 3, 9, 8), 22)
    kw = {"exclusive": dict(exclusive=True), "inclusive": dict(exclusive=False),
          "divisor": dict(divisor_override=5)}[mode]
    jfn = lambda a: JF.avg_pool2d(a, 3, 2, padding, **kw)
    key = ("avg_pool2d", str(padding), mode)
    if layout == "NCHW":
        _check(jfn, lambda a: TF.avg_pool2d(a, 3, 2, padding, **kw), [x], POOL, key=key)
    else:
        pad = _cl_pairs(padding, 2)
        _check(jfn, lambda a: TF.avg_pool2d(a, 3, 2, pad, data_format="NHWC", **kw), [x],
               POOL, *_cl(2), key=key)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("padding", [0, 1, [1, 0], 2, "SAME", "VALID"], ids=str)
def test_pool1d_matches_reference(padding, exclusive):
    """avg_pool1d divides by k whatever `exclusive` says, as the reference."""
    x = _rand((2, 3, 11), 23)
    _check(lambda a: JF.max_pool1d(a, 3, 2, padding),
           lambda a: TF.max_pool1d(a, 3, 2, padding), [x], POOL)
    _check(lambda a: JF.avg_pool1d(a, 3, 2, padding, exclusive),
           lambda a: TF.avg_pool1d(a, 3, 2, padding, exclusive), [x], POOL)


@pytest.mark.parametrize("layout", ["NCDHW", "NDHWC"])
@pytest.mark.parametrize("padding", [0, 1, [1, 0, 0, 1, 1, 1], "SAME"], ids=str)
def test_pool3d_matches_reference(padding, layout):
    x = _rand((1, 2, 5, 6, 5), 24)
    to_p, from_p = _cl(3) if layout == "NDHWC" else (None, None)
    _check(lambda a: JF.max_pool3d(a, 2, 2, padding),
           lambda a: TF.max_pool3d(a, 2, 2, padding, data_format=layout), [x], POOL,
           to_p, from_p, key=("max_pool3d", str(padding)))
    _check(lambda a: JF.avg_pool3d(a, 2, 2, padding),
           lambda a: TF.avg_pool3d(a, 2, 2, padding, data_format=layout), [x], POOL,
           to_p, from_p, key=("avg_pool3d", str(padding)))


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("out", [(1, 1), (3, 4), (7, 7), (4, 3)], ids=str)
def test_adaptive_pools_match_reference(out, layout):
    """The divisible branch and the general windows (7 of 5 rows: windows
    repeat), means in both layouts, maxima channels-first."""
    x = _rand((2, 3, 9, 8), 25)
    to_p, from_p = _cl(2) if layout == "NHWC" else (None, None)
    _check(lambda a: JF.adaptive_avg_pool2d(a, out),
           lambda a: TF.adaptive_avg_pool2d(a, out, data_format=layout), [x], POOL,
           to_p, from_p, key=("adaptive_avg_pool2d", out))
    if layout == "NCHW":
        _check(lambda a: JF.adaptive_max_pool2d(a, out),
               lambda a: TF.adaptive_max_pool2d(a, out), [x], POOL)
        small = _rand((2, 3, 5, 5), 26)
        _check(lambda a: JF.adaptive_avg_pool2d(a, out),
               lambda a: TF.adaptive_avg_pool2d(a, out), [small], POOL)


@pytest.mark.parametrize("out", [1, 3, 4, 7])
def test_adaptive_pools_1d_3d_match_reference(out):
    x = _rand((2, 3, 12), 27)
    _check(lambda a: JF.adaptive_avg_pool1d(a, out),
           lambda a: TF.adaptive_avg_pool1d(a, out), [x], POOL)
    _check(lambda a: JF.adaptive_max_pool1d(a, out),
           lambda a: TF.adaptive_max_pool1d(a, out), [x], POOL)
    if out in (1, 3):
        v = _rand((1, 2, 3, 6, 3), 28)
        _check(lambda a: JF.adaptive_avg_pool3d(a, out),
               lambda a: TF.adaptive_avg_pool3d(a, out), [v], POOL)


@pytest.mark.parametrize("cls,args,kw,shape", [
    ("MaxPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("AvgPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("MaxPool2D", (3, 2, 1), {}, (2, 3, 9, 9)),
    ("AvgPool2D", (3, 2, 1), dict(exclusive=False), (2, 3, 9, 9)),
    ("AvgPool2D", (2,), dict(divisor_override=3), (2, 3, 8, 8)),
    ("AdaptiveAvgPool1D", (4,), {}, (2, 3, 10)),
    ("AdaptiveAvgPool2D", ((7, 7),), {}, (2, 3, 5, 5)),
    ("AdaptiveMaxPool2D", (3,), {}, (2, 3, 8, 7)),
    ("MaxPool3D", (2, 2), {}, (1, 2, 4, 4, 4)),
    ("AvgPool3D", (2, 2, 1), {}, (1, 2, 4, 4, 4)),
    ("AdaptiveAvgPool3D", (2,), {}, (1, 2, 4, 4, 4)),
], ids=lambda v: v if isinstance(v, str) else None)
def test_pool_layers_match_reference(cls, args, kw, shape):
    x = _rand(shape, 29)
    _check(lambda a: getattr(jnn, cls)(*args, **kw)(a),
           lambda a: getattr(tnn, cls)(*args, **kw)(a), [x], POOL)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _bn_pair(n, **kw):
    paddle.seed(6)
    jm = jnn.BatchNorm2D(n, **kw)
    tm = tnn.BatchNorm2D(n, **kw)
    rng = np.random.default_rng(30)
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    state["weight"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    state["bias"] = rng.standard_normal(n).astype(np.float32)
    jm.set_state_dict(state)
    load_reference_state(tm, state)
    return jm, tm


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_batch_norm_train_steps_match_reference(layout):
    """Three train steps: outputs, input and weight gradients, and the
    running `_mean` / `_variance` (paddle's momentum, unbiased variance)
    after each; then eval on the running statistics."""
    jm, tm = _bn_pair(4, data_format=layout)
    assert list(tm.state_dict()) == ["weight", "bias", "_mean", "_variance"]
    for step in range(3):
        x = _rand((3, 4, 5, 6), 40 + step) * (1 + step) + step
        if layout == "NHWC":
            x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        jx = paddle.to_tensor(x, stop_gradient=False)
        out = jm(jx)
        cot = _rand(out.shape, 50 + step)
        (out * paddle.to_tensor(cot)).sum().backward()
        tx = torch.tensor(x, requires_grad=True)
        t_out = tm(tx)
        (t_out * torch.from_numpy(cot)).sum().backward()
        np.testing.assert_allclose(t_out.detach().numpy(), out.numpy(), **NORM)
        np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), **NORM)
        for name in ("weight", "bias"):
            np.testing.assert_allclose(getattr(tm, name).grad.numpy(),
                                       getattr(jm, name).grad.numpy(), **NORM)
            getattr(tm, name).grad = None
            getattr(jm, name).clear_gradient()
        for name in ("_mean", "_variance"):
            np.testing.assert_allclose(getattr(tm, name).numpy(),
                                       getattr(jm, name).numpy(), **NORM)
    jm.eval()
    tm.eval()
    x = _rand((2, 4, 5, 6) if layout == "NCHW" else (2, 5, 6, 4), 60)
    _check(lambda a: jm(a), lambda a: tm(a), [x], NORM)
    assert tm._mean.dtype == torch.float32


def test_batch_norm_global_stats_and_1d_match_reference():
    """`use_global_stats` in training normalises by the running statistics
    and leaves them alone; BatchNorm1D over [N, C] and [N, C, L]."""
    jm, tm = _bn_pair(4, use_global_stats=True)
    before = tm._mean.clone()
    x = _rand((3, 4, 5, 6), 61) + 2
    _check(lambda a: jm(a), lambda a: tm(a), [x], NORM)
    assert torch.equal(tm._mean, before)
    np.testing.assert_allclose(tm._mean.numpy(), jm._mean.numpy())
    for shape in ((6, 4), (3, 4, 7)):
        paddle.seed(7)
        j1, t1 = jnn.BatchNorm1D(4), tnn.BatchNorm1D(4)
        x = _rand(shape, 62)
        _check(lambda a: j1(a), lambda a: t1(a), [x], NORM)
        np.testing.assert_allclose(t1._variance.numpy(), j1._variance.numpy(), **NORM)


def test_sync_batch_norm_converts_like_reference():
    seq = torch.nn.Sequential(tnn.Conv2D(3, 4, 1), tnn.BatchNorm2D(4))
    seq[1]._mean.fill_(0.5)
    conv = tnn.SyncBatchNorm.convert_sync_batchnorm(seq)
    assert conv is seq and isinstance(seq[1], tnn.SyncBatchNorm)
    assert torch.equal(seq[1]._mean, torch.full((4,), 0.5))
    jm, _ = _bn_pair(4)
    ts = tnn.SyncBatchNorm(4)
    load_reference_state(ts, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    js = jnn.SyncBatchNorm.convert_sync_batchnorm(jm)
    _check(lambda a: js(a), lambda a: ts(a), [_rand((2, 4, 3, 3), 63)], NORM)


@pytest.mark.parametrize("groups", [1, 2, 4])
def test_group_and_instance_norm_match_reference(groups):
    paddle.seed(8)
    jm, tm = jnn.GroupNorm(groups, 4), tnn.GroupNorm(groups, 4)
    state = {"weight": _rand(4, 64), "bias": _rand(4, 65)}
    jm.set_state_dict(state)
    load_reference_state(tm, state)
    x = _rand((2, 4, 5, 3), 66) * 3 + 1
    _check(lambda a, w, b: JF.group_norm(a, groups, 1e-5, w, b),
           lambda a, w, b: TF.group_norm(a, groups, 1e-5, w, b),
           [x, state["weight"], state["bias"]], NORM)
    _check(lambda a: jm(a), lambda a: tm(a), [x], NORM)
    for jcls, tcls, shape in ((jnn.InstanceNorm1D, tnn.InstanceNorm1D, (2, 4, 7)),
                              (jnn.InstanceNorm2D, tnn.InstanceNorm2D, (2, 4, 3, 5))):
        ji, ti = jcls(4), tcls(4)
        load_reference_state(ti, {k: np.asarray(v.numpy())
                                  for k, v in ji.state_dict().items()})
        _check(lambda a: ji(a), lambda a: ti(a), [_rand(shape, 67 + groups)], NORM)


@pytest.mark.parametrize("size", [1, 3, 5])
def test_local_response_norm_matches_reference(size):
    """The reference's alpha (not torch's alpha / size)."""
    x = _rand((2, 6, 4, 3), 70) * 4
    kw = dict(size=size, alpha=1e-2, beta=0.75, k=2.0)
    _check(lambda a: JF.local_response_norm(a, **kw),
           lambda a: TF.local_response_norm(a, **kw), [x], NORM)
    _check(lambda a: jnn.LocalResponseNorm(**kw)(a),
           lambda a: tnn.LocalResponseNorm(**kw)(a), [x], NORM)


def test_spectral_norm_matches_reference():
    """u and v advance in a train step, stay put in eval; the output and
    the weight's gradient treat them as constants."""
    paddle.seed(9)
    jm = jnn.SpectralNorm([6, 3, 2], dim=1, power_iters=2)
    tm = tnn.SpectralNorm([6, 3, 2], dim=1, power_iters=2)
    load_reference_state(tm, {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()})
    assert not tm.weight_u.requires_grad and not tm.weight_v.requires_grad
    w = _rand((6, 3, 2), 71)
    _check(lambda a: jm(a), lambda a: tm(a), [w], NORM)
    for name in ("weight_u", "weight_v"):
        np.testing.assert_allclose(getattr(tm, name).detach().numpy(),
                                   getattr(jm, name).numpy(), **NORM)
    jm.eval()
    tm.eval()
    u = tm.weight_u.detach().clone()
    _check(lambda a: jm(a), lambda a: tm(a), [_rand((6, 3, 2), 72)], NORM)
    assert torch.equal(tm.weight_u.detach(), u)
