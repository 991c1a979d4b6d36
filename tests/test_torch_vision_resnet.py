"""ResNet-18 in NHWC and ResNeXt-50 (32x4d) against the JAX package on the
CPU, with `test_torch_vision_models.py`'s helpers and tolerances (its
docstring says why the ResNets run batches of 4)."""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from test_torch_vision_models import (_eval_and_compare, _images, _pair, _port_state,
                                      _state, _train_and_compare)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_resnet18_nhwc_matches_reference(kind, layout="NHWC"):
    """resnet18 at 32x32 in NHWC, against the reference's NHWC model: eval
    logits, a train step, eval again on the moved running statistics."""
    jm, tm = _pair("resnet18", num_classes=10, data_format=layout)
    x, y = _images((4, 3, 32, 32), 2, 10)
    xl = x.transpose(0, 2, 3, 1).copy() if layout == "NHWC" else x
    _eval_and_compare(jm, tm, xl)
    _train_and_compare(jm, tm, x, y, kind, nhwc=layout == "NHWC")
    if kind == "momentum":
        _eval_and_compare(jm, tm, xl)


def test_resnext50_matches_reference():
    """resnext50_32x4d (grouped 3x3 convs, 32 groups) at 32x32: eval logits
    within the tolerance.  In train mode fifty layers of batch statistics
    over four images leave float32 itself ~1e-3 from exact, so there the
    port's logits and running statistics are held nearer a float64 run of
    the port than the reference's are."""
    jm, tm = _pair("resnext50_32x4d", num_classes=10)
    assert tm.layer1[0].conv2._groups == 32
    x = _images((4, 3, 32, 32), 3, 10)[0]
    _eval_and_compare(jm, tm, x)
    exact = copy.deepcopy(tm).double().train()
    jm.train()
    tm.train()
    ref = jm(paddle.to_tensor(x)).numpy()
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
        want = exact(torch.from_numpy(x).double()).numpy()
    assert np.abs(got - want).max() < np.abs(ref - want).max()
    ref_state, got_state = _state(jm), _port_state(tm)
    err = lambda a, name: np.abs(a - exact.state_dict()[name].numpy()).max()
    names = [n for n in got_state if n.endswith(("_mean", "_variance"))]
    assert max(err(got_state[n], n) for n in names) < max(err(ref_state[n], n)
                                                          for n in names)
