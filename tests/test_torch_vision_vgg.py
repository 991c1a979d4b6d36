"""VGG's features and a ResNet-50 stage at its widths against the JAX
package on the CPU, with `test_torch_vision_models.py`'s helpers and
tolerances."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.vision import models as tmodels
from test_torch_vision_models import (_close, _eval_and_compare, _images, _optimizers,
                                      _pair, _port_state, _state)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet50_stage_matches_reference(layout):
    """ResNet-50's first stage at its widths (three BottleneckBlocks, 64 ->
    256 channels, the first with its downsample) on an 8x8 map: output and
    input gradient in train mode, then the running statistics."""
    df = {} if layout == "NCHW" else dict(data_format=layout)

    def stage(nn_, block_cls):
        down = [nn_.Conv2D(64, 256, 1, bias_attr=False, **df), nn_.BatchNorm2D(256, **df)]
        seq = jnn.Sequential if nn_ is jnn else torch.nn.Sequential
        blocks = [block_cls(64, 64, 1, seq(*down), data_format=layout)]
        blocks += [block_cls(256, 64, data_format=layout) for _ in range(2)]
        return seq(*blocks)

    paddle.seed(4)
    jm = stage(jnn, jmodels.BottleneckBlock)
    tm = stage(tnn, tmodels.BottleneckBlock)
    assert list(tm.state_dict()) == list(jm.state_dict())
    load_reference_state(tm, _state(jm))
    x = np.random.default_rng(5).standard_normal(
        (2, 64, 8, 8) if layout == "NCHW" else (2, 8, 8, 64)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    out = jm(jx)
    out.sum().backward()
    tx = torch.tensor(x, requires_grad=True)
    t_out = tm(tx)
    t_out.sum().backward()
    _close(t_out.detach().numpy(), out.numpy(), "stage output")
    _close(tx.grad.numpy(), jx.grad.numpy(), "input gradient")
    ref = _state(jm)
    for name, v in _port_state(tm).items():
        _close(v, ref[name], name)


@pytest.mark.parametrize("batch_norm", [False, True])
def test_vgg_features_match_reference(batch_norm):
    """vgg11's features without classifier (`num_classes=0`): 32x32 images
    leave a 1x1 map, so the 7x7 adaptive pool takes its general windows;
    eval, then a Momentum step."""
    jm, tm = _pair("vgg11", batch_norm=batch_norm, num_classes=0)
    x = _images((2, 3, 32, 32), 6, 10)[0]
    _eval_and_compare(jm, tm, x)
    jo, to = _optimizers("momentum", jm, tm)
    jm.train()
    tm.train()
    out = jm(paddle.to_tensor(x))
    (out * out).mean().backward()
    t_out = tm(torch.from_numpy(x))
    (t_out * t_out).mean().backward()
    assert tuple(t_out.shape) == (2, 512, 7, 7)
    _close(t_out.detach().numpy(), out.numpy(), "train features")
    jo.step()
    to.step()
    ref = _state(jm)
    for name, v in _port_state(tm).items():
        _close(v, ref[name], name)
