"""The port's vision models against the JAX package on the CPU: LeNet and
ResNet-18 here, ResNet-18 in NHWC and ResNeXt-50 in
`test_torch_vision_resnet.py`, VGG and a ResNet-50 stage in
`test_torch_vision_vgg.py` (both use this file's helpers).

Every port model takes the reference model's weights and running
statistics through `load_reference_state` (a Momentum run's velocities
through `load_reference_optimizer_state`); both run the same seeded
numpy images in float32.  Checked: `state_dict()` names (equal to the
reference's, in order), eval logits, and in train mode the loss, every
gradient, and every weight and running statistic after one Momentum step
and one Adam step, channels-first and channels-last.  Tolerance: 2e-4
relative to each tensor's largest magnitude (a dozen conv and batch-norm
layers in float32, sums in another order); the loss within 1e-5.

ResNets run 32x32 images in batches of 4.  At batch 2 layer4's batch
norms see two values per channel on a 1x1 map, and where the two nearly
agree the reference's single-pass variance E[x^2] - E[x]^2 cancels: its
train-mode logits there sit 0.18 from a float64 run, the port's 0.02
(ROADMAP.md Queue 3, parity hazards).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework.io import load, save
from paddle_tpu_torch.models.convert import load_reference_optimizer_state, load_reference_state
from paddle_tpu_torch.vision import models as tmodels

REL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _linear(tm):
    return {f"{n}.weight" for n, m in tm.named_modules() if isinstance(m, torch.nn.Linear)}


def _port_state(tm):
    """The port's state_dict as numpy in the reference's layout (Linear
    weights [in, out])."""
    lin = _linear(tm)
    return {k: (v.detach().numpy().T if k in lin else v.detach().numpy())
            for k, v in tm.state_dict().items()}


def _close(got, ref, what):
    scale = max(float(np.abs(ref).max()), 1e-6)
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * scale, err_msg=what)


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    assert list(tm.state_dict()) == list(jm.state_dict())
    load_reference_state(tm, _state(jm))
    return jm, tm


def _images(shape, seed, classes):
    rng = np.random.default_rng(seed)
    return rng.random(shape, dtype=np.float32), rng.integers(0, classes, shape[0])


def _optimizers(kind, jm, tm):
    if kind == "momentum":
        return (jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jm.parameters()),
                topt.Momentum(learning_rate=0.1, momentum=0.9,
                              parameters=tm.named_parameters()))
    return (jopt.Adam(learning_rate=1e-3, parameters=jm.parameters()),
            topt.Adam(learning_rate=1e-3, parameters=tm.named_parameters()))


def _train_and_compare(jm, tm, x, y, kind, nhwc=False):
    """One step in train mode: loss, gradients, then the weights and
    running statistics after the optimizer's step.  Adam's first step
    moves a weight by about lr * sign(g): where the reference's gradient is
    below 1e-4 of its tensor's largest, its sign is a rounding error's, so
    there the step is held to its size, lr, alone."""
    jo, to = _optimizers(kind, jm, tm)
    jm.train()
    tm.train()
    jx = x.transpose(0, 2, 3, 1).copy() if nhwc else x
    jloss = jnn.CrossEntropyLoss()(jm(paddle.to_tensor(jx)), paddle.to_tensor(y))
    jloss.backward()
    tloss = tnn.CrossEntropyLoss()(tm(torch.from_numpy(jx)), torch.from_numpy(y))
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(jloss.numpy()), rtol=1e-5, atol=1e-5)
    lin = _linear(tm)
    tparams = dict(tm.named_parameters())
    before, grads = _port_state(tm), {}
    for name, p in jm.named_parameters():
        g = tparams[name].grad.numpy()
        grads[name] = p.grad.numpy()
        _close(g.T if name in lin else g, grads[name], f"grad {name}")
    jo.step()
    jo.clear_grad()
    to.step()
    to.clear_grad()
    ref = _state(jm)
    for name, v in _port_state(tm).items():
        if kind == "adam" and name in grads:
            g = np.abs(grads[name])
            sure = g >= 1e-4 * g.max()
            assert np.all(np.abs(v - before[name]) <= 1e-3 * (1 + 1e-3)), name
            v, want = v[sure], ref[name][sure]
        else:
            want = ref[name]
        _close(v, want, f"{kind} step {name}")
    return float(tloss.detach())


def _eval_and_compare(jm, tm, x):
    jm.eval()
    tm.eval()
    with torch.no_grad():
        out = tm(torch.from_numpy(x)).numpy()
    _close(out, jm(paddle.to_tensor(x)).numpy(), "eval logits")


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_lenet_matches_reference(kind):
    jm, tm = _pair("LeNet")
    x, y = _images((4, 1, 28, 28), 1, 10)
    _eval_and_compare(jm, tm, x)
    _train_and_compare(jm, tm, x, y, kind)
    if kind == "momentum":  # Adam's rounding-level signs move a few weights
        _eval_and_compare(jm, tm, x)


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_resnet18_matches_reference(kind, layout="NCHW"):
    """resnet18 at 32x32 (NHWC: test_torch_vision_resnet.py): eval logits,
    a train step, eval again on the moved running statistics."""
    jm, tm = _pair("resnet18", num_classes=10, data_format=layout)
    x, y = _images((4, 3, 32, 32), 2, 10)
    xl = x.transpose(0, 2, 3, 1).copy() if layout == "NHWC" else x
    _eval_and_compare(jm, tm, xl)
    _train_and_compare(jm, tm, x, y, kind, nhwc=layout == "NHWC")
    if kind == "momentum":
        _eval_and_compare(jm, tm, xl)


def test_momentum_state_resumes_from_the_reference():
    """A reference Momentum run on two convs and a batch norm, checkpointed after two steps (weights, running statistics, every
    `velocity`) and resumed in the port: the third step's weights and
    velocities equal the reference's."""
    def net(nn_, seq):
        return seq(nn_.Conv2D(3, 4, 3, padding=1, bias_attr=False), nn_.BatchNorm2D(4),
                   nn_.ReLU(), nn_.Conv2D(4, 2, 3, stride=2))

    paddle.seed(8)
    jm = net(jnn, jnn.Sequential)
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jm.parameters())
    x = np.random.default_rng(9).standard_normal((4, 3, 6, 6)).astype(np.float32)
    for step in range(3):
        if step == 2:
            tm = net(tnn, torch.nn.Sequential)
            load_reference_state(tm, _state(jm))
            to = topt.Momentum(learning_rate=0.1, momentum=0.9,
                               parameters=tm.named_parameters())
            load_reference_optimizer_state(to, jo.state_dict(), jm)
            assert {n for n, p in tm.named_parameters()
                    if "velocity" in to.state[p]} == set(dict(tm.named_parameters()))
        out = jm(paddle.to_tensor(x))
        (out * out).mean().backward()
        jo.step()
        jo.clear_grad()
    t_out = tm(torch.from_numpy(x))
    (t_out * t_out).mean().backward()
    to.step()
    ref = _state(jm)
    for name, v in _port_state(tm).items():
        _close(v, ref[name], name)
    jvel = {k: np.asarray(v.numpy()) for k, v in jo.state_dict().items()
            if k.endswith("_velocity")}
    by_key = {p.name: name for name, p in jm.named_parameters()}
    tparams = dict(tm.named_parameters())
    for key, v in jvel.items():
        name = by_key[key[: -len("_velocity")]]
        _close(to.state[tparams[name]]["velocity"].numpy(), v, f"{name} velocity")


def test_state_dict_names_and_save_load_round_trip(tmp_path):
    """Names equal the reference's, buffers included; the port's `save` /
    `load` give back every tensor, running statistics too."""
    jm, tm = _pair("resnet18", num_classes=10)
    assert "layer2.0.downsample.1._mean" in tm.state_dict()
    with torch.no_grad():
        tm.layer1[0].bn1._mean.add_(1.5)
    path = str(tmp_path / "resnet18.pdparams")
    save(tm.state_dict(), path)
    back = load(path)
    assert list(back) == list(tm.state_dict())
    fresh = tmodels.resnet18(num_classes=10, device="cpu", seed=1)
    fresh.load_state_dict(back)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, tm.state_dict()[k]), k


def test_models_default_to_the_card():
    """Entry points run on CUDA unless given device="cpu"."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmodels.LeNet()
