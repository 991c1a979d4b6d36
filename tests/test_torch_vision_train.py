"""Training the port's vision models against the JAX package on the CPU.

- LeNet's loss curve over 15 SGD steps (lr 0.05, one batch of 16 seeded
  MNIST-shaped images), as `bench.py`'s loss-parity gate takes it
  (:2646-2671), within its tolerance (rtol 2e-2, atol 1e-4, :2685-2690).
- LeNet through `Model.fit` with Adam and `Accuracy`, against the
  reference's `Model.fit` over the same 64 rows: the epochs' mean losses
  within 1e-5 and the accuracies equal.
- A ResNet-18 decorated for bf16 O2 and fed float32 images: every conv
  runs in bf16, every batch norm returns bf16 and keeps float32
  parameters and running statistics, and the O2 scope intercepts no
  torch function.  bf16 keeps 8 bits, and over twenty train-mode layers
  at batch 4 each package's O2 logits sit ~0.5 from the float32 step's
  (ResNet-18 at 32x32), so the bf16 tolerance is stated against the
  float32 step (the port's, which meets the reference's within 2e-4 in
  test_torch_vision_models.py): the port's O2 logits, loss and every
  gradient are no farther from it than twice the reference's O2 are
  (gradients by norm, plus 1e-2 of the float32 gradient's norm).
"""

import copy

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.vision import models as jmodels
from paddle_tpu_torch import Model, amp, metric
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.vision import models as tmodels


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _state(jm):
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _pair(name, seed=0, **kw):
    paddle.seed(seed)
    jm = getattr(jmodels, name)(**kw)
    tm = getattr(tmodels, name)(device="cpu", **kw)
    load_reference_state(tm, _state(jm))
    return jm, tm


def test_lenet_loss_curve_matches_reference():
    jm, tm = _pair("LeNet")
    rng = np.random.RandomState(0)
    x = rng.rand(16, 1, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, (16,)).astype(np.int64)
    jo = jopt.SGD(learning_rate=0.05, parameters=jm.parameters())
    to = topt.SGD(learning_rate=0.05, parameters=tm.named_parameters())
    jce, tce = jnn.CrossEntropyLoss(), tnn.CrossEntropyLoss()
    ref, got = [], []
    for _ in range(15):
        loss = jce(jm(paddle.to_tensor(x)), paddle.to_tensor(y))
        loss.backward()
        jo.step()
        jo.clear_grad()
        ref.append(float(loss.numpy()))
        tloss = tce(tm(torch.from_numpy(x)), torch.from_numpy(y))
        tloss.backward()
        to.step()
        to.clear_grad()
        got.append(float(tloss.detach()))
    assert got[-1] < got[0]
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=1e-4)


def test_lenet_fit_matches_reference():
    """`Model.fit` over 64 rows (batch 16, one epoch, no shuffle) with Adam
    and Accuracy, in each package."""
    rng = np.random.RandomState(0)
    rows = [(rng.rand(1, 28, 28).astype(np.float32), np.int64(rng.randint(0, 10)))
            for _ in range(64)]
    jnet, tnet = _pair("LeNet")
    jmodel = paddle.Model(jnet)
    jmodel.prepare(jopt.Adam(learning_rate=1e-3, parameters=jnet.parameters()),
                   jnn.CrossEntropyLoss(), paddle.metric.Accuracy())
    tmodel = Model(tnet)
    tmodel.prepare(topt.Adam(learning_rate=1e-3, parameters=tnet.named_parameters()),
                   tnn.CrossEntropyLoss(), metric.Accuracy())
    ref = jmodel.fit(rows, batch_size=16, epochs=2, verbose=0, shuffle=False)
    got = tmodel.fit(rows, batch_size=16, epochs=2, verbose=0, shuffle=False)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    assert tmodel._metrics[0].accumulate() == jmodel._metrics[0].accumulate()
    ev_ref = jmodel.evaluate(rows, batch_size=16, verbose=0)
    ev_got = tmodel.evaluate(rows, batch_size=16, verbose=0)
    np.testing.assert_allclose(ev_got["loss"], ev_ref["loss"], rtol=1e-5, atol=1e-5)
    assert ev_got["acc"] == ev_ref["acc"]


def _dtypes_seen(model, kinds):
    """Output dtypes of every module of `kinds`, recorded by forward hooks."""
    seen = []
    for mod in model.modules():
        if isinstance(mod, kinds):
            mod.register_forward_hook(
                lambda m, args, out: seen.append((type(m).__name__, out.dtype)))
    return seen


def test_decorated_o2_resnet_takes_float32_images():
    jm, tm = _pair("resnet18", num_classes=10)
    rng = np.random.default_rng(1)
    x = rng.random((4, 3, 32, 32), dtype=np.float32)
    y = rng.integers(0, 10, 4)
    t32 = copy.deepcopy(tm)
    out32 = t32(torch.from_numpy(x))
    loss32 = tnn.CrossEntropyLoss()(out32, torch.from_numpy(y))
    loss32.backward()
    jo = jopt.Momentum(learning_rate=0.1, momentum=0.9, parameters=jm.parameters())
    to = topt.Momentum(learning_rate=0.1, momentum=0.9, parameters=tm.named_parameters())
    jm, jo = paddle.amp.decorate(jm, jo, level="O2", dtype="bfloat16")
    tm, to = amp.decorate(tm, to, level="O2", dtype="bfloat16")
    for mod in tm.modules():
        for p in mod.parameters(recurse=False):
            keep = isinstance(mod, tnn.BatchNorm2D)
            assert p.dtype == (torch.float32 if keep else torch.bfloat16), mod
        for b in mod.buffers(recurse=False):
            assert b.dtype == torch.float32
    seen = _dtypes_seen(tm, (tnn.Conv2D, tnn.BatchNorm2D))
    modes = []
    tm.register_forward_pre_hook(
        lambda m, a: modes.append(len(torch.overrides._get_current_function_mode_stack())))
    jout = jm(paddle.to_tensor(x))
    jloss = jnn.CrossEntropyLoss()(jout, paddle.to_tensor(y))
    jloss.backward()
    tout = tm(torch.from_numpy(x))
    tloss = tnn.CrossEntropyLoss()(tout, torch.from_numpy(y))
    tloss.backward()
    assert modes == [0] and core.active_amp() is None
    assert len(seen) == 40 and all(dt == torch.bfloat16 for _, dt in seen), seen
    assert tout.dtype == torch.bfloat16 and tloss.dtype == torch.float32
    f32 = out32.detach().numpy()
    ref_err = np.abs(jout.numpy().astype(np.float32) - f32).max()
    assert np.abs(tout.detach().float().numpy() - f32).max() <= 2 * ref_err
    # cross-entropy moves by at most twice the logits' largest change
    assert abs(float(tloss.detach()) - float(loss32.detach())) <= 2 * 2 * ref_err
    ref32 = dict(t32.named_parameters())
    tparams = dict(tm.named_parameters())
    for name, p in jm.named_parameters():
        g32 = ref32[name].grad.numpy()
        g32 = g32.T if name == "fc.weight" else g32
        ref = p.grad.numpy().astype(np.float32)
        got = tparams[name].grad.float().numpy()
        got = got.T if name == "fc.weight" else got
        norm = np.linalg.norm(g32)
        assert np.linalg.norm(got - g32) <= 2 * np.linalg.norm(ref - g32) + 1e-2 * norm, name
    jo.step()
    to.step()
    assert to.state[tparams["conv1.weight"]]["master_weight"].dtype == torch.float32
    assert tm.bn1._mean.dtype == torch.float32


def test_norms_stay_float32_after_decorate():
    """The port's batch norms, GroupNorm, SpectralNorm and LayerNorm keep
    float32 parameters under O2 (reference amp :60-62); convs go bf16."""
    seq = torch.nn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4), tnn.GroupNorm(2, 4),
                              tnn.SyncBatchNorm(4), tnn.LayerNorm(4),
                              tnn.SpectralNorm([4, 3, 3, 3]))
    amp.decorate(seq, level="O2")
    assert seq[0].weight.dtype == torch.bfloat16
    for mod in list(seq)[1:]:
        assert all(p.dtype == torch.float32 for p in mod.parameters()), mod
    net = amp.decorate(torch.nn.Sequential(tnn.Conv2D(3, 4, 3), tnn.BatchNorm2D(4),
                                           tnn.GroupNorm(2, 4)), level="O2")
    assert net(torch.rand(2, 3, 6, 6)).dtype == torch.bfloat16
