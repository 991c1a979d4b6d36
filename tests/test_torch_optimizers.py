"""The port's other optimizers, regularizers, gradient clips and the
reference-checkpoint resume, against the JAX package, on the CPU.

- SGD, Momentum (with and without Nesterov), Adagrad, RMSProp (centered,
  with momentum), Adamax and Lamb, each under L2Decay and L1Decay: three
  steps of two float32 parameters, atol/rtol 1e-6 (the reference's float32
  formulas as per-parameter torch ops in the same order; Lamb's norms are
  sums whose order may differ, within a few ulps);
- the four clips (`ClipGradByValue`, `ClipGradByNorm`, `clip_grad_norm_`,
  `clip_grad_value_`): atol/rtol 1e-6;
- parameter-group dicts (extra keys ignored, as the reference ignores
  them), `minimize` and `clear_gradients`;
- `load_reference_optimizer_state`: a tiny float32 Llama trained two AdamW
  steps under a schedule in the reference, resumed in the port, takes the
  reference's third step within 1e-5 (the tiny Llama's float32 forward and
  backward agree within ~1e-6; one Adam step moves a weight by about lr,
  whatever the gradient's size).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer, regularizer
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import (load_reference_optimizer_state,
                                             load_reference_state)
from paddle_tpu_torch.nn import clip as tclip

TOL = dict(atol=1e-6, rtol=1e-6)
SHAPES = [(5, 3), (7,)]


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _inputs(seed, steps=3):
    rng = np.random.default_rng(seed)
    w0s = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in SHAPES]
             for _ in range(steps)]
    return w0s, grads


# (class, keyword arguments from a regularizer module); each package takes
# its own regularizer objects
OPTIMIZERS = {
    "sgd": ("SGD", lambda reg: {}),
    "momentum": ("Momentum", lambda reg: {"momentum": 0.8}),
    "nesterov": ("Momentum", lambda reg: {"momentum": 0.8, "use_nesterov": True}),
    "adagrad": ("Adagrad", lambda reg: {"initial_accumulator_value": 0.1}),
    "rmsprop": ("RMSProp", lambda reg: {}),
    "rmsprop_centered_momentum": ("RMSProp", lambda reg: {"centered": True,
                                                          "momentum": 0.7}),
    "adamax": ("Adamax", lambda reg: {}),
    "lamb": ("Lamb", lambda reg: {
        "exclude_from_weight_decay_fn": lambda p: len(p.shape) == 1}),
}


def _decay_kw(cls, reg, kind):
    coeff = reg.L2Decay(0.05) if kind == "l2" else reg.L1Decay(0.02)
    return {"lamb_weight_decay" if cls == "Lamb" else "weight_decay": coeff}


def _ref_steps(cls, kw, w0s, grads):
    ps = [paddle.Parameter(w.copy(), name=f"{cls}_{i}_{id(kw)}")
          for i, w in enumerate(w0s)]
    opt = getattr(paddle.optimizer, cls)(learning_rate=0.05, parameters=ps, **kw)
    for gs in grads:
        sum((p * to_tensor(g)).sum() for p, g in zip(ps, gs)).backward()
        opt.step()
        opt.clear_grad()
    return [p.numpy() for p in ps]


def _port_steps(cls, kw, w0s, grads):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0s]
    opt = getattr(optimizer, cls)(learning_rate=0.05, parameters=ps, **kw)
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_gradients()
        assert all(p.grad is None for p in ps)
    return [p.detach().numpy() for p in ps]


@pytest.mark.parametrize("decay", ["l2", "l1"])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_reference(name, decay):
    cls, kw = OPTIMIZERS[name]
    w0s, grads = _inputs(len(name) + len(decay))
    ref = _ref_steps(cls, {**kw(paddle.regularizer),
                           **_decay_kw(cls, paddle.regularizer, decay)}, w0s, grads)
    got = _port_steps(cls, {**kw(regularizer), **_decay_kw(cls, regularizer, decay)},
                      w0s, grads)
    for r, t, w in zip(ref, got, w0s):
        np.testing.assert_allclose(t, r, **TOL)
        assert not np.array_equal(t, w)


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_without_decay_matches_reference(name):
    cls, kw = OPTIMIZERS[name]
    w0s, grads = _inputs(len(name) + 7)
    ref = _ref_steps(cls, kw(paddle.regularizer), w0s, grads)
    got = _port_steps(cls, kw(regularizer), w0s, grads)
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t, r, **TOL)


def test_parameter_groups_minimize_and_bad_arguments():
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    b = torch.nn.Parameter(torch.tensor([0.5]))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[
        {"params": [w], "learning_rate": 9.0}, {"params": [b], "weight_decay": 3.0}])
    assert [len(g["params"]) for g in opt.param_groups] == [1, 1]
    loss = (w * w).sum() + 2 * b.sum()
    assert opt.minimize(loss) == (None, None)
    # the groups' own keys are ignored: every parameter takes lr 0.1, no decay
    np.testing.assert_allclose(w.detach().numpy(), [0.8, 1.6])
    np.testing.assert_allclose(b.detach().numpy(), [0.3])
    with pytest.raises(TypeError, match="weight_decay"):
        optimizer.SGD(parameters=[w], weight_decay="0.1")
    with pytest.raises(TypeError, match="learning_rate"):
        optimizer.SGD(parameters=[w], learning_rate="0.1")


# ---------------------------------------------------------------------------
# clips
# ---------------------------------------------------------------------------


def _grads(seed):
    rng = np.random.default_rng(seed)
    return [(2 * rng.standard_normal(s)).astype(np.float32) for s in ((4, 3), (6,), (2, 2))]


@pytest.mark.parametrize("make", [
    lambda m: m.ClipGradByValue(0.5, -0.3),
    lambda m: m.ClipGradByValue(0.4),
    lambda m: m.ClipGradByNorm(1.0),
    lambda m: m.ClipGradByNorm(100.0),
], ids=["value", "value_symmetric", "norm", "norm_above"])
def test_clip_classes_match_reference(make):
    gs = _grads(1)
    rps = [paddle.Parameter(np.zeros_like(g)) for g in gs]
    rps[1].need_clip = False
    ref = make(paddle.nn)([(p, to_tensor(g)) for p, g in zip(rps, gs)])
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    tps[1].need_clip = False
    got = make(tnn)([(p, torch.from_numpy(g)) for p, g in zip(tps, gs)])
    for (_, r), (_, t) in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), r.numpy(), **TOL)
    np.testing.assert_array_equal(got[1][1].numpy(), gs[1])  # need_clip False


def test_clip_grad_norm_and_value_match_reference():
    gs = _grads(2)
    rps = [paddle.Parameter(np.zeros_like(g)) for g in gs]
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(rps, gs):
        p.grad = to_tensor(g)
    for p, g in zip(tps, gs):
        p.grad = torch.from_numpy(g.copy())
    ref_total = paddle.nn.clip.clip_grad_norm_(rps, 2.0)
    got_total = tclip.clip_grad_norm_(tps, 2.0)
    np.testing.assert_allclose(got_total.item(), float(ref_total.numpy()), **TOL)
    for r, t in zip(rps, tps):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), **TOL)
    paddle.nn.clip.clip_grad_value_(rps, 0.1)
    tclip.clip_grad_value_(tps, 0.1)
    for r, t in zip(rps, tps):
        np.testing.assert_allclose(t.grad.numpy(), r.grad.numpy(), **TOL)
    t = torch.nn.Parameter(torch.zeros(3))
    t.grad = torch.tensor([3.0, -4.0, 0.0])
    np.testing.assert_allclose(tclip.clip_grad_norm_(t, 10.0).item(), 5.0)
    np.testing.assert_allclose(t.grad.numpy(), [3.0, -4.0, 0.0])  # under the norm


# ---------------------------------------------------------------------------
# a reference checkpoint resumed in the port
# ---------------------------------------------------------------------------


def _ids(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(2e-3, 10), 2, 0.0, 2e-3)


def _ref_model():
    paddle.seed(31)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(num_key_value_heads=2))
    jm.train()
    return jm


def test_reference_checkpoint_resumes_in_the_port():
    jm = _ref_model()
    sched = _sched(paddle.optimizer.lr)
    jopt = paddle.optimizer.AdamW(learning_rate=sched, parameters=jm.parameters(),
                                  weight_decay=0.05)
    for step in range(3):
        if step == 2:  # the checkpoint after two steps
            weights = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
            tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(num_key_value_heads=2),
                                         device="cpu").train()
            load_reference_state(tm, weights)
            topt = optimizer.AdamW(learning_rate=_sched(optimizer.lr),
                                   parameters=tm.named_parameters(), weight_decay=0.05)
            load_reference_optimizer_state(topt, jopt.state_dict(), jm)
            assert topt.get_lr() == jopt.get_lr() and topt._learning_rate.last_epoch == 2
        ids = _ids(step)
        loss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        sched.step()
    tids = torch.from_numpy(_ids(2))
    tloss, _ = tm(tids, labels=tids)
    np.testing.assert_allclose(tloss.item(), float(loss.numpy()), rtol=1e-5)
    tloss.backward()
    topt.step()
    lin = {n for n, m in tm.named_modules() if isinstance(m, torch.nn.Linear)}
    ref = dict(jm.named_parameters())
    for name, p in tm.named_parameters():
        w = p.detach().numpy()
        if name.rsplit(".", 1)[0] in lin:
            w = w.T
        np.testing.assert_allclose(w, ref[name].numpy(), atol=1e-5, err_msg=name)
    # the moments crossed transposed with their weights
    q = "llama.layers.0.self_attn.q_proj.weight"
    m1 = jopt._accumulators[("moment1", ref[q].name)].numpy()
    np.testing.assert_allclose(topt.state[dict(tm.named_parameters())[q]]["moment1"]
                               .numpy().T, m1, atol=1e-6)


def test_reference_masters_cross_transposed():
    jm = _ref_model()
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    ids = _ids(5)
    loss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
    loss.backward()
    jopt.step()
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(num_key_value_heads=2),
                                 device="cpu")
    topt = optimizer.AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    load_reference_optimizer_state(topt, jopt.state_dict(), jm)
    ref = dict(jm.named_parameters())
    name = "lm_head.weight"
    got = topt.state[dict(tm.named_parameters())[name]]
    np.testing.assert_array_equal(got["master_weight"].numpy().T,
                                  jopt._master_weights[ref[name].name].numpy())
    assert got["master_weight"].dtype == torch.float32
    with pytest.raises(KeyError, match="named_parameters"):
        load_reference_optimizer_state(
            optimizer.AdamW(parameters=tm.parameters()), jopt.state_dict(), jm)


def test_port_state_dict_round_trips_masters_and_scheduler():
    """torch's state_dict, loaded into a fresh optimizer: the float32
    masters and moments of a bf16 parameter stay float32 (torch alone would
    cast them to the parameter's dtype) and the scheduler resumes."""
    def make():
        p = torch.nn.Parameter(torch.linspace(-1, 1, 6).bfloat16())
        sched = optimizer.lr.StepDecay(0.1, 2, 0.5)
        return p, sched, optimizer.AdamW(learning_rate=sched, parameters=[p],
                                         multi_precision=True)

    p, sched, opt = make()
    for _ in range(3):
        p.grad = torch.full((6,), 0.3).bfloat16()
        opt.step()
        sched.step()
    q, sched2, opt2 = make()
    opt2.load_state_dict(opt.state_dict())
    for k, v in opt.state[p].items():
        assert opt2.state[q][k].dtype == v.dtype == torch.float32
        assert torch.equal(opt2.state[q][k], v), k
    assert sched2.last_epoch == 3 and opt2.get_lr() == opt.get_lr() == 0.05
    q.data.copy_(p.data)
    for x, o in ((p, opt), (q, opt2)):
        x.grad = torch.full((6,), -0.2).bfloat16()
        o.step()
    assert torch.equal(opt2.state[q]["master_weight"], opt.state[p]["master_weight"])
