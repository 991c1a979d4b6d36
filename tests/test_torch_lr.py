"""The port's LR schedulers (`paddle_tpu_torch.optimizer.lr`) against the
JAX package's, on the CPU.

Every scheduler, built with the same arguments in both packages, gives the
same rate over 30 steps within 1e-12 (the same float64 formulas in the
same order; most agree exactly).  `state_dict` round trips, and an
optimizer driven by a scheduler moves its parameters as the reference's
does, within 1e-6 (float32 updates).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.optimizer import lr as tlr

jlr = paddle.optimizer.lr
STEPS = 30

SCHEDULERS = {
    "noam": lambda m: m.NoamDecay(d_model=64, warmup_steps=5, learning_rate=2.0),
    "piecewise": lambda m: m.PiecewiseDecay([3, 8, 15], [0.1, 0.05, 0.01, 0.001]),
    "natural_exp": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "inverse_time": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "polynomial": lambda m: m.PolynomialDecay(0.5, 10, end_lr=0.01, power=2.0),
    "polynomial_cycle": lambda m: m.PolynomialDecay(0.5, 7, end_lr=0.01, cycle=True),
    "linear_warmup": lambda m: m.LinearWarmup(0.3, 5, 0.0, 0.3),
    "linear_warmup_cosine": lambda m: m.LinearWarmup(
        m.CosineAnnealingDecay(0.3, 20, eta_min=0.01), 5, 0.0, 0.3),
    "exponential": lambda m: m.ExponentialDecay(0.5, 0.9),
    "multistep": lambda m: m.MultiStepDecay(0.5, [4, 9, 20], 0.5),
    "step": lambda m: m.StepDecay(0.5, 4, 0.7),
    "lambda": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "cosine": lambda m: m.CosineAnnealingDecay(0.5, 10, eta_min=0.01),
    "cosine_warm_restarts": lambda m: m.CosineAnnealingWarmRestarts(
        0.5, 4, T_mult=2, eta_min=0.01),
    "one_cycle": lambda m: m.OneCycleLR(0.5, 30),
    "cyclic_triangular": lambda m: m.CyclicLR(0.01, 0.1, 4, 6),
    "cyclic_triangular2": lambda m: m.CyclicLR(0.01, 0.1, 4, 6, mode="triangular2"),
    "cyclic_exp_range": lambda m: m.CyclicLR(0.01, 0.1, 3, mode="exp_range",
                                             exp_gamma=0.9),
}


def _rates(sched, steps=STEPS):
    out = [sched()]
    for _ in range(steps):
        sched.step()
        out.append(sched())
    return out


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_rates_match_reference(name):
    make = SCHEDULERS[name]
    ref, got = _rates(make(jlr)), _rates(make(tlr))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    assert len(set(got)) > 1 or name == "piecewise"


# a loss that falls, stalls, rises and falls again
METRICS = [5.0, 4.0, 3.9, 3.9, 3.9, 3.9, 4.1, 3.0, 3.0, 3.0, 3.0, 3.0, 2.0, 2.5,
           2.5, 2.5, 2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5,
           0.5, 0.5]


@pytest.mark.parametrize("kw", [
    dict(patience=2, factor=0.5),
    dict(patience=1, factor=0.3, cooldown=2, min_lr=0.05),
    dict(mode="max", patience=2, factor=0.5),
    dict(patience=2, threshold=0.2, threshold_mode="abs", factor=0.5),
], ids=["min", "cooldown_min_lr", "max", "abs"])
def test_reduce_on_plateau_matches_reference(kw):
    ref, got = jlr.ReduceOnPlateau(1.0, **kw), tlr.ReduceOnPlateau(1.0, **kw)
    rates_ref, rates_got = [], []
    for i, metric in enumerate(METRICS):
        ref.step(to_tensor(np.float32(metric)) if i % 2 else metric)
        got.step(torch.tensor(metric) if i % 2 else metric)
        rates_ref.append(ref())
        rates_got.append(got())
    np.testing.assert_allclose(rates_got, rates_ref, rtol=0, atol=1e-12)
    assert min(rates_got) < 1.0


def test_step_to_an_epoch_matches_reference():
    ref, got = jlr.StepDecay(0.5, 3, 0.5), tlr.StepDecay(0.5, 3, 0.5)
    for epoch in (7, 2, 12):
        ref.step(epoch)
        got.step(epoch)
        assert got() == ref() and got.last_epoch == epoch


@pytest.mark.parametrize("name", ["step", "cosine_warm_restarts", "one_cycle",
                                  "linear_warmup"])
def test_state_dict_round_trips(name):
    a = SCHEDULERS[name](tlr)
    for _ in range(7):
        a.step()
    b = SCHEDULERS[name](tlr)
    b.set_state_dict(a.state_dict())
    assert _rates(b, 10) == _rates(a, 10)
    c = SCHEDULERS[name](tlr)
    c.set_dict(a.state_keys())
    assert c() == a() and c.last_epoch == a.last_epoch


def _ref_run(cls, sched, w0s, grads, **kw):
    ps = [paddle.Parameter(w.copy(), name=f"p{i}") for i, w in enumerate(w0s)]
    opt = getattr(paddle.optimizer, cls)(learning_rate=sched, parameters=ps, **kw)
    rates = []
    for gs in grads:
        sum((p * to_tensor(g)).sum() for p, g in zip(ps, gs)).backward()
        rates.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
    return [p.numpy() for p in ps], rates


def _port_run(cls, sched, w0s, grads, **kw):
    ps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0s]
    opt = getattr(optimizer, cls)(learning_rate=sched, parameters=ps, **kw)
    rates = []
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g)
        rates.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.1)
    assert opt.state_dict()["LR_Scheduler"]["last_epoch"] == len(grads)
    return [p.detach().numpy() for p in ps], rates


@pytest.mark.parametrize("cls,kw", [("AdamW", {}), ("Adam", {"lazy_mode": True}),
                                    ("Momentum", {"use_nesterov": True}),
                                    ("SGD", {})])
def test_optimizer_under_step_decay_matches_reference(cls, kw):
    """Six steps with StepDecay(0.1, 2, 0.5) stepped after each: the rate of
    every step and the parameters after it, within 1e-6."""
    rng = np.random.default_rng(5)
    w0s = [rng.standard_normal((4, 3)).astype(np.float32),
           rng.standard_normal(5).astype(np.float32)]
    grads = [[rng.standard_normal(w.shape).astype(np.float32) for w in w0s]
             for _ in range(6)]
    ref, ref_rates = _ref_run(cls, jlr.StepDecay(0.1, 2, 0.5), w0s, grads, **kw)
    got, got_rates = _port_run(cls, tlr.StepDecay(0.1, 2, 0.5), w0s, grads, **kw)
    assert got_rates == ref_rates and len(set(got_rates)) == 3
    for r, t in zip(ref, got):
        np.testing.assert_allclose(t, r, atol=1e-6, rtol=1e-6)


def test_constant_rate_refreshes_the_device_scalar_only_on_a_change():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = optimizer.SGD(learning_rate=0.5, parameters=[p])
    scalar = opt._lr_t
    calls = []
    real_fill = torch.Tensor.fill_
    try:
        torch.Tensor.fill_ = lambda self, v: calls.append(v) or real_fill(self, v)
        for _ in range(3):
            p.grad = torch.ones(3)
            opt.step()
        opt.set_lr(0.25)
        p.grad = torch.ones(3)
        opt.step()
    finally:
        torch.Tensor.fill_ = real_fill
    assert calls == [0.25] and opt._lr_t is scalar and float(scalar) == 0.25
    np.testing.assert_allclose(p.detach().numpy(), [-1.75] * 3)
