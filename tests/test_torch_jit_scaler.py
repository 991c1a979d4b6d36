"""Dynamic loss scaling inside the port's `jit.to_static` steps, against the
reference's compiled steps (`tests/test_grad_scaler_compiled.py`'s five
cases), on the CPU.

Each case runs the same sequence of inputs through a step under the
reference's `paddle.jit.to_static` and under the port's and holds the
weights, moments, scale and counters equal (exactly: one-element float32
math in the same order).  Inside a port step the skip of a non-finite
step is a select on the device (`Optimizer._apply`, `adam_multi_plain`),
never a host read, and `update()` outside a step whose `scaler.step()` ran
inside it raises as the reference's does.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu_torch import amp, jit, optimizer


def j(x, rg=False):
    out = paddle.to_tensor(np.asarray(x, np.float32))
    out.stop_gradient = not rg
    return out


def t(x, rg=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=rg)


class _Pair:
    """One weight, optimizer and scaler in each package, and a step over
    them: `loss = (w * x).sum()`, scaled, backward, `scaler.step`, then
    `scaler.update()` when `update` and `opt.clear_grad()`."""

    def __init__(self, w0, opt, opt_kw, scaler_kw, update=True, compiled=True):
        self.jw, self.tw = j(w0, rg=True), t(w0, rg=True)
        self.jopt = getattr(paddle.optimizer, opt)(parameters=[self.jw], **opt_kw)
        self.topt = getattr(optimizer, opt)(parameters=[self.tw], **opt_kw)
        self.js = paddle.amp.GradScaler(**scaler_kw)
        self.ts = amp.GradScaler(**scaler_kw)

        def body(w, o, s, x):
            loss = (w * x).sum()
            s.scale(loss).backward()
            s.step(o)
            if update:
                s.update()
            o.clear_grad()
            return loss

        jbody = lambda x: body(self.jw, self.jopt, self.js, x)  # noqa: E731
        tbody = lambda x: body(self.tw, self.topt, self.ts, x)  # noqa: E731
        self.jstep = paddle.jit.to_static(jbody) if compiled else jbody
        self.tstep = jit.to_static(tbody) if compiled else tbody

    def __call__(self, x):
        self.jstep(j(x))
        self.tstep(t(x))
        np.testing.assert_array_equal(self.tw.detach().numpy(), self.jw.numpy())
        assert self.ts.get_loss_scaling().item() == float(
            self.js.get_loss_scaling().numpy())


def test_compiled_step_skips_injected_inf_and_resumes():
    s = _Pair([1.0], "SGD", dict(learning_rate=0.1),
              dict(init_loss_scaling=4.0, incr_every_n_steps=2,
                   decr_every_n_nan_or_inf=1))
    s([1.0])  # grad 1: w 1.0 -> 0.9
    np.testing.assert_allclose(s.tw.detach().numpy(), [0.9], rtol=1e-6)
    s([np.inf])  # an inf gradient: the same captured step skips
    np.testing.assert_allclose(s.tw.detach().numpy(), [0.9], rtol=1e-6)
    assert s.ts.get_loss_scaling().item() == pytest.approx(2.0)
    assert s.ts.last_found_inf
    s([1.0])  # resumes: w 0.9 -> 0.8
    np.testing.assert_allclose(s.tw.detach().numpy(), [0.8], rtol=1e-6)
    assert s.tstep.trace_count == 1 and not s.ts.last_found_inf


def test_compiled_scale_grows_after_good_steps():
    s = _Pair([1.0], "SGD", dict(learning_rate=0.0),
              dict(init_loss_scaling=8.0, incr_every_n_steps=2, incr_ratio=2.0))
    s([1.0])
    assert s.ts.get_loss_scaling().item() == pytest.approx(8.0)
    s([1.0])  # the second good step: 8 -> 16
    assert s.ts.get_loss_scaling().item() == pytest.approx(16.0)
    assert s.ts._good_steps.item() == 0 and s.tstep.trace_count == 1


def test_compiled_adam_first_step_skip_keeps_moments_at_init():
    """A skipped first step leaves the accumulators at their initial fill
    (the reference's skipped steps never touch moments)."""
    s = _Pair([2.0], "Adam", dict(learning_rate=0.1), dict(init_loss_scaling=2.0))
    s([np.inf])  # the first step is skipped
    np.testing.assert_array_equal(s.tw.detach().numpy(), [2.0])
    accs = {n: a for (n, _), a in s.jopt._accumulators.items()}
    st = s.topt.state[s.tw]
    np.testing.assert_array_equal(st["moment1"].numpy(), accs["moment1"].numpy())
    assert st["moment1"].item() == 0.0 and st["beta1_pow"].item() == 1.0
    s([1.0])  # now a real Adam step
    assert s.tw.item() < 2.0
    assert st["beta1_pow"].item() == pytest.approx(0.9)
    for name in ("moment1", "moment2"):
        np.testing.assert_array_equal(st[name].numpy(), accs[name].numpy())


def test_update_outside_compiled_fn_raises_clear_error():
    """step() inside to_static and update() outside: the reference's error,
    and the trace's double run leaves the scaler usable eagerly."""
    s = _Pair([1.0], "SGD", dict(learning_rate=0.1), dict(init_loss_scaling=4.0),
              update=False)
    s([1.0])  # traces without an 'already been called' error
    for scaler in (s.js, s.ts):
        with pytest.raises(RuntimeError, match="inside the same compiled"):
            scaler.update()
    for w, o, scaler in ((s.jw, s.jopt, s.js), (s.tw, s.topt, s.ts)):
        loss = (w * 2).sum()
        scaler.scale(loss).backward()
        scaler.step(o)
        scaler.update()
    np.testing.assert_array_equal(s.tw.detach().numpy(), s.jw.numpy())


def test_eager_parity_with_compiled():
    """The same sequence eagerly and compiled, in both packages, gives the
    same weights and scale."""
    out = {}
    for compiled in (False, True):
        s = _Pair([1.0], "SGD", dict(learning_rate=0.1),
                  dict(init_loss_scaling=4.0, incr_every_n_steps=3,
                       decr_every_n_nan_or_inf=1), compiled=compiled)
        for x in ([1.0], [np.inf], [2.0], [1.0]):
            s(x)
        out[compiled] = (s.tw.item(), s.ts.get_loss_scaling().item())
    assert out[False] == out[True]
