"""FLAGS_check_nan_inf of the port against the reference's, on the CPU.

The counterparts of `tests/test_nan_check_compiled.py`: the same steps and
inputs through `paddle_tpu` and `paddle_tpu_torch`, each with the flag set
in its own package.  A to_static step with a non-finite operator output
raises FloatingPointError naming the compiled step and the operator, after
its state was written (the reference's order); a clean step returns the
same loss; an eager operator raises under no_grad; with the flag off
nothing is checked and no mode is installed.  Then the port's own
contract: the flag is part of a step's signature, and a step traced with
it off records nothing.
"""

import ctypes

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

import paddle_tpu as paddle
from paddle_tpu.framework import core as jcore
from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import nan_inf


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Restore both packages' global generators, so later modules see the
    streams as if this one never ran."""
    state, torch_state = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(state)
    torch.set_rng_state(torch_state)


@pytest.fixture
def nan_flag():
    jcore.set_flags({"FLAGS_check_nan_inf": True})
    tcore.set_flags({"FLAGS_check_nan_inf": True})
    yield
    jcore.set_flags({"FLAGS_check_nan_inf": False})
    tcore.set_flags({"FLAGS_check_nan_inf": False})


def j(x, rg=False):
    out = paddle.to_tensor(np.asarray(x, np.float32))
    out.stop_gradient = not rg
    return out


def t(x, rg=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=rg)


def _steps(loss_fn):
    """The same SGD step over one weight in both packages: (reference step,
    its weight, port step, its weight)."""
    jw, tw = j([1.0], True), t([1.0], True)
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[jw])
    topt = optimizer.SGD(learning_rate=0.1, parameters=[tw])

    @paddle.jit.to_static
    def jstep(x):
        loss = loss_fn(jw * x).sum()
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    @jit.to_static
    def tstep(x):
        loss = loss_fn(tw * x).sum()
        loss.backward()
        topt.step()
        topt.clear_grad()
        return loss

    return jstep, jw, tstep, tw


def test_compiled_step_raises_with_op_attribution(nan_flag):
    jstep, jw, tstep, tw = _steps(lambda y: y.log())  # log(negative) -> NaN
    for step, x in ((jstep, j([-1.0])), (tstep, t([-1.0]))):
        with pytest.raises(FloatingPointError, match="compiled step.*log"):
            step(x)
    # the step's update was written before the raise, as the reference
    # writes it (d log(w x) / dw = 1 / w is finite: w moves to 0.9)
    np.testing.assert_array_equal(tw.detach().numpy(), jw.numpy())
    assert tw.item() != 1.0


def test_compiled_step_clean_inputs_pass(nan_flag):
    jstep, jw, tstep, tw = _steps(lambda y: y ** 2)
    for _ in range(2):
        jl, tl = jstep(j([2.0])), tstep(t([2.0]))
        assert np.isfinite(float(tl)) and float(tl) == float(jl.numpy())
    np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), rtol=1e-6)
    assert tstep.trace_count == 1


def test_eager_no_grad_path_checked(nan_flag):
    for mk, grad in ((j, paddle.no_grad), (t, torch.no_grad)):
        x = mk([0.0])
        with grad():
            with pytest.raises(FloatingPointError, match="log"):
                _ = (x - 1.0).log()


def test_eager_backward_checked(nan_flag):
    """The check reaches the backward's operators too."""
    x = t([0.0], True)
    y = torch.sqrt(x)  # finite: 0
    with pytest.raises(FloatingPointError, match="NaN or Inf found in output of op"):
        y.sum().backward()  # d sqrt at 0 is inf


def test_flag_off_no_overhead_and_no_raise():
    for mk in (j, t):
        out = mk([-1.0]).log()  # NaN, silently allowed when the flag is off
        assert np.isnan(out.numpy()).all()
    assert not nan_inf.installed()
    assert not any(isinstance(m, nan_inf.NanInfCheck)
                   for m in _get_current_dispatch_mode_stack())


def test_flag_is_part_of_the_signature():
    """A step traced with the flag off records nothing and runs NaN
    through; turning the flag on traces again and checks; off again
    reuses the unchecked trace."""
    _, _, tstep, tw = _steps(lambda y: y.log())
    assert torch.isnan(tstep(t([-1.0]))).all()
    tcore.set_flags({"FLAGS_check_nan_inf": True})
    try:
        with pytest.raises(FloatingPointError, match="compiled step; first offending ops: "):
            tstep(t([-1.0]))
    finally:
        tcore.set_flags({"FLAGS_check_nan_inf": False})
    assert tstep.trace_count == 2
    tstep(t([-1.0]))
    assert tstep.trace_count == 2


def test_allocations_and_views_are_not_read(nan_flag):
    """An allocator's output holds no value it wrote, and a view shows its
    base's: neither is read, so memory left non-finite by earlier work
    raises nothing; the next operator that writes it is checked."""
    x = torch.from_numpy(np.full(4, np.nan, np.float32))  # made by no operator
    with torch.no_grad():
        x.view(2, 2)
        x.detach()
        torch.empty_like(x)
        x.new_empty((4,))
        torch.empty(0).set_(x.untyped_storage())
        with pytest.raises(FloatingPointError, match="'add'"):
            _ = x + 0.0


def test_kernel_outputs_checked_after_launch(nan_flag):
    """What a kernel writes outside the dispatcher (its wrapper allocates
    with `empty`, which is not read) is checked when the wrapper hands it
    over: eager, it raises naming the kernel; inside a to_static step, the
    step raises after its run naming it."""

    def kernel(n, value):  # a launch writing its output by pointer
        out = torch.empty(n)
        src = np.full(n, value, np.float32)
        ctypes.memmove(out.data_ptr(), src.ctypes.data, src.nbytes)
        nan_inf.check_written("fake_kernel", (out,))
        return out

    kernel(3, 1.0)
    with pytest.raises(FloatingPointError, match="'fake_kernel'"):
        kernel(3, float("nan"))

    @jit.to_static
    def step(x):
        return x + kernel(3, float("inf")).sum()

    with pytest.raises(FloatingPointError, match="compiled step.*fake_kernel"):
        step(t([1.0]))


def test_checks_of_two_threads_stay_apart(nan_flag):
    """One thread's to_static call records while another thread, with its
    own eager check on, makes a NaN: the NaN raises in that thread, and the
    call's record holds none of its operators."""
    import threading

    recording, made = threading.Event(), threading.Event()
    seen = {}

    @jit.to_static
    def step(x):
        y = x * 2.0
        recording.set()
        made.wait(30)
        return y + 1.0

    def other():
        recording.wait(30)
        try:
            tcore.set_flags({"FLAGS_check_nan_inf": True})
            (t([-1.0]) * 1.0).log()
        except FloatingPointError as e:
            seen["raised"] = str(e)
        finally:
            made.set()

    worker = threading.Thread(target=other)
    worker.start()
    out = step(t([1.0]))
    worker.join(30)
    assert "'log'" in seen.get("raised", "")
    assert float(out) == 3.0
