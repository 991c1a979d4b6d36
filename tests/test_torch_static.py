"""The port's `paddle.static` against the reference's, on the CPU.

The counterparts of `tests/test_jit.py:164-380`: `static.nn.cond` and
`static.nn.while_loop` eager and inside `jit.to_static` steps, with the
same numpy inputs through both packages and the outputs and gradients held
equal (exact: small integer-valued float32 math), then `static.nn.fc` and
the static shim (`Executor`, `data`, `program_guard`, `gradients`).  On
the CPU a to_static call runs its step eagerly, and cond and while_loop
read their predicate on the host; the port's form inside a step (an
autograd Function over the tensors the branches read, the taken branch
alone differentiated) is the one the card captures into conditional
nodes.  Where the reference spies on the untaken branch with a host
callback, the port counts with a tensor each branch increments.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.static as jstatic
from paddle_tpu_torch import jit, static


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """`static.nn.fc` draws its fresh weights from torch's generator and
    the reference's from paddle_tpu's; restore both."""
    state, torch_state = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(state)
    torch.set_rng_state(torch_state)


def j(x, rg=False):
    out = paddle.to_tensor(np.asarray(x, np.float32))
    out.stop_gradient = not rg
    return out


def t(x, rg=False):
    return torch.tensor(np.asarray(x, np.float32), requires_grad=rg)


def ji(x):
    return paddle.to_tensor(np.asarray(x, np.int32))


def ti(x):
    return torch.tensor(np.asarray(x, np.int32))


def test_tensor_bool_inside_trace_names_cond():
    @jit.to_static
    def f(x):
        if x.sum() > 0:
            return x + 1
        return x - 1

    with pytest.raises(TypeError, match="paddle.static.nn.cond"):
        f(t(np.ones(3)))


def test_cond_eager_takes_one_branch():
    for pkg, mk, calls in ((jstatic, j, []), (static, t, [])):
        r = pkg.nn.cond(mk(np.array(False)) if pkg is static else paddle.to_tensor(
            np.array(False)), lambda: (calls.append("t"), mk(1.0))[1],
            lambda: (calls.append("f"), mk(2.0))[1])
        assert float(r.numpy()) == 2.0 and calls == ["f"]


def test_cond_compiled_differentiable_both_ways():
    jw, tw = j([2.0], True), t([2.0], True)

    @paddle.jit.to_static
    def jmodel(x):
        y = (x * jw).sum()
        out = jstatic.nn.cond(y > 0, lambda: y * 3.0, lambda: y * 5.0)
        out.backward()
        return out

    @jit.to_static
    def tmodel(x):
        y = (x * tw).sum()
        out = static.nn.cond(y > 0, lambda: y * 3.0, lambda: y * 5.0)
        out.backward()
        return out

    for xv in ([1.0], [-1.0], [1.0]):
        jo, to = jmodel(j(xv)), tmodel(t(xv))
        assert float(to) == float(jo.numpy())
        np.testing.assert_array_equal(tw.grad.numpy(), jw.grad.numpy())
        jw.clear_gradient()
        tw.grad = None
    assert tmodel.trace_count == jmodel.trace_count == 1


def test_cond_untaken_branch_does_not_execute():
    """Only the taken branch runs, in every call of one trace: a counter
    tensor each branch increments."""
    hits = torch.zeros(2, dtype=torch.int32)

    @jit.to_static
    def model(x):
        y = x.sum()

        def true_fn():
            hits[0:1].add_(1)
            return y * 3.0

        def false_fn():
            hits[1:2].add_(1)
            return y * 5.0

        return static.nn.cond(y > 0, true_fn, false_fn)

    assert float(model(t([1.0]))) == 3.0 and hits.tolist() == [1, 0]
    assert float(model(t([1.0]))) == 3.0 and hits.tolist() == [2, 0]
    assert float(model(t([-1.0]))) == -5.0 and hits.tolist() == [2, 1]
    assert model.trace_count == 1


def test_cond_gradient_not_poisoned_by_untaken_branch():
    jx, tx = j([-4.0], True), t([-4.0], True)

    @paddle.jit.to_static
    def jmodel():
        s = jx.sum()
        out = jstatic.nn.cond(s > 0, lambda: paddle.sqrt(s), lambda: s * 2.0)
        out.backward()
        return out

    @jit.to_static
    def tmodel():
        s = tx.sum()
        out = static.nn.cond(s > 0, lambda: torch.sqrt(s), lambda: s * 2.0)
        out.backward()
        return out

    assert float(tmodel()) == float(jmodel().numpy()) == -8.0
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())
    assert tx.grad.tolist() == [2.0]  # not NaN


def test_cond_passthrough_branch_keeps_grad():
    jx, jy = j([3.0], True), j([5.0], True)
    tx, ty = t([3.0], True), t([5.0], True)

    @paddle.jit.to_static
    def jmodel():
        s = jx.sum()
        out = jstatic.nn.cond(s > 0, lambda: jx, lambda: jy)
        (out * 2.0).sum().backward()
        return out

    @jit.to_static
    def tmodel():
        s = tx.sum()
        out = static.nn.cond(s > 0, lambda: tx, lambda: ty)
        (out * 2.0).sum().backward()
        return out

    np.testing.assert_array_equal(tmodel().detach().numpy(), jmodel().numpy())
    np.testing.assert_array_equal(tx.grad.numpy(), jx.grad.numpy())
    assert tx.grad.tolist() == [2.0]


def test_cond_branches_must_agree_only_when_both_run():
    """Eagerly only the taken branch runs, so a mismatched untaken branch
    is never seen (the card's capture of both raises on it)."""
    out = static.nn.cond(t(1.0) > 0, lambda: t([1.0, 2.0]), lambda: t(3.0))
    assert out.tolist() == [1.0, 2.0]


def test_while_loop_compiled_and_eager():
    @paddle.jit.to_static
    def jloop(x):
        _, acc = jstatic.nn.while_loop(lambda i, a: i < 5,
                                       lambda i, a: [i + 1, a * 2.0], [ji(0), x])
        return acc

    @jit.to_static
    def tloop(x):
        _, acc = static.nn.while_loop(lambda i, a: i < 5,
                                      lambda i, a: [i + 1, a * 2.0], [ti(0), x])
        return acc

    assert float(tloop(t(1.0))) == float(jloop(j(1.0)).numpy()) == 32.0
    out = static.nn.while_loop(lambda i: i < 3, lambda i: [i + 1], [ti(0)])
    ref = jstatic.nn.while_loop(lambda i: i < 3, lambda i: [i + 1], [ji(0)])
    assert int(out[0]) == int(ref[0].numpy()) == 3


def test_while_loop_trip_count_from_the_data_one_trace():
    """The loop's bound is an input: each count gives the reference's
    value, one trace serves them all, and the body runs that many times."""
    passes = torch.zeros((), dtype=torch.int32)

    @paddle.jit.to_static
    def jloop(x, n):
        _, acc = jstatic.nn.while_loop(lambda i, a: i < n,
                                       lambda i, a: [i + 1, a * 2.0], [ji(0), x])
        return acc

    @jit.to_static
    def tloop(x, n):
        def body(i, a):
            passes.add_(1)
            return [i + 1, a * 2.0]

        _, acc = static.nn.while_loop(lambda i, a: i < n, body, [ti(0), x])
        return acc

    total = 0
    for n in (5, 3, 0, 7):
        assert float(tloop(t(1.5), ti(n))) == float(jloop(j(1.5), ji(n)).numpy())
        total += n
        assert int(passes) == total
    assert tloop.trace_count == 1


def test_while_loop_max_iters_differentiable():
    jx, tx = j(3.0, True), t(3.0, True)

    @paddle.jit.to_static
    def jmodel():
        _, acc = jstatic.nn.while_loop(lambda i, a: i < 5, lambda i, a: [i + 1, a * 2.0],
                                       [ji(0), jx], max_iters=8)
        acc.backward()
        return acc

    @jit.to_static
    def tmodel():
        _, acc = static.nn.while_loop(lambda i, a: i < 5, lambda i, a: [i + 1, a * 2.0],
                                      [ti(0), tx], max_iters=8)
        acc.backward()
        return acc

    assert float(tmodel()) == float(jmodel().numpy()) == 96.0
    assert float(tx.grad) == float(jx.grad.numpy()) == 32.0


def test_while_loop_max_iters_captured_weight_grad():
    jw, tw = j(2.0, True), t(2.0, True)

    @paddle.jit.to_static
    def jmodel(x):
        _, acc = jstatic.nn.while_loop(lambda i, a: i < 3, lambda i, a: [i + 1, a * jw],
                                       [ji(0), x], max_iters=4)
        acc.backward()
        return acc

    @jit.to_static
    def tmodel(x):
        _, acc = static.nn.while_loop(lambda i, a: i < 3, lambda i, a: [i + 1, a * tw],
                                      [ti(0), x], max_iters=4)
        acc.backward()
        return acc

    assert float(tmodel(t(1.0))) == float(jmodel(j(1.0)).numpy()) == 8.0
    assert float(tw.grad) == float(jw.grad.numpy()) == 12.0


def test_while_loop_max_iters_caps_the_passes():
    """A loop that would run past max_iters stops there, in both."""
    jw, tw = j(2.0, True), t(2.0, True)

    @paddle.jit.to_static
    def jmodel(n):
        _, acc = jstatic.nn.while_loop(lambda i, a: i < n, lambda i, a: [i + 1, a * jw],
                                       [ji(0), j(1.0)], max_iters=4)
        acc.backward()
        return acc

    @jit.to_static
    def tmodel(n):
        _, acc = static.nn.while_loop(lambda i, a: i < n, lambda i, a: [i + 1, a * tw],
                                      [ti(0), t(1.0)], max_iters=4)
        acc.backward()
        return acc

    for n in (6, 2):
        assert float(tmodel(ti(n))) == float(jmodel(ji(n)).numpy())
        assert float(tw.grad) == float(jw.grad.numpy())
        tw.grad = None
        jw.clear_gradient()
    assert tmodel.trace_count == 1


def test_while_loop_max_iters_eager():
    out = static.nn.while_loop(lambda i: i < 3, lambda i: [i + 1], [ti(0)], max_iters=10)
    ref = jstatic.nn.while_loop(lambda i: i < 3, lambda i: [i + 1], [ji(0)], max_iters=10)
    assert int(out[0]) == int(ref[0].numpy()) == 3


def test_while_loop_without_max_iters_is_forward_only():
    x = t(1.0, True)
    _, acc = static.nn.while_loop(lambda i, a: i < 2, lambda i, a: [i + 1, a * 3.0],
                                  [ti(0), x])
    assert float(acc) == 9.0 and not acc.requires_grad


def test_static_nn_fc():
    x = np.random.RandomState(0).rand(4, 2, 3).astype(np.float32)
    out = static.nn.fc(torch.from_numpy(x), size=5, num_flatten_dims=1, activation="relu")
    ref = jstatic.nn.fc(paddle.to_tensor(x), size=5, num_flatten_dims=1, activation="relu")
    assert list(out.shape) == list(ref.shape) == [4, 5]
    assert (out >= 0).all()


def test_static_nn_fc_bad_flatten_dims():
    x = torch.ones(4, 2, 3)
    for dims in (0, 3):
        with pytest.raises(ValueError, match="num_flatten_dims"):
            static.nn.fc(x, 5, num_flatten_dims=dims)
        with pytest.raises(ValueError, match="num_flatten_dims"):
            jstatic.nn.fc(paddle.to_tensor(x.numpy()), 5, num_flatten_dims=dims)


def test_static_shim_executor_data_program_guard_gradients():
    main = static.Program()
    with static.program_guard(main, static.Program()) as prog:
        assert prog is main
        x = static.data("x", [None, 3], "float32", device="cpu")
    assert list(x.shape) == [1, 3] and x.dtype == torch.float32 and not x.any()
    ref = jstatic.data("x", [None, 3], "float32")
    assert list(ref.shape) == [1, 3]
    main._build_fn = lambda x: [x * 2.0, x.sum()]
    exe = static.Executor(static.cpu_places()[0])
    feed = {"x": np.arange(6, dtype=np.float32).reshape(2, 3)}
    outs = exe.run(main, feed=feed)
    jmain = jstatic.Program()
    jmain._build_fn = lambda x: [x * 2.0, x.sum()]
    refs = jstatic.Executor().run(jmain, feed=feed)
    for o, r in zip(outs, refs):
        np.testing.assert_array_equal(o, r)
    assert exe.run(fetch_list=[t([1.0])])[0].tolist() == [1.0]
    assert static.default_main_program() is static.default_main_program()
    assert static.cuda_places([0])[0] == torch.device("cuda", 0)
    a = t([1.0, 2.0], True)
    y = (a * a).sum()
    (g,) = static.gradients(y, a)
    ja = j([1.0, 2.0], True)
    (jg,) = jstatic.gradients((ja * ja).sum(), ja)
    np.testing.assert_array_equal(g.numpy(), jg.numpy())
    assert static.gradients(y, [a, t(1.0, True)])[1] is None  # unused input
