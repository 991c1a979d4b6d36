"""The port's `jit.to_static` against the reference's, on the CPU.

The counterparts of `tests/test_jit.py`'s to_static tests: each feeds the
same numpy inputs to a step under the reference's `paddle.jit.to_static`
and under the port's, and holds the outputs and the state they leave
equal (exactly for elementwise float32 math, 1e-6 otherwise).  Then the
port's own contract: the retrace when a tensor the step reads is rebound,
none when state is loaded in place, `warmup` leaving every tensor,
gradient and generator as it was, returned outputs that survive later
calls, nested calls inline, the unported surface, and `/metrics`'
`paddle_sanitizer_traces_total` counting to_static traces as the
reference's sanitizer does.  On the CPU each call runs the step eagerly
with the card's keys, discovery, refreshers and stale checks.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.analysis import sanitizer as jsan
from paddle_tpu.framework import core as jcore
from paddle_tpu_torch import jit, optimizer
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.optimizer import lr as tlr

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """The reference's random ops draw from paddle_tpu's global generator,
    torch's layers and `torch.randn` from torch's; restore both so later
    modules see the streams as if this one never ran."""
    state, torch_state = paddle.get_rng_state(), torch.get_rng_state()
    yield
    paddle.set_rng_state(state)
    torch.set_rng_state(torch_state)


def j(arr, rg=False):
    return paddle.to_tensor(np.asarray(arr, np.float32), stop_gradient=not rg)


def t(arr, rg=False):
    return torch.tensor(np.asarray(arr, np.float32), requires_grad=rg)


def test_pure_fn():
    @paddle.jit.to_static
    def jf(x, y):
        return x * 2 + y

    @jit.to_static
    def tf(x, y):
        return x * 2 + y

    for a, b in ((np.ones(3), np.full(3, 5.0)), (np.zeros(3), np.ones(3))):
        np.testing.assert_array_equal(tf(t(a), t(b)).numpy(), jf(j(a), j(b)).numpy())
    assert tf.trace_count == jf.trace_count == 1


def test_param_read_sees_updates_and_a_rebinding_retraces():
    jw, tw = j(np.full(2, 3.0)), t(np.full(2, 3.0))

    @paddle.jit.to_static
    def jf(x):
        return x * jw

    @jit.to_static
    def tf(x):
        return x * tw

    np.testing.assert_array_equal(tf(t(np.ones(2))).numpy(), jf(j(np.ones(2))).numpy())
    jw._data = jw._data * 2
    tw.mul_(2)  # in place: the captured step reads it, no retrace
    np.testing.assert_array_equal(tf(t(np.ones(2))).numpy(), jf(j(np.ones(2))).numpy())
    assert tf.trace_count == 1
    jw._data = jw._data * 2
    tw.data = tw.data * 2  # rebound: the graph's address is stale, so it retraces
    np.testing.assert_array_equal(tf(t(np.ones(2))).numpy(), jf(j(np.ones(2))).numpy())
    np.testing.assert_array_equal(tf(t(np.ones(2))).numpy(), [12.0, 12.0])
    assert tf.trace_count == 2


def test_state_write():
    jacc, tacc = j(np.zeros(1)), t(np.zeros(1))

    @paddle.jit.to_static
    def jf(x):
        jacc._data = jacc._data + x._data.sum()
        return jacc.clone()

    @jit.to_static
    def tf(x):
        tacc.add_(x.sum())
        return tacc.clone()

    for _ in range(2):
        out = tf(t(np.ones(3)))
        jf(j(np.ones(3)))
    np.testing.assert_array_equal(tacc.numpy(), jacc.numpy())
    np.testing.assert_array_equal(out.numpy(), [6.0])


def test_multiple_signatures():
    @paddle.jit.to_static
    def jf(x):
        return x.sum()

    @jit.to_static
    def tf(x):
        return x.sum()

    for shape in ((3,), (2, 2), (3,)):
        assert float(tf(t(np.ones(shape)))) == float(jf(j(np.ones(shape))).numpy())
    assert len(tf._cache) == len(jf._cache) == 2
    assert tf.trace_count == 2


def test_structured_io():
    @paddle.jit.to_static
    def jf(batch):
        return {"out": batch["a"] + batch["b"], "aux": [batch["a"] * 2]}

    @jit.to_static
    def tf(batch):
        return {"out": batch["a"] + batch["b"], "aux": [batch["a"] * 2]}

    a, b = np.ones(2), np.full(2, 2.0)
    jo, to = jf({"a": j(a), "b": j(b)}), tf({"a": t(a), "b": t(b)})
    np.testing.assert_array_equal(to["out"].numpy(), jo["out"].numpy())
    np.testing.assert_array_equal(to["aux"][0].numpy(), jo["aux"][0].numpy())


def test_train_step_compiled_matches_eager_and_the_reference():
    """Five SGD steps of a Linear: the port's captured step equals its eager
    step exactly and the reference's compiled one within 1e-6."""
    paddle.seed(0)
    jm = jnn.Linear(4, 2)
    w0, b0 = jm.weight.numpy(), jm.bias.numpy()
    jopt = paddle.optimizer.SGD(learning_rate=0.1, parameters=jm.parameters())
    mods = []
    for _ in range(2):
        tm = torch.nn.Linear(4, 2)
        with torch.no_grad():
            tm.weight.copy_(torch.from_numpy(w0.T.copy()))
            tm.bias.copy_(torch.from_numpy(b0))
        mods.append((tm, optimizer.SGD(learning_rate=0.1, parameters=tm.parameters())))
    jlossfn = jnn.MSELoss()

    @paddle.jit.to_static
    def jstep(x, y):
        loss = jlossfn(jm(x), y)
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        return loss

    def tstep(m, opt, x, y):
        loss = ((m(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    static = jit.to_static(lambda x, y: tstep(*mods[1], x, y))
    rng = np.random.default_rng(0)
    for _ in range(5):
        x = rng.random((8, 4)).astype(np.float32)
        y = rng.random((8, 2)).astype(np.float32)
        eager = tstep(*mods[0], t(x), t(y))
        captured = static(t(x), t(y))
        assert torch.equal(eager, captured)
        np.testing.assert_allclose(captured.item(), float(jstep(j(x), j(y)).numpy()),
                                   **TOL)
    assert static.trace_count == 1
    for a, b in zip(mods[0][0].parameters(), mods[1][0].parameters()):
        assert torch.equal(a, b)
    np.testing.assert_allclose(mods[1][0].weight.detach().numpy().T, jm.weight.numpy(),
                               **TOL)


def test_rng_threaded_not_baked():
    @paddle.jit.to_static
    def jf(x):
        return x + paddle.randn(x.shape)

    @jit.to_static
    def tf(x):
        return x + torch.randn(x.shape)

    for f, mk in ((jf, j), (tf, t)):
        a = np.asarray(f(mk(np.zeros(4))).numpy())
        b = np.asarray(f(mk(np.zeros(4))).numpy())
        assert not np.allclose(a, b), "RNG was baked as a constant"


def test_dropout_varies_and_draws_from_a_discovered_generator():
    import paddle_tpu.nn.functional as JF

    @paddle.jit.to_static
    def jf(x):
        return JF.dropout(x, 0.5, training=True)

    gen = torch.Generator().manual_seed(5)

    @jit.to_static
    def tf(x):
        return TF.dropout(x, 0.5, training=True, generator=gen)

    ja, jb = jf(j(np.ones(100))).numpy(), jf(j(np.ones(100))).numpy()
    ta, tb = tf(t(np.ones(100))).numpy(), tf(t(np.ones(100))).numpy()
    assert not np.array_equal(ja, jb) and not np.array_equal(ta, tb)
    # the generator is the step's state: the same draws as eager from the seed
    gen.manual_seed(5)
    want = [TF.dropout(t(np.ones(100)), 0.5, training=True, generator=gen).numpy()
            for _ in range(2)]
    np.testing.assert_array_equal(ta, want[0])
    np.testing.assert_array_equal(tb, want[1])
    entry = next(iter(tf._cache.values()))
    assert tf.trace_count == 1 and entry.state == []


def test_lr_schedule_visible_in_compiled_step():
    jw, tw = j(np.array([0.0]), rg=True), t(np.array([0.0]), rg=True)
    jsched = paddle.optimizer.lr.StepDecay(1.0, step_size=1, gamma=0.1)
    tsched = tlr.StepDecay(1.0, step_size=1, gamma=0.1)
    jopt = paddle.optimizer.SGD(learning_rate=jsched, parameters=[jw])
    topt = optimizer.SGD(learning_rate=tsched, parameters=[tw])

    @paddle.jit.to_static
    def jstep():
        (jw * 1.0).sum().backward()
        jopt.step()
        jopt.clear_grad()

    @jit.to_static
    def tstep():
        (tw * 1.0).sum().backward()
        topt.step()
        topt.clear_grad()

    for _ in range(3):
        jstep()
        tstep()
        np.testing.assert_allclose(tw.detach().numpy(), jw.numpy(), **TOL)
        jsched.step()
        tsched.step()
    np.testing.assert_allclose(tw.detach().numpy(), [-1.11], rtol=1e-5)
    assert tstep.trace_count == 1


def test_batchnorm_stats_updated_under_jit():
    jbn, tbn = jnn.BatchNorm1D(3), tnn.BatchNorm1D(3, device="cpu")

    @paddle.jit.to_static
    def jf(x):
        return jbn(x)

    @jit.to_static
    def tf(x):
        return tbn(x)

    rng = np.random.default_rng(1)
    before = tbn._mean.clone()
    for _ in range(2):
        x = (rng.random((8, 3)) * 10).astype(np.float32)
        np.testing.assert_allclose(tf(t(x)).numpy(), jf(j(x)).numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert not torch.equal(before, tbn._mean)
    np.testing.assert_allclose(tbn._mean.numpy(), jbn._mean.numpy(), rtol=1e-6)
    np.testing.assert_allclose(tbn._variance.numpy(), jbn._variance.numpy(), rtol=1e-5)


@pytest.mark.parametrize("read", ["numpy", "item", "tolist"])
def test_host_read_inside_trace_raises(read):
    @paddle.jit.to_static
    def jf(x):
        # analysis: allow GRAFT003 — deliberate hazard: this test asserts the runtime error
        return float(x.numpy().sum())

    @jit.to_static
    def tf(x):
        return getattr(x.sum(), read)()

    with pytest.raises(Exception):
        jf(j(np.ones(2)))
    with pytest.raises(RuntimeError, match=f"Tensor.{read}.. is not allowed"):
        tf(t(np.ones(2)))


@pytest.mark.parametrize("cast", [bool, float, int])
def test_tensor_as_python_scalar_inside_trace_raises_actionable(cast):
    @paddle.jit.to_static
    def jf(x):
        # analysis: allow GRAFT001 — deliberate hazard: asserts the actionable TypeError
        if x.sum() > 0:
            return x + 1
        return x - 1

    @jit.to_static
    def tf(x):
        return x + cast(x.sum())

    with pytest.raises(TypeError, match="paddle.static.nn.cond"):
        jf(j(np.ones(3)))
    with pytest.raises(TypeError, match="paddle.static.nn.cond"):
        tf(t(np.ones(3)))


def _adam_pair(seed=3):
    m = torch.nn.Linear(3, 2)
    gen = torch.Generator().manual_seed(seed)
    for p in m.parameters():
        torch.nn.init.normal_(p, generator=gen)
    opt = optimizer.Adam(learning_rate=0.1, parameters=m.named_parameters())

    def step(x):
        loss = (m(x) ** 2).sum()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return m, opt, step


def _opt_state(m, opt):
    out = [p.detach().clone() for p in m.parameters()]
    for p in m.parameters():
        out += [v.clone() for _, v in sorted(opt.state[p].items())]
    return out


def test_load_state_in_place_keeps_the_trace_and_is_read():
    """A checkpoint resume: `set_state_dict` / `load_state_dict` copy into
    the tensors the step was traced over, so the step goes on without a
    retrace and reads the loaded values."""
    m, opt, step = _adam_pair()
    m2, opt2, eager = _adam_pair()
    static = jit.to_static(step)
    x = t(np.ones((4, 3)))
    static(x)
    ckpt = ({k: v.clone() for k, v in m.state_dict().items()}, opt.state_dict())
    ckpt = (ckpt[0], {"state": {i: {k: v.clone() for k, v in s.items()}
                                for i, s in ckpt[1]["state"].items()},
                      "param_groups": ckpt[1]["param_groups"]})
    static(x)
    static(x)
    m.load_state_dict(ckpt[0])
    opt.load_state_dict(ckpt[1])
    m2.load_state_dict(ckpt[0])
    eager(x)  # m2's moments now exist, so its load lands in place too
    m2.load_state_dict(ckpt[0])
    opt2.load_state_dict(ckpt[1])
    assert torch.equal(static(x), eager(x))
    assert static.trace_count == 1
    for a, b in zip(_opt_state(m, opt), _opt_state(m2, opt2)):
        assert torch.equal(a, b)


def test_rebinding_state_or_gradients_retraces():
    m, opt, step = _adam_pair()
    static = jit.to_static(step)
    x = t(np.ones((4, 3)))
    static(x)
    static(x)
    assert static.trace_count == 1
    with torch.no_grad():
        m.bias.data = m.bias.data.clone()  # a new address
    static(x)
    assert static.trace_count == 2

    w = t(np.ones(3), rg=True)

    @jit.to_static
    def accumulate(x):
        (w * x).sum().backward()  # no clear_grad: the gradient accumulates
        return w.grad.clone()

    accumulate(x[0])  # traced with no gradient bound
    assert accumulate.trace_count == 1
    out = accumulate(x[0])  # the gradient exists now: another binding, retrace
    assert accumulate.trace_count == 2
    np.testing.assert_array_equal(out.numpy(), [2.0, 2.0, 2.0])
    accumulate(x[0])
    assert accumulate.trace_count == 2
    w.grad = None  # cleared outside: the first trace's binding again
    accumulate(x[0])
    assert accumulate.trace_count == 3


def test_warmup_leaves_every_tensor_and_generator_untouched():
    m, opt, step = _adam_pair()
    m2, opt2, eager = _adam_pair()
    gen = torch.Generator().manual_seed(9)

    def noisy(x):
        return step(TF.dropout(x, 0.5, training=True, generator=gen))

    static = jit.to_static(noisy)
    x = t(np.ones((4, 3)))
    eager(x)  # moments exist on both before the warmup
    step(x)
    static_state = _opt_state(m, opt)
    for a, b in zip(static_state, _opt_state(m2, opt2)):
        assert torch.equal(a, b)
    gen_state = gen.get_state()
    assert jit.warmup([(static, (x,))]) == 1
    assert static.trace_count == 1
    for a, b in zip(_opt_state(m, opt), static_state):
        assert torch.equal(a, b)
    assert torch.equal(gen.get_state(), gen_state)
    assert all(p.grad is None for p in m.parameters())
    # the first call after the warmup replays, and equals an eager step
    got = static(x)
    gen2 = torch.Generator().manual_seed(9)
    gen2.set_state(gen_state)
    want = eager(TF.dropout(x, 0.5, training=True, generator=gen2))
    assert torch.equal(got, want) and static.trace_count == 1
    for a, b in zip(_opt_state(m, opt), _opt_state(m2, opt2)):
        assert torch.equal(a, b)


def test_warmup_puts_back_accumulators_the_warm_run_created():
    m, opt, step = _adam_pair()
    m2, opt2, eager = _adam_pair()
    static = jit.to_static(step)
    x = t(np.ones((4, 3)))
    static.warmup(x)
    for p in m.parameters():
        assert torch.equal(opt.state[p]["moment1"], torch.zeros_like(p))
        assert opt.state[p]["beta1_pow"].item() == 1.0
    for _ in range(2):
        assert torch.equal(static(x), eager(x))
    assert static.trace_count == 1


def test_returned_loss_survives_the_next_call():
    m, opt, step = _adam_pair()
    static = jit.to_static(step)
    x = t(np.ones((4, 3)))
    losses = [static(x) for _ in range(3)]
    values = [v.item() for v in losses]
    assert len(set(values)) == 3
    static(x)
    assert [v.item() for v in losses] == values
    ring = torch.stack(losses)  # an in-flight ring keeps device losses
    assert torch.equal(ring, torch.tensor(values))


def test_nested_call_runs_inline():
    @jit.to_static
    def inner(x):
        return x * 3

    @jit.to_static
    def outer(x):
        return inner(x) + 1

    np.testing.assert_array_equal(outer(t(np.ones(2))).numpy(), [4.0, 4.0])
    assert outer.trace_count == 1 and inner.trace_count == 0


def test_unported_surface_raises_naming_the_roadmap_item(tmp_path):
    @jit.to_static
    def f(x):
        return x + 1

    for call in (lambda: f.clear_cache(persistent=True),
                 lambda: jit.warmup(str(tmp_path))):
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
            call()
    # no counterpart at all: a captured step is a CUDA graph, not compiler IR
    with pytest.raises(NotImplementedError, match="no counterpart"):
        f.lowered_text(t(np.ones(2)))
    f(t(np.ones(2)))
    assert f.clear_cache() == 0 and f._cache == {}
    assert "return x + 1" in f.code
    with pytest.raises(TypeError, match="StaticFunction"):
        jit.warmup([(lambda x: x, (1,))])


def _traces_metric():
    line = next(l for l in tmetrics.render().splitlines()
                if l.startswith("paddle_sanitizer_traces_total"))
    return float(line.split()[-1])


def test_metrics_count_to_static_traces_as_the_reference_sanitizer():
    """Each fresh signature is one `paddle_sanitizer_traces_total` in the
    port's /metrics, as each is one `note_trace` in the reference's
    sanitizer (with FLAGS_debug_sanitize on); replays add nothing."""
    saved = jcore.get_flags(["FLAGS_debug_sanitize"])
    jcore.set_flags({"FLAGS_debug_sanitize": True})
    jsan.reset()
    try:
        @paddle.jit.to_static
        def jf(x):
            return x * 2

        @jit.to_static
        def tf(x):
            return x * 2

        before = _traces_metric()
        for shape in ((2,), (2,), (3,), (2,)):
            jf(j(np.ones(shape)))
            tf(t(np.ones(shape)))
        assert _traces_metric() - before == jsan.counters()["traces"] == 2
    finally:
        jcore.set_flags(saved)
        jsan.reset()
