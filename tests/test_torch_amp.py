"""The port's AMP -- `GradScaler`, `auto_cast` (O1) and `decorate` (O1, fp16
O2) -- against the JAX package's, on the CPU.

- `GradScaler`: the reference's eager cases (tests/test_optimizer.py:227-277
  and the eager run of tests/test_grad_scaler_compiled.py) side by side:
  scale and unscale, an explicit `unscale_` before `step`, the state
  machine's RuntimeErrors, the skip on an inf (Adam's moments and powers
  untouched), the scale's growth and halving, `state_dict`;
- `auto_cast`: the white ops (linear, matmul) come out in the AMP dtype,
  the black ops (softmax, log_softmax, layer_norm, cross_entropy) in
  float32; custom lists move an op (the reference keeps its fixed lists:
  these cases hold the port alone);
- `decorate`: O1 changes nothing; fp16 O2 casts the parameters the
  reference casts;
- a tiny Llama trained 3 steps under O1 bf16 + `GradScaler` +
  `LinearWarmup(CosineAnnealingDecay)` + `ClipGradByGlobalNorm` in both
  packages: losses within 2e-3 relative, weights within 1e-2, the
  tolerances of `test_tiny_llama_o2_bf16_training_matches_reference` and
  for the same reason (bf16 rounds at points that differ between XLA's
  fused chains and PyTorch's op by op; an Adam step moves a weight by
  about lr whatever its gradient); measured on the CPU: losses within
  2.9e-4 relative, weights within 5.8e-3 (mean 3.9e-5 at worst).  Then
  fp16 O2 + `GradScaler` under the same bounds: fp16 keeps three more
  mantissa bits than bf16 (measured: losses within 2.0e-5 relative,
  masters within 5.8e-3, mean 6.5e-6: a gradient entry near 0 may still
  change sign, and Adam moves it by ~lr either way).
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

import paddle_tpu as paddle
from paddle_tpu import to_tensor
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import LayerNorm, functional as tF
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


# ---------------------------------------------------------------------------
# GradScaler, beside the reference's
# ---------------------------------------------------------------------------


class _Pair:
    """One weight [1.0] with an optimizer and a scaler in each package."""

    def __init__(self, cls="SGD", lr=0.1, w0=1.0, **scaler_kw):
        self.rw = paddle.to_tensor(np.asarray([w0], np.float32))
        self.rw.stop_gradient = False
        self.ropt = getattr(paddle.optimizer, cls)(learning_rate=lr, parameters=[self.rw])
        self.rs = paddle.amp.GradScaler(**scaler_kw)
        self.tw = torch.nn.Parameter(torch.tensor([w0]))
        self.topt = getattr(optimizer, cls)(learning_rate=lr, parameters=[self.tw])
        self.ts = amp.GradScaler(**scaler_kw)

    def backward(self, x):
        self.rs.scale((self.rw * np.float32(x)).sum()).backward()
        self.ts.scale((self.tw * x).sum()).backward()

    def cycle(self, x):
        self.backward(x)
        for s, o in ((self.rs, self.ropt), (self.ts, self.topt)):
            s.step(o)
            s.update()
            o.clear_grad()

    def check(self, rtol=1e-6):
        np.testing.assert_allclose(self.tw.detach().numpy(), self.rw.numpy(), rtol=rtol)
        assert float(self.ts.get_loss_scaling()) == float(
            self.rs.get_loss_scaling().numpy())


def test_scaler_scales_and_unscales():
    p = _Pair(init_loss_scaling=128.0)
    p.backward(2.0)
    np.testing.assert_allclose(p.tw.grad.numpy(), [256.0])
    np.testing.assert_allclose(p.rw.grad.numpy(), [256.0])
    for s, o in ((p.rs, p.ropt), (p.ts, p.topt)):
        s.step(o)
        s.update()
    np.testing.assert_allclose(p.tw.detach().numpy(), [0.8], rtol=1e-5)
    p.check()


def test_scaler_explicit_unscale_then_step():
    p = _Pair(init_loss_scaling=1024.0)
    p.backward(3.0)
    p.rs.unscale_(p.ropt)
    p.ts.unscale_(p.topt)
    np.testing.assert_allclose(p.tw.grad.numpy(), [3.0])
    for s, o in ((p.rs, p.ropt), (p.ts, p.topt)):
        s.step(o)
        s.update()
    np.testing.assert_allclose(p.tw.detach().numpy(), [0.7], rtol=1e-5)
    p.check()


def test_scaler_state_machine_raises():
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = amp.GradScaler()
    scaler.scale((w * 2).sum()).backward()
    scaler.unscale_(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.unscale_(opt)
    scaler.step(opt)
    with pytest.raises(RuntimeError, match="already been called"):
        scaler.step(opt)
    with pytest.raises(RuntimeError, match="before step"):
        scaler.unscale_(opt)
    scaler.update()  # a new cycle
    scaler.scale((w * 2).sum()).backward()
    scaler.step(opt)
    scaler.update()


@pytest.mark.parametrize("cls", ["SGD", "Momentum", "Adam", "AdamW"])
def test_scaler_skips_on_inf_and_halves(cls):
    p = _Pair(cls, init_loss_scaling=4.0)
    p.cycle(np.inf)
    np.testing.assert_allclose(p.tw.detach().numpy(), [1.0])  # skipped
    assert float(p.ts.get_loss_scaling()) == 2.0
    assert p.ts.last_found_inf and p.rs.last_found_inf
    if cls.startswith("Adam"):  # the kernel's path made the state, skipped it
        st = p.topt.state[p.tw]
        assert st["moment1"].item() == 0.0 and st["beta1_pow"].item() == 1.0
    p.cycle(1.0)
    assert not p.ts.last_found_inf
    p.check()


def test_scaler_grows_after_good_steps():
    p = _Pair(lr=0.0, init_loss_scaling=8.0, incr_every_n_steps=2, incr_ratio=2.0)
    p.cycle(1.0)
    assert float(p.ts.get_loss_scaling()) == 8.0
    p.cycle(1.0)
    assert float(p.ts.get_loss_scaling()) == 16.0
    p.check()


@pytest.mark.parametrize("cls", ["SGD", "Adam"])
def test_scaler_eager_sequence_matches_reference(cls):
    """Eight cycles, three skipped.  Adam within 1e-5 relative: five float32
    Adam steps at lr 0.1, where XLA on the CPU contracts `b1 * m + (1 - b1)
    * g` into FMAs and PyTorch rounds each product (a few ulps a step)."""
    p = _Pair(cls, init_loss_scaling=4.0, incr_every_n_steps=3,
              decr_every_n_nan_or_inf=1)
    for x in (1.0, np.inf, 2.0, 1.0, 0.5, np.inf, np.inf, 3.0):
        p.cycle(x)
        p.check(rtol=1e-6 if cls == "SGD" else 1e-5)
    ref, got = p.rs.state_dict(), p.ts.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    fresh = amp.GradScaler()
    fresh.load_state_dict(got)
    assert fresh.state_dict()["scale"] == got["scale"]
    assert fresh.state_dict()["good_steps"] == got["good_steps"]


def test_disabled_and_static_scalers():
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = optimizer.SGD(learning_rate=0.1, parameters=[w])
    off = amp.GradScaler(enable=False)
    assert not off.is_enable()
    loss = (w * 2).sum()
    assert off.scale(loss) is loss
    loss.backward()
    off.step(opt)  # a disabled scaler steps as the optimizer would
    np.testing.assert_allclose(w.detach().numpy(), [0.8], rtol=1e-6)
    static = amp.GradScaler(init_loss_scaling=4.0, use_dynamic_loss_scaling=False)
    assert not static.is_use_dynamic_loss_scaling()
    opt.clear_grad()
    static.minimize(opt, static.scale((w * np.inf).sum()))
    assert float(static.get_loss_scaling()) == 4.0  # static: never moves
    np.testing.assert_allclose(w.detach().numpy(), [0.8], rtol=1e-6)


# ---------------------------------------------------------------------------
# auto_cast
# ---------------------------------------------------------------------------


def _x(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


@pytest.mark.parametrize("dtype, want", [("bfloat16", BF16), ("float16", F16)])
def test_auto_cast_o1_white_ops_run_in_the_amp_dtype(dtype, want):
    a, b = _x(3, 4), _x(4, 5, seed=1)
    lin = torch.nn.Linear(4, 6)
    with amp.auto_cast(level="O1", dtype=dtype):
        outs = [torch.matmul(a, b), a @ b, a.matmul(b), F.linear(a, _x(6, 4)), lin(a)]
        assert all(o.dtype == want for o in outs)
        # left alone: other ops promote as usual
        assert (outs[0] + outs[0].float()).dtype == F32 and F.gelu(a).dtype == F32
    assert torch.matmul(a, b).dtype == F32  # outside the context
    # the reference's O1 matmul gives the same values in the same dtype
    ref = paddle.matmul(to_tensor(a.numpy()), to_tensor(b.numpy()))
    with paddle.amp.auto_cast(level="O1", dtype=dtype):
        ref = paddle.matmul(to_tensor(a.numpy()), to_tensor(b.numpy()))
    assert ref.dtype == dtype
    np.testing.assert_allclose(outs[0].float().numpy(), ref.astype("float32").numpy(),
                               rtol=1e-2, atol=1e-2)


def test_auto_cast_o1_black_ops_run_in_float32():
    x = _x(2, 3, 8).bfloat16()
    labels = torch.tensor([1, 0])
    with amp.auto_cast(level="O1"):
        assert F.softmax(x, -1).dtype == F32
        assert torch.softmax(x, -1).dtype == F32 and x.softmax(-1).dtype == F32
        assert F.log_softmax(x, -1).dtype == F32 and x.log_softmax(-1).dtype == F32
        assert F.layer_norm(x, (8,)).dtype == F32
        assert tF.layer_norm(x, 8).dtype == F32  # the port's own, cast at its site
        assert LayerNorm(8)(x).dtype == F32
        assert F.cross_entropy(x[:, 0], labels).dtype == F32
    assert tF.layer_norm(x, 8).dtype == BF16  # outside: the stream's dtype
    import paddle_tpu.nn.functional as JF
    with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
        jx = to_tensor(x.float().numpy()).astype("bfloat16")
        assert JF.softmax(jx).dtype == "float32"
        assert JF.layer_norm(jx, 8).dtype == "float32"


def test_auto_cast_custom_lists_move_an_op():
    a, b = _x(3, 4), _x(4, 5, seed=1)
    with amp.auto_cast(custom_black_list={"matmul"}):
        assert torch.matmul(a, b).dtype == F32
        assert torch.matmul(a.bfloat16(), b.bfloat16()).dtype == F32
        assert F.linear(a, _x(6, 4)).dtype == BF16  # still white
    with amp.auto_cast(custom_white_list={"softmax"}):
        assert F.softmax(a, -1).dtype == BF16
    with pytest.raises(ValueError, match="both"):
        with amp.auto_cast(custom_white_list={"softmax"}, custom_black_list={"softmax"}):
            pass
    for kw in ({"level": "O0"}, {"enable": False}):
        with amp.auto_cast(**kw):
            assert torch.matmul(a, b).dtype == F32
    with pytest.raises(ValueError, match="O0/O1/O2"):
        with amp.auto_cast(level="O3"):
            pass


# ---------------------------------------------------------------------------
# decorate
# ---------------------------------------------------------------------------


def test_decorate_o1_returns_its_arguments_unchanged():
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    opt = optimizer.AdamW(parameters=model.parameters())
    before = {n: p.dtype for n, p in model.named_parameters()}
    m2, o2 = amp.decorate(model, opt, level="O1")
    assert m2 is model and o2 is opt and amp.decorate(model, level="O1") is model
    assert {n: p.dtype for n, p in model.named_parameters()} == before
    assert not any("master_weight" in s for s in opt.state.values())
    assert amp.is_float16_supported() and amp.is_bfloat16_supported()
    amp.debugging.enable_operator_stats_collection()
    amp.debugging.disable_operator_stats_collection()


def test_decorate_fp16_o2_casts_as_the_reference():
    paddle.seed(3)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    jopt = paddle.optimizer.AdamW(parameters=jm.parameters())
    paddle.amp.decorate(jm, jopt, level="O2", dtype="float16")
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    topt = optimizer.AdamW(parameters=tm.parameters())
    amp.decorate(tm, topt, level="O2", dtype="float16")
    ref = {n: p.dtype for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        assert str(p.dtype).removeprefix("torch.") == ref[name], name
        assert ("master_weight" in topt.state[p]) == (p.dtype == F16), name


# ---------------------------------------------------------------------------
# the tiny Llama: O1 bf16 and fp16 O2, each with GradScaler, schedule, clip
# ---------------------------------------------------------------------------


def _ids(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


def _sched(m):
    return m.LinearWarmup(m.CosineAnnealingDecay(3e-3, 10), 2, 1e-4, 3e-3)


def _train_pair(mode, steps=3):
    """`steps` steps of the tiny Llama in both packages from the same
    weights; mode "o1" (auto_cast bf16) or "o2_fp16" (decorate fp16).
    Returns (ref losses, port losses, ref weights, port weights, lrs)."""
    paddle.seed(23)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(tm, state)
    jm.train()
    tm.train()
    jsched, tsched = _sched(paddle.optimizer.lr), _sched(optimizer.lr)
    jopt = paddle.optimizer.AdamW(learning_rate=jsched, parameters=jm.parameters(),
                                  grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    topt = optimizer.AdamW(learning_rate=tsched, parameters=tm.named_parameters(),
                           grad_clip=ClipGradByGlobalNorm(1.0))
    if mode == "o2_fp16":
        jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="float16")
        tm, topt = amp.decorate(tm, topt, level="O2", dtype="float16")
    jscaler = paddle.amp.GradScaler(init_loss_scaling=2.0 ** 10)
    tscaler = amp.GradScaler(init_loss_scaling=2.0 ** 10)
    jl, tl, lrs = [], [], []
    for step in range(steps):
        ids = _ids(step)
        if mode == "o1":
            with paddle.amp.auto_cast(level="O1", dtype="bfloat16"):
                loss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
        else:
            loss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
        jscaler.scale(loss).backward()
        jscaler.step(jopt)
        jscaler.update()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        tids = torch.from_numpy(ids)
        if mode == "o1":
            with amp.auto_cast(level="O1", dtype="bfloat16"):
                tloss, _ = tm(tids, labels=tids)
        else:
            tloss, _ = tm(tids, labels=tids)
        lrs.append((jopt.get_lr(), topt.get_lr()))
        tscaler.scale(tloss).backward()
        tscaler.step(topt)
        tscaler.update()
        topt.clear_grad()
        tl.append(tloss.item())
        jsched.step()
        tsched.step()
    assert float(tscaler.get_loss_scaling()) == float(jscaler.get_loss_scaling().numpy())

    jw = {}
    for name, p in jm.named_parameters():
        mw = jopt._master_weights.get(jopt._key(p))
        jw[name] = np.asarray((mw if mw is not None else p).astype("float32").numpy())
    lin = {n for n, m in tm.named_modules() if isinstance(m, torch.nn.Linear)}
    tw = {}
    for name, p in tm.named_parameters():
        w = topt.state[p].get("master_weight", p).detach().float().numpy()
        tw[name] = w.T if name.rsplit(".", 1)[0] in lin else w
    return np.array(jl), np.array(tl), jw, tw, lrs


@pytest.mark.parametrize("mode", ["o1", "o2_fp16"])
def test_tiny_llama_amp_training_matches_reference(mode):
    jl, tl, jw, tw, lrs = _train_pair(mode)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert all(np.isfinite(tl)) and tl[-1] < tl[0]
    assert [a for a, _ in lrs] == [b for _, b in lrs] and len(set(lrs)) == 3
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], atol=1e-2, err_msg=name)


def test_fp16_attention_runs_plain_on_the_cpu_and_is_refused_on_the_card():
    """float16 runs the plain versions on the CPU (the fp16 O2 Llama above
    runs through them) and, since K1-K6 have float16 instantiations, is
    accepted on the card: a float16 CUDA operand gets dtype code 2 and the
    path a bfloat16 one of its shape gets, where it was refused before (the
    test keeps its name).  Other dtypes still raise TypeError."""
    import types

    from paddle_tpu_torch.ops import flash_attention as pfa

    q = _x(1, 8, 2, 16).half()
    out, lse = pfa.flash_forward(q, q, q, causal=True)
    ref, _ = pfa.flash_forward(q.float(), q.float(), q.float(), causal=True)
    assert out.dtype == F16
    np.testing.assert_allclose(out.float().numpy(), ref.numpy(), atol=2e-3)
    card = types.SimpleNamespace(dtype=F16, device=torch.device("cuda"))
    assert pfa._dtype_code(card, "flash_fwd") == 2
    assert not hasattr(pfa, "FP16_ITEM")
    for rows, d in ((128, 128), (16, 64), (200, 96)):
        assert (pfa.flash_path(rows, d, F16)
                == pfa.flash_path(rows, d, torch.bfloat16))
    with pytest.raises(TypeError, match="dtype"):
        pfa._dtype_code(torch.zeros(1, dtype=torch.int32), "flash_fwd")
