"""The port's training step against the JAX package's, on the CPU.

Loss, optimizer, gradient clipping and AMP O2 are each held against the
reference on the same numpy inputs, then a tiny Llama (weights crossing by
`load_reference_state`) takes five `model(ids, labels=ids)` -> backward ->
AdamW steps in both packages.

Tolerances, with their reasons:
- loss, clipping and one optimizer update in float32: atol/rtol 1e-6
  (elementwise float32 math in the same order on both sides);
- the tiny Llama in float32: each step's loss within 1e-5 relative and the
  parameters after five steps within 1e-4 (two layers of matmuls summed in
  a different order, carried through five updates);
- the tiny Llama in bf16 O2: each step's loss within 2e-3 relative; the
  float32 master weights within 1e-2 of the reference's entry by entry and
  within 2e-4 on the mean over each tensor.  bf16 rounds activations and
  gradients at points that differ between the two frameworks (XLA fuses
  elementwise chains and rounds once, PyTorch rounds after each op), so a
  gradient entry may differ by a few bf16 ulps, and its sign where it is
  near 0.  An Adam step moves a weight by about lr = 1e-3 whatever the
  gradient's size, so two runs whose gradient entry differs in sign part by
  up to ~2 lr a step: 1e-2 over five steps.  Measured on the CPU: losses
  within 5.5e-4 relative, masters within 3.8e-3 (mean 8.0e-5 at worst).
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu import to_tensor
from paddle_tpu.models import _utils as jutils
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import amp, optimizer
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models._utils import sequence_ce
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import RMSNorm
from paddle_tpu_torch.nn.clip import ClipGradByGlobalNorm
from paddle_tpu_torch.ops import flash_attention as pfa

TOL = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


class _Cfg:
    def __init__(self, vocab):
        self.config = type("C", (), {"vocab_size": vocab})()
        self.parallel_ce = None


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ignored", [0, 5, 24])
def test_sequence_ce_matches_reference(ignored):
    rng = np.random.default_rng(ignored)
    logits = (3 * rng.standard_normal((2, 12, 40))).astype(np.float32)
    labels = rng.integers(0, 40, size=(2, 12)).astype(np.int32)
    labels.reshape(-1)[rng.permutation(24)[:ignored]] = -100
    ref = jutils.sequence_ce(_Cfg(40), to_tensor(logits), to_tensor(labels)).numpy()
    got = sequence_ce(torch.from_numpy(logits), torch.from_numpy(labels))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    if ignored == 24:
        assert got.item() == 0.0  # all ignored: 0, not NaN


def test_sequence_ce_takes_bf16_logits_in_float32():
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 9, 16)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 16, (4, 9)).astype(np.int32))
    lb = logits.bfloat16()
    assert sequence_ce(lb, labels).item() == sequence_ce(lb.float(), labels).item()


# ---------------------------------------------------------------------------
# optimizer and clipping
# ---------------------------------------------------------------------------


def _ref_params(w0s, names, dtype="float32"):
    return [paddle.Parameter(np.asarray(w0, np.float32), dtype=dtype, name=name)
            for w0, name in zip(w0s, names)]


def _ref_steps(opt, ps, grads):
    for gs in grads:
        sum((p * to_tensor(g, dtype=p.dtype)).sum() for p, g in zip(ps, gs)).backward()
        opt.step()
        opt.clear_grad()


def _port_steps(opt, ps, grads):
    for gs in grads:
        for p, g in zip(ps, gs):
            p.grad = torch.from_numpy(g).to(p.dtype)
        opt.step()
        opt.clear_grad()
        assert all(p.grad is None for p in ps)


OPT_CASES = [
    ("Adam", {}),
    ("Adam", {"weight_decay": 0.1}),               # L2: wd * w added to the grad
    ("AdamW", {}),                                 # decoupled, default 0.01
    ("AdamW", {"weight_decay": 0.3,
               "apply_decay_param_fun": lambda n: "norm" not in n}),
]


@pytest.mark.parametrize("cls,kwargs", OPT_CASES)
def test_adam_updates_match_reference(cls, kwargs):
    """Three updates of two parameters, one of them left undecayed by
    `apply_decay_param_fun`, against the reference optimizer."""
    rng = np.random.default_rng(len(kwargs))
    w0s = [rng.standard_normal((5, 3)).astype(np.float32),
           rng.standard_normal(7).astype(np.float32)]
    grads = [[rng.standard_normal(w.shape).astype(np.float32) for w in w0s]
             for _ in range(3)]
    names = ["a.weight", "norm.weight"]
    rps = _ref_params(w0s, names)
    _ref_steps(getattr(paddle.optimizer, cls)(learning_rate=0.05, parameters=rps,
                                              **kwargs), rps, grads)
    tps = [torch.nn.Parameter(torch.from_numpy(w.copy())) for w in w0s]
    _port_steps(getattr(optimizer, cls)(learning_rate=0.05,
                                        parameters=list(zip(names, tps)), **kwargs),
                tps, grads)
    for r, t in zip(rps, tps):
        np.testing.assert_allclose(t.detach().numpy(), r.numpy(), **TOL)


def test_multi_precision_adamw_matches_reference_masters():
    """bf16 parameters with float32 masters: the masters follow the
    reference's and the parameters are the masters rounded to bf16."""
    rng = np.random.default_rng(9)
    w0s = [rng.standard_normal((6, 4)).astype(np.float32)]
    grads = [[rng.standard_normal((6, 4)).astype(np.float32)] for _ in range(3)]
    rps = _ref_params(w0s, ["w"], "bfloat16")
    ropt = paddle.optimizer.AdamW(learning_rate=0.05, parameters=rps,
                                  multi_precision=True)
    _ref_steps(ropt, rps, grads)
    tps = [torch.nn.Parameter(torch.from_numpy(w0s[0]).bfloat16())]
    topt = optimizer.AdamW(learning_rate=0.05, parameters=tps, multi_precision=True)
    _port_steps(topt, tps, grads)
    master = topt.state[tps[0]]["master_weight"]
    assert master.dtype == torch.float32
    np.testing.assert_allclose(master.numpy(),
                               ropt._master_weights["w"].numpy(), **TOL)
    assert torch.equal(tps[0].detach(), master.bfloat16())
    sd = topt.state_dict()
    assert set(sd["state"][0]) == {"master_weight", "moment1", "moment2",
                                   "beta1_pow", "beta2_pow"}


def test_unported_optimizer_arguments_raise():
    """`lr_ratio` and `amsgrad` raise: the reference takes them but never
    applies them.  (`lazy_mode` and schedulers run: tests/test_torch_lr.py,
    tests/test_torch_optimizers.py.)"""
    p = [torch.nn.Parameter(torch.zeros(3))]
    with pytest.raises(NotImplementedError, match="never applies it"):
        optimizer.AdamW(parameters=p, lr_ratio=lambda p: 1.0)
    with pytest.raises(NotImplementedError, match="never applies it"):
        optimizer.Adam(parameters=p, amsgrad=True)


def test_clip_grad_by_global_norm_matches_reference():
    rng = np.random.default_rng(4)
    gs = [(5 * rng.standard_normal(s)).astype(np.float32) for s in ((4, 3), (6,), (2, 2))]
    rps = _ref_params([np.zeros_like(g) for g in gs], ["a", "b", "c"])
    rps[1].need_clip = False
    ref = paddle.nn.ClipGradByGlobalNorm(1.5)(
        [(p, to_tensor(g)) for p, g in zip(rps, gs)])
    tps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    tps[1].need_clip = False
    got = ClipGradByGlobalNorm(1.5)([(p, torch.from_numpy(g)) for p, g in zip(tps, gs)])
    for (_, r), (_, t) in zip(ref, got):
        np.testing.assert_allclose(t.numpy(), r.numpy(), **TOL)
    np.testing.assert_array_equal(got[1][1].numpy(), gs[1])  # need_clip False
    small = ClipGradByGlobalNorm(1e3)([(tps[0], torch.from_numpy(gs[0]))])
    np.testing.assert_array_equal(small[0][1].numpy(), gs[0])  # under the norm


def test_optimizer_applies_grad_clip():
    w = torch.nn.Parameter(torch.tensor([1.0]))
    opt = optimizer.Adam(learning_rate=1.0, parameters=[w],
                         grad_clip=ClipGradByGlobalNorm(0.1))
    w.grad = torch.tensor([100.0])
    opt.step()
    np.testing.assert_allclose(opt.state[w]["moment1"].numpy(), [0.1 * 0.1], rtol=1e-6)


# ---------------------------------------------------------------------------
# AMP O2
# ---------------------------------------------------------------------------


def test_decorate_o2_keeps_norms_f32_and_gives_master_weights():
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    opt = optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model2, opt2 = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    assert model2 is model and opt2 is opt
    norms = {id(m.weight) for m in model.modules() if isinstance(m, RMSNorm)}
    assert len(norms) == 2 * model.config.num_hidden_layers + 1
    for name, p in model.named_parameters():
        if id(p) in norms:
            assert p.dtype == torch.float32 and "master_weight" not in opt.state[p]
        else:
            assert p.dtype == torch.bfloat16, name
            master = opt.state[p]["master_weight"]
            assert master.dtype == torch.float32
            # the reference makes the master from the cast parameter
            assert torch.equal(master, before[name].bfloat16().float())
    # O1 changes nothing (tests/test_torch_amp.py holds O1 and fp16 O2)
    assert amp.decorate(model, opt, level="O1") == (model, opt)
    with pytest.raises(ValueError, match="O1 or O2"):
        amp.decorate(model, level="O3")


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _ids(seed, b=2, s=16):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


def test_recompute_gives_the_same_grads():
    ids = torch.from_numpy(_ids(5))
    grads = []
    for rc in (False, True):
        m = tllama.LlamaForCausalLM(
            tllama.LlamaConfig.tiny(num_key_value_heads=2, use_recompute=rc),
            device="cpu", seed=3).train()
        loss, _ = m(ids, labels=ids)
        loss.backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


def test_forward_with_labels_returns_loss_and_logits():
    m = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    ids = torch.from_numpy(_ids(6))
    loss, logits = m(ids, labels=ids)
    torch.testing.assert_close(logits, m(ids))
    torch.testing.assert_close(loss, sequence_ce(logits, ids))


def _train_pair(o2, steps=5, lr=1e-3):
    """Five AdamW steps of the tiny Llama in both packages from the same
    weights.  Returns (ref losses, port losses, ref weights, port weights);
    the weights are the float32 masters under O2."""
    paddle.seed(21)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    load_reference_state(tm, state)
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters())
    topt = optimizer.AdamW(learning_rate=lr, parameters=tm.named_parameters())
    if o2:
        jm, jopt = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
        tm, topt = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    ids = _ids(8)
    jl, tl = [], []
    for _ in range(steps):
        loss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        tids = torch.from_numpy(ids)
        tloss, _ = tm(tids, labels=tids)
        tloss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(tloss.item())

    def weights_ref():
        out = {}
        for name, p in jm.named_parameters():
            mw = jopt._master_weights.get(jopt._key(p))
            out[name] = np.asarray((mw if mw is not None else p).numpy(), np.float32)
        return out

    def weights_port():
        out = {}
        for name, p in tm.named_parameters():
            w = topt.state[p].get("master_weight", p).detach().float().numpy()
            is_linear = name.endswith("proj.weight") or name == "lm_head.weight"
            out[name] = w.T if is_linear else w
        return out

    return np.array(jl), np.array(tl), weights_ref(), weights_port()


@contextlib.contextmanager
def _interpret():
    saved = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved


@pytest.mark.parametrize("interpret", [False, True])
def test_tiny_llama_f32_training_matches_reference(interpret):
    """With `interpret`, the reference runs its Pallas forward (K1) and
    backward (K3) kernels in interpret mode, so its own K3 is the oracle;
    without, its XLA path (`_blockwise_attention`, `_flash_backward`)."""
    ctx = _interpret() if interpret else contextlib.nullcontext()
    pfa.reset_launch_counts()
    with ctx:
        jl, tl, jw, tw = _train_pair(o2=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], atol=1e-4, rtol=1e-4,
                                   err_msg=name)
    assert pfa.launch_counts["flash_bwd"] == 0  # CPU tensors: the plain version


def test_tiny_llama_o2_bf16_training_matches_reference():
    jl, tl, jw, tw = _train_pair(o2=True)
    np.testing.assert_allclose(tl, jl, rtol=2e-3)
    assert tl[-1] < tl[0]
    for name in jw:
        np.testing.assert_allclose(tw[name], jw[name], atol=1e-2, err_msg=name)
        assert np.abs(tw[name] - jw[name]).mean() <= 2e-4, name
