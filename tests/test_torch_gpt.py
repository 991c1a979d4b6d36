"""The port's GPT (`paddle_tpu_torch.models.gpt`) against the JAX package's
`paddle_tpu.models.gpt`, on the CPU.

A tiny GPT, dense or with an MoE layer on layer 1, is built by the JAX
package after `paddle.seed`; its state crosses into the port through
`load_reference_state`.  Tolerances, with their reasons:

- logits, loss (the aux term included) and gradients in float32: 1e-5 on
  logits and loss, 1e-4 on gradients (two layers of float32 products
  summed in another order by each framework);
- recompute against the plain forward in the port: the same operations on
  the same inputs, so the loss is equal and gradients within 1e-6;
- three AdamW steps (lr 1e-3): losses within 1e-5 relative, weights within
  1e-4, except where the first step's rule applies (ROADMAP.md, parity
  hazards): Adam moves a weight by about lr * sign(g) whatever g's size,
  so an entry whose gradient sits at rounding level may part by 2 lr a
  step; such entries are held to 3 steps' worth, 6e-3.  The k third of
  the fused qkv bias is all such entries (the softmax cancels it).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models import gpt as jgpt
from paddle_tpu_torch import amp, jit, optimizer
from paddle_tpu_torch.incubate.moe import MoELayer
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.nn import LayerNorm
from paddle_tpu_torch.ops import flash_attention as pfa


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX models draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(1, 250, size=(b, s)).astype(np.int32)


def _pair(moe, seed=3, **cfg):
    paddle.seed(seed)
    kw = dict(moe_num_experts=4 if moe else 0, **cfg)
    jm = jgpt.GPTForCausalLM(jgpt.GPTConfig.tiny(**kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(**kw), device="cpu")
    return jm, load_reference_state(tm, state)


def _is_linear_weight(name):
    return name.endswith(("proj.weight", "fc1.weight", "fc2.weight", "wg.weight")) \
        or name == "lm_head.weight"


def _port_array(name, t):
    a = t.detach().float().numpy()
    return a.T if _is_linear_weight(name) else a


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_tiny_gpt_logits_loss_and_gradients_match_reference(moe):
    jm, tm = _pair(moe)
    jm.train()
    tm.train()
    ids = _ids(2, 24, seed=1)
    jl, jlog = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
    jl.backward()
    pfa.reset_launch_counts()
    tl, tlog = tm(torch.from_numpy(ids), labels=torch.from_numpy(ids))
    tl.backward()
    np.testing.assert_allclose(tlog.detach().numpy(), jlog.numpy(), atol=1e-5)
    np.testing.assert_allclose(tl.item(), float(jl.numpy()), atol=1e-5)
    if moe:
        (m,) = tm.moe_layers()
        assert isinstance(m, MoELayer) and tm.gpt.h[1].mlp is m
        jaux = float(jm.gpt.h[1].mlp.aux_loss.numpy())
        np.testing.assert_allclose(m.aux_loss.item(), jaux, atol=1e-6)
        assert m.aux_loss.item() > 0
    jg = {n: p.grad.numpy() for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(_port_array(name, p.grad), jg[name], atol=1e-4,
                                   err_msg=name)
    # CPU tensors: the plain versions, never a kernel
    assert pfa.launch_counts["flash_fwd"] == pfa.launch_counts["flash_bwd"] == 0


def test_state_names_match_reference_and_13b_widths():
    jm, tm = _pair(True)
    assert set(dict(tm.named_parameters())) == set(jm.state_dict())
    cfg = tgpt.GPTConfig.gpt3_13b()
    assert (cfg.vocab_size, cfg.hidden_size, cfg.num_hidden_layers,
            cfg.num_attention_heads, cfg.intermediate_size,
            cfg.max_position_embeddings, cfg.head_dim) == (
        50304, 5120, 40, 40, 20480, 2048, 128)
    assert cfg == tgpt.GPTConfig(**vars(jgpt.GPTConfig.gpt3_13b()))


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_recompute_matches_plain(moe):
    """The reference's `test_recompute_matches` for GPT: the same weights
    with and without `use_recompute` give one loss and the same
    gradients, the MoE layer's aux loss included."""
    _, plain = _pair(moe, seed=5)
    _, rc = _pair(moe, seed=5, use_recompute=True)
    ids = torch.from_numpy(_ids(2, 16, seed=2))
    out = []
    for m in (plain, rc):
        m.train()
        loss, _ = m(ids, labels=ids)
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    assert out[0][0] == out[1][0]
    for name, g in out[0][1].items():
        torch.testing.assert_close(out[1][1][name], g, atol=1e-6, rtol=0, msg=name)


def test_recompute_repeats_dropout_masks():
    """With dropout on, the recompute draws the masks of the forward: the
    model's explicit dropout generator is put back for it."""
    kw = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    _, plain = _pair(True, seed=6, **kw)
    _, rc = _pair(True, seed=6, use_recompute=True, **kw)
    ids = torch.from_numpy(_ids(2, 16, seed=3))
    grads = []
    for m in (plain, rc):
        m.train()
        loss, _ = m(ids, labels=ids)
        loss.backward()
        grads.append(m.gpt.h[0].attn.qkv_proj.weight.grad.clone())
    torch.testing.assert_close(grads[1], grads[0], atol=1e-6, rtol=0)
    # the generator ends where the plain run left it
    assert torch.equal(plain.dropout_generator.get_state(),
                       rc.dropout_generator.get_state())


def test_o2_parameter_dtypes_match_reference():
    """O2 casts every float32 parameter but the LayerNorms' -- the fused
    qkv, the MoE gate, the 3-D expert stacks and their biases included --
    as the reference's `decorate` does."""
    jm, tm = _pair(True)
    jopt = paddle.optimizer.AdamW(learning_rate=1e-3, parameters=jm.parameters())
    topt = optimizer.AdamW(learning_rate=1e-3, parameters=tm.named_parameters())
    jm, _ = paddle.amp.decorate(jm, jopt, level="O2", dtype="bfloat16")
    tm, _ = amp.decorate(tm, topt, level="O2", dtype="bfloat16")
    ref = {n: str(p.dtype) for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        assert str(p.dtype).replace("torch.", "") == ref[name], name
    norms = {f"{n}.{k}" for n, m in tm.named_modules() if isinstance(m, LayerNorm)
             for k in ("weight", "bias")}
    assert {n for n, p in tm.named_parameters() if p.dtype == torch.float32} == norms
    assert tm.gpt.h[1].mlp.experts.b1.dtype == torch.bfloat16


def _adamw_steps(jm, tm, steps=3, lr=1e-3):
    jm.train()
    tm.train()
    jopt = paddle.optimizer.AdamW(learning_rate=lr, parameters=jm.parameters())
    topt = optimizer.AdamW(learning_rate=lr, parameters=tm.named_parameters())
    ids = _ids(2, 16, seed=8)
    jl, tl = [], []
    for _ in range(steps):
        loss, _ = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(ids))
        loss.backward()
        jopt.step()
        jopt.clear_grad()
        jl.append(float(loss.numpy()))
        tids = torch.from_numpy(ids)
        loss, _ = tm(tids, labels=tids)
        loss.backward()
        topt.step()
        topt.clear_grad()
        tl.append(loss.item())
    return np.array(jl), np.array(tl)


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_three_adamw_steps_match_reference(moe):
    jm, tm = _pair(moe, seed=9)
    jl, tl = _adamw_steps(jm, tm)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    jw = {n: p.numpy() for n, p in jm.named_parameters()}
    for name, p in tm.named_parameters():
        got, ref = _port_array(name, p), jw[name]
        far = np.abs(got - ref) > 1e-4
        if name.endswith("qkv_proj.bias"):
            # k's bias adds q . b_k to every key's score alike, which the
            # softmax cancels: its gradient is rounding noise throughout
            h = got.shape[0] // 3
            far[h:2 * h] = False
        # the first-step rule: only entries Adam moved by ~lr * sign(g) on
        # a rounding-level gradient may part, and by at most 2 lr a step
        assert far.mean() < 0.01, name
        np.testing.assert_allclose(got, ref, atol=6e-3, err_msg=name)


def test_moe_gpt_o2_step_under_to_static_equals_eager():
    """The MoE GPT's bf16 O2 training step captured once and held to an
    eager twin bit for bit: losses, the MoE layer's aux loss and dropped
    fraction (tensors the step creates and returns)."""

    def build():
        m = tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(moe_num_experts=4),
                                device="cpu", seed=4).train()
        opt = optimizer.AdamW(learning_rate=1e-3, parameters=m.named_parameters())
        m, opt = amp.decorate(m, opt, level="O2", dtype="bfloat16")
        (moe,) = m.moe_layers()

        def step(ids):
            loss, _ = m(ids, labels=ids)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss, moe.aux_loss, moe.drop_stats["dropped_fraction"]

        return m, step

    ids = torch.from_numpy(_ids(2, 16, seed=5))
    me, eager = build()
    ms, step = build()
    static = jit.to_static(step)
    losses = []
    for _ in range(3):
        want, got = eager(ids), static(ids)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        losses.append(got[0].item())
    assert static.trace_count == 1 and losses[-1] < losses[0]
    for (name, a), (_, b) in zip(ms.named_parameters(), me.named_parameters()):
        assert torch.equal(a, b), name


def test_multi_card_classes_raise():
    with pytest.raises(NotImplementedError, match="item 17"):
        tgpt.GPTForCausalLM(tgpt.GPTConfig.tiny(tensor_parallel_degree=2),
                            device="cpu")
    for cls in (tgpt.GPTStackedDecoder, tgpt.GPTForCausalLMSpmdPipe,
                tgpt.GPTForCausalLMPipe):
        with pytest.raises(NotImplementedError, match="item 17"):
            cls(tgpt.GPTConfig.tiny())
    from paddle_tpu_torch import models

    assert models.GPTForPretraining is models.GPTForCausalLM
