"""Long-context Llama training through the model config, against the JAX
package on the CPU.

A tiny Llama with `context_parallel_degree=2` (ring attention) or
`sep_degree=2` (Ulysses) on a `sep=2` mesh in both packages, the weights
crossing by `load_reference_state`: the loss and every parameter's
gradient of one `model(ids, labels=ids)` -> backward.  The reference runs
on the conftest's 8 CPU devices; `_FORCE_INTERPRET` puts its ring on the
zig-zag kernel forms at S = 512, and at S = 128 its shards of 64 rows take
the plain ring.  The port's two ranks run in one process.  The port's
gathered form is held against the reference model's rotating form (the
same attention): the reference's gathered form cannot run under its eager
model, whose per-op VJP sees the q block starts that `_gathered_zigzag_
cp_local` builds outside its custom_vjp (ring_attention.py:408) as a
leaked tracer; `test_torch_ring_forms.py` holds that form alone.  The
mesh, the flag, the budget and paddle's generator are restored at
teardown.

Also: GQA kv heads are repeated before the ring (as the reference's
`_dispatch_attention` does), heads that do not divide the axis warn and
fall back to flash attention, unported mesh axes raise, and the ring's
output gradient is exact in bf16 at the cast where K3 reads it.

Tolerances (float32): loss within 1e-5 relative; gradients within 2e-4
absolute and 1e-3 relative (two layers of matmuls summed in another order,
then the ring's hops).
"""

import warnings

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.ops.flash_attention as fa
from paddle_tpu import to_tensor
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.distributed.fleet.meta_parallel import ring_attention as ra
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import ring_attention as tra
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

GRAD_TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture
def sep2():
    saved = (fa._FORCE_INTERPRET, pmesh.get_mesh(), tmesh.get_mesh(),
             ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES)
    pmesh.build_mesh(sep=2)
    tmesh.build_mesh(sep=2, device="cpu")
    tra.reset_form_counts()
    try:
        yield
    finally:
        fa._FORCE_INTERPRET = saved[0]
        pmesh.set_mesh(saved[1])
        tmesh.set_mesh(saved[2])
        ra._GATHERED_KV_MAX_BYTES, tra._GATHERED_KV_MAX_BYTES = saved[3:]


def _cfg(mod, **kw):
    return mod.LlamaConfig.tiny(max_position_embeddings=512, **kw)


def _grads(cfg_kw, S, seed=0):
    """Loss and {name: gradient} of one step in each package, on shared
    weights and ids; port Linear gradients transposed to the reference's
    [in, out]."""
    paddle.seed(seed)
    jm = jllama.LlamaForCausalLM(_cfg(jllama, **cfg_kw))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(_cfg(tllama, **cfg_kw), device="cpu")
    load_reference_state(tm, state)
    jm.train()
    tm.train()
    ids = np.random.default_rng(seed).integers(1, 256, (1, S)).astype(np.int32)
    jloss, _ = jm(to_tensor(ids), labels=to_tensor(ids))
    jloss.backward()
    tids = torch.from_numpy(ids)
    tloss, _ = tm(tids, labels=tids)
    tloss.backward()
    jg = {n: np.asarray(p.grad.numpy()) for n, p in jm.named_parameters()}
    tg = {}
    for n, p in tm.named_parameters():
        g = p.grad.numpy()
        tg[n] = g.T if n.endswith("proj.weight") or n == "lm_head.weight" else g
    return float(jloss.numpy()), tloss.item(), jg, tg


def _check(jl, tl, jg, tg):
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert set(jg) == set(tg)
    for name in jg:
        np.testing.assert_allclose(tg[name], jg[name], err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("form, S, interpret, port_budget", [
    ("gathered", 512, True, None),
    ("rotating", 512, True, 0),
    ("plain", 128, False, None),
])
def test_context_parallel_llama_matches_reference(sep2, form, S, interpret,
                                                  port_budget):
    fa._FORCE_INTERPRET = interpret
    ra._GATHERED_KV_MAX_BYTES = 0  # the reference model's rotating form
    if port_budget is not None:
        tra._GATHERED_KV_MAX_BYTES = port_budget
    _check(*_grads(dict(context_parallel_degree=2, num_key_value_heads=2), S))
    # one ring call per layer, in the form the shape picks
    assert tra.form_counts == dict(dict.fromkeys(tra.FORMS, 0), **{form: 2})


def test_sep_degree_llama_matches_reference(sep2):
    _check(*_grads(dict(sep_degree=2), 128, seed=1))
    assert tra.form_counts["ulysses"] == 2


def test_heads_not_dividing_the_axis_warn_and_take_flash():
    saved = tmesh.get_mesh()
    try:
        tmesh.build_mesh(sep=3, device="cpu")
        model = tllama.LlamaForCausalLM(_cfg(tllama, sep_degree=3), device="cpu")
        ids = torch.randint(1, 256, (1, 48), generator=torch.Generator().manual_seed(0))
        with pytest.warns(UserWarning, match="not divisible"):
            out = model(ids)
        tmesh.set_mesh(None)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            torch.testing.assert_close(model(ids), out)
    finally:
        tmesh.set_mesh(saved)


@pytest.mark.parametrize("axis", ["dp", "mp", "pp", "sharding", "ep", "cp"])
def test_unported_mesh_axes_raise(axis):
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        tmesh.build_mesh(**{axis: 2, "sep": 2}, device="cpu")


def test_ring_output_gradient_is_exact_in_bf16():
    """The ring's core returns float32 and reaches the caller through a cast
    to the input dtype (the reference's :199, :372), so the cotangent the
    core's backward gets holds bf16 values: K3 takes it in bf16 and rounds
    nothing."""
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn(1, 256, 2, 16, generator=gen).bfloat16().requires_grad_()
               for _ in range(3))
    seen = []
    out32 = tra._RingHops.apply(q, k, v, 2, False, 0.25)
    out32.register_hook(lambda g: seen.append(g))
    out = out32.to(q.dtype)
    # a cotangent that is not bf16-exact before the cast
    (out.float() * torch.randn(out.shape, generator=gen)).sum().backward()
    (g,) = seen
    assert g.dtype == torch.float32
    assert torch.equal(g.bfloat16().float(), g)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
