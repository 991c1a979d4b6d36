"""The port's mixture of experts (`paddle_tpu_torch.incubate.moe`) against
the JAX package's `paddle_tpu.incubate.moe`, on the CPU.

The routing functions take the same numpy logits in both packages.  The
dispatch tensor, the slots used and the drop count are integers in float
form and must be identical; the combine weights and the aux loss come
from a float32 softmax, whose sums the two frameworks order differently,
so they hold to 1e-6.  `MoELayer`s carry the reference's weights across
through `load_reference_state`; outputs hold to 1e-5 and gradients to
1e-4 (float32 products over d and the hidden width, summed in another
order).  The reference's `TestMoE` cases run again on the port, and
`bench_moe`'s step (bench.py:2242-2253) runs under `jit.to_static` against
eager.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import paddle_tpu as paddle
from paddle_tpu.incubate import moe as jmoe
from paddle_tpu_torch import incubate, jit, optimizer
from paddle_tpu_torch.distributed import mesh as pmesh
from paddle_tpu_torch.incubate import moe as pmoe
from paddle_tpu_torch.models.convert import load_reference_state

TIGHT = dict(atol=1e-6, rtol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX layers draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


def _logits(t, e, seed):
    return np.random.default_rng(seed).standard_normal((t, e)).astype(np.float32)


def _route_both(lg, k, cap, valid=None, expert_choice=False):
    jv = None if valid is None else jnp.asarray(valid)
    tv = None if valid is None else torch.from_numpy(valid)
    ref = jmoe.route_tokens(jnp.asarray(lg), k, cap, expert_choice, valid=jv)
    got = pmoe.route_tokens(torch.from_numpy(lg), k, cap, expert_choice, valid=tv)
    return ref, got


def _assert_routes_equal(ref, got):
    (jd, jc, ja, (jdr, ju)), (pd, pc, pa, (pdr, pu)) = ref, got
    assert pd.dtype == pc.dtype == pa.dtype == pdr.dtype == torch.float32
    assert pu.dtype == torch.int32
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    assert pdr.item() == float(jdr)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), **TIGHT)
    np.testing.assert_allclose(pa.item(), float(ja), **TIGHT)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cap,dropping", [(3, True), (40, False)])
def test_gate_dispatch_matches_reference(k, cap, dropping):
    """Tight capacity drops assignments (their rows stay zero), ample
    capacity drops none."""
    lg = _logits(37, 8, seed=10 * k + cap)
    ref, got = _route_both(lg, k, cap)
    _assert_routes_equal(ref, got)
    assert (got[3][0].item() > 0) == dropping


def test_gate_dispatch_with_valid_rows_matches_reference():
    lg = _logits(21, 4, seed=3)
    valid = np.arange(21) < 18  # three pad rows, as the EP tail pads
    ref, got = _route_both(lg, 2, 6, valid=valid)
    _assert_routes_equal(ref, got)
    assert got[0][18:].abs().sum().item() == 0  # pad rows claim no slot


@pytest.mark.parametrize("k", [1, 2])
def test_tied_logits_pick_the_reference_experts(k):
    """Ties break toward the lower expert index, as `lax.top_k` breaks
    them: float32 logits with exact ties, then bf16 logits (the O2 gate's)
    on a coarse grid where most rows hold equal values."""
    lg = np.zeros((12, 4), np.float32)
    lg[:, 1] = lg[:, 3] = 1.0
    lg[::3, 2] = 1.0
    lg[5] = 0.0  # every expert tied
    ref, got = _route_both(lg, k, 12)
    _assert_routes_equal(ref, got)
    first = got[0].sum(-1)  # [T, E]: which experts each token reached
    assert first[0].tolist() == ([0, 1, 0, 0] if k == 1 else [0, 1, 1, 0])
    assert first[5].tolist() == ([1, 0, 0, 0] if k == 1 else [1, 1, 0, 0])
    coarse = np.round(_logits(64, 8, seed=4) * 2) / 2
    bf = torch.from_numpy(coarse).bfloat16()
    jd, _, _, (jdr, ju) = jmoe.gate_dispatch_tensors(
        jnp.asarray(bf.float().numpy()).astype(jnp.bfloat16), k, 20)
    pd, _, _, (pdr, pu) = pmoe.gate_dispatch_tensors(bf, k, 20)
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(pu.numpy(), np.asarray(ju))
    assert pdr.item() == float(jdr)


def test_dropped_assignment_gets_a_zero_row():
    """Every token's first choice is expert 0 and capacity is 2: tokens
    from the third on get a slot past capacity, whose one-hot row is zero
    (torch's one_hot would raise)."""
    lg = np.tile(np.array([[3.0, 0.0, 0.0, 0.0]], np.float32), (6, 1))
    ref, got = _route_both(lg, 1, 2)
    _assert_routes_equal(ref, got)
    disp = got[0]
    assert disp[:2, 0].sum().item() == 2 and disp[2:].abs().sum().item() == 0
    assert got[3][0].item() == 4 and got[3][1].tolist() == [2, 0, 0, 0]


@pytest.mark.parametrize("cap,valid", [(5, False), (30, False), (6, True)])
def test_expert_choice_matches_reference(cap, valid):
    """Capacity 30 over 12 tokens clamps to 12; aux is 0 and every expert
    uses its whole capacity."""
    lg = _logits(12, 4, seed=cap)
    v = (np.arange(12) < 10) if valid else None
    ref, got = _route_both(lg, 2, cap, valid=v, expert_choice=True)
    _assert_routes_equal(ref, got)
    assert got[2].item() == 0.0
    assert got[3][1].tolist() == [min(cap, 12)] * 4
    assert got[0].shape == (12, 4, min(cap, 12))


def _layer_pair(seed, **kw):
    paddle.seed(seed)
    jl = jmoe.MoELayer(**kw)
    state = {k: np.asarray(v.numpy()) for k, v in jl.state_dict().items()}
    tl = pmoe.MoELayer(**kw)
    return jl, load_reference_state(tl, state)


@pytest.mark.parametrize("gate", ["gshard", "switch", "expert_choice"])
@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_moe_layer_forward_and_gradients_match_reference(gate, activation):
    kw = dict(d_model=16, d_hidden=32, num_experts=4, top_k=2,
              capacity_factor=1.0, gate=gate, activation=activation)
    jl, tl = _layer_pair(7, **kw)
    x = np.random.default_rng(1).standard_normal((2, 12, 16)).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jout = jl(jx)
    jloss = (jout ** 2).mean() + 0.01 * jl.aux_loss
    jloss.backward()
    tx = torch.from_numpy(x).requires_grad_()
    tout = tl(tx)
    tloss = (tout ** 2).mean() + 0.01 * tl.aux_loss
    tloss.backward()
    np.testing.assert_allclose(tout.detach().numpy(), jout.numpy(), atol=1e-5)
    np.testing.assert_allclose(tloss.item(), float(jloss.numpy()), atol=1e-5)
    np.testing.assert_allclose(tl.aux_loss.item(), float(jl.aux_loss.numpy()), **TIGHT)
    for key in ("dropped_tokens", "expert_used"):
        np.testing.assert_array_equal(tl.drop_stats[key].detach().numpy(),
                                      np.asarray(jl.drop_stats[key].numpy()))
    # XLA divides by T * k as a product with its reciprocal: one ulp apart
    np.testing.assert_allclose(tl.drop_stats["dropped_fraction"].item(),
                               float(jl.drop_stats["dropped_fraction"].numpy()),
                               **TIGHT)
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), atol=1e-4)
    jg = dict(jl.named_parameters())
    for name, p in tl.named_parameters():
        ref = jg[name].grad.numpy()
        got = p.grad.numpy().T if name == "gate.wg.weight" else p.grad.numpy()
        np.testing.assert_allclose(got, ref, atol=1e-4, err_msg=name)


def test_moe_layer_bf16_casts_like_the_reference():
    """Under bf16 the dispatch runs in the activations' dtype and the
    combine in the experts' output dtype: the output is bf16, aux float32."""
    tl = pmoe.MoELayer(16, 32, num_experts=4).to(torch.bfloat16)
    out = tl(torch.randn(2, 8, 16, dtype=torch.bfloat16))
    assert out.dtype == torch.bfloat16 and tl.aux_loss.dtype == torch.float32


# -- the reference's TestMoE (tests/test_longcontext_moe.py:80-150) ---------


def _t(*shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


def test_reference_forward_shapes_and_aux():
    torch.manual_seed(0)
    moe = pmoe.MoELayer(d_model=16, d_hidden=32, num_experts=4, top_k=2)
    out = moe(_t(2, 8, 16).requires_grad_())
    assert out.shape == (2, 8, 16)
    assert moe.aux_loss is not None and moe.aux_loss.item() > 0


def test_reference_switch_top1_routes_all_capacity():
    torch.manual_seed(0)
    moe = pmoe.MoELayer(d_model=8, d_hidden=16, num_experts=2, top_k=1,
                        gate="switch", capacity_factor=2.0)
    out = moe(_t(1, 16, 8))
    assert out.abs().sum().item() > 0
    assert moe.drop_stats["dropped_tokens"].item() == 0


def test_reference_trains():
    torch.manual_seed(0)
    moe = pmoe.MoELayer(d_model=16, d_hidden=32, num_experts=4)
    opt = optimizer.Adam(learning_rate=1e-2, parameters=moe.parameters())
    x, y = _t(4, 8, 16, seed=1), _t(4, 8, 16, seed=2)
    losses = []
    for _ in range(20):
        loss = ((moe(x) - y) ** 2).mean() + 0.01 * moe.aux_loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


def test_reference_drop_stats_surface():
    torch.manual_seed(1)
    moe = pmoe.MoELayer(d_model=8, d_hidden=16, num_experts=2, top_k=2,
                        capacity_factor=0.25)
    x = _t(2, 16, 8)
    moe(x)
    st = moe.drop_stats
    assert st["dropped_tokens"].item() > 0
    assert 0 < st["dropped_fraction"].item() <= 1
    assert st["expert_used"].shape == (2,)
    moe2 = pmoe.MoELayer(d_model=8, d_hidden=16, num_experts=2, top_k=2,
                         capacity_factor=8.0)
    moe2(x)
    assert moe2.drop_stats["dropped_tokens"].item() == 0


def test_reference_expert_choice_gate():
    torch.manual_seed(2)
    moe = pmoe.MoELayer(d_model=16, d_hidden=32, num_experts=4,
                        gate="expert_choice", capacity_factor=2.0)
    x, y = _t(2, 16, 16, seed=3), _t(2, 16, 16, seed=4)
    out = moe(x)
    assert out.shape == (2, 16, 16)
    assert moe.aux_loss.item() == 0.0
    used = moe.drop_stats["expert_used"]
    assert (used == used[0]).all()
    opt = optimizer.Adam(learning_rate=1e-2, parameters=moe.parameters())
    losses = []
    for _ in range(10):
        loss = ((moe(x) - y) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.item())
    assert losses[-1] < losses[0]


def test_reference_expert_choice_capacity_clamps_to_tokens():
    torch.manual_seed(5)
    moe = pmoe.MoELayer(d_model=8, d_hidden=16, num_experts=2, top_k=2,
                        gate="expert_choice", capacity_factor=2.0)
    assert moe(_t(2, 16, 8)).shape == (2, 16, 8)


# -- bench_moe's step under to_static ----------------------------------------


def _bench_moe(seed):
    """bench_moe's step as bench.py:2242-2253 writes it, at the leg's CPU
    geometry (d 16, hidden 32, 4 experts, top-2, batch 2 x 8)."""
    torch.manual_seed(seed)
    moe = pmoe.MoELayer(d_model=16, d_hidden=32, num_experts=4, top_k=2)
    opt = optimizer.AdamW(learning_rate=1e-4, parameters=moe.named_parameters())

    def step(x):
        out = moe(x)
        loss = (out.float() ** 2).mean() + 0.01 * moe.aux_loss
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss, moe.aux_loss, moe.drop_stats["dropped_fraction"]

    return moe, step


def test_bench_moe_step_under_to_static_equals_eager():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 8, 16).astype(np.float32))
    moe_e, eager = _bench_moe(0)
    moe_s, step = _bench_moe(0)
    static = jit.to_static(step)
    for _ in range(3):
        want = eager(x)
        got = static(x)
        for a, b in zip(got, want):
            assert torch.equal(a.detach(), b.detach())
    assert static.trace_count == 1
    assert got[1].item() > 0 and 0 <= got[2].item() <= 1
    for (name, a), (_, b) in zip(moe_s.named_parameters(), moe_e.named_parameters()):
        assert torch.equal(a.detach(), b.detach()), name


# -- what stays with item 17 -------------------------------------------------


def test_expert_parallel_axis_raises():
    with pytest.raises(NotImplementedError, match="item 17"):
        pmesh.build_mesh(ep=2, device="cpu")
    saved = pmesh.get_mesh()
    shape = dict.fromkeys(pmesh.AXIS_ORDER, 1)
    try:
        for axis in ("ep", "mp"):
            pmesh.set_mesh(pmesh.Mesh(dict(shape, **{axis: 2}), torch.device("cpu")))
            moe = pmoe.MoELayer(8, 16, num_experts=2)
            with pytest.raises(NotImplementedError, match="item 17"):
                moe(_t(1, 4, 8))
    finally:
        pmesh.set_mesh(saved)


def test_incubate_surface():
    assert incubate.moe.MoELayer is pmoe.MoELayer
    with pytest.raises(NotImplementedError, match="incubate.moe.MoELayer"):
        incubate.distributed.models.moe.MoELayer(8, 16, 2)
    with pytest.raises(ValueError, match="gate_type"):
        pmoe.MoELayer(8, 16, num_experts=2, gate="hash")
