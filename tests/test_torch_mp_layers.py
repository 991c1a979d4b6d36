"""The port's tensor-parallel layers against the JAX package's on the CPU.

- `ColumnParallelLinear` (`gather_output` on and off), `RowParallelLinear`
  (`input_is_parallel` on and off, the bias after the reduce),
  `VocabParallelEmbedding`, `ParallelCrossEntropy` (the forward) and the
  `ParallelColumnLinear` alias: the reference's layers built on its 'mp'
  mesh of 4 of the conftest's 8 CPU devices, the port's on an 'mp' mesh of
  4 ranks on the CPU, the same weights (the reference's `[in, out]`
  transposed), float32, within 1e-5.  A column-parallel output the
  reference keeps sharded is the port's list of the ranks' blocks.
- `shard_llama_for_tp`: a tp-4 (and a tp-2) Llama loaded from the
  reference's tp-4 Llama's state dict gives its logits (within 1e-4, the
  port's Llama bound) and its loss through ParallelCrossEntropy, under
  multi-head and grouped-query attention; its blocks are views of the
  loaded weights.
- The per-shard paged decode (`paged_decode_tp`, `paged_decode_q8_tp`)
  against the reference's `shard_map` of K2 and K4 over heads, run as
  `tests/test_tp_serving.py` runs it, in interpret mode on the 'mp' mesh,
  within 1e-5 in float32 (one kernel launch per rank is the plain version
  per shard here).
"""

import contextlib

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.distributed.fleet.meta_parallel import mp_layers as pmp
from paddle_tpu.models import llama as jllama
from paddle_tpu.ops import flash_attention as fa
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_layers as tmp
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as tfa

TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _meshes_and_rng():
    """Both packages' global meshes and paddle_tpu's generator come back
    as they were: later modules build models under neither mesh."""
    state = paddle.get_rng_state()
    saved = pmesh.get_mesh(), tmesh.get_mesh()
    yield
    pmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])
    paddle.set_rng_state(state)


@contextlib.contextmanager
def _ref_mesh(tp):
    """The reference's serving mesh of `tp` devices, installed for the
    block."""
    saved = pmesh.get_mesh()
    pmesh.serving_mesh(tp)
    try:
        yield
    finally:
        pmesh.set_mesh(saved)


def _port_mesh(tp):
    """An 'mp' mesh of `tp` ranks on the CPU, not installed."""
    cpu = torch.device("cpu")
    return tmesh.Mesh(dict(dict.fromkeys(tmesh.AXIS_ORDER, 1), mp=tp), cpu, [cpu] * tp)


def _np(t):
    return np.asarray(t.numpy())


def _load(port, ref):
    """The reference layer's parameters into the port's: Linear weights
    transposed."""
    with torch.no_grad():
        for name, p in port.named_parameters():
            arr = _np(getattr(ref, name))
            if name == "weight" and isinstance(port, torch.nn.Linear):
                arr = arr.T
            p.copy_(torch.from_numpy(np.array(arr)))
    return port


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gather", [True, False])
@pytest.mark.parametrize("cls", ["ColumnParallelLinear", "ParallelColumnLinear"])
def test_column_parallel_linear_matches_reference(cls, gather):
    paddle.seed(1)
    x = _x(2, 3, 16)
    with _ref_mesh(4):
        ref = getattr(pmp, cls)(16, 24, has_bias=True, gather_output=gather)
        want = _np(ref(paddle.to_tensor(x)))
    port = _load(getattr(tmp, cls)(16, 24, has_bias=True, gather_output=gather), ref)
    port.shard(_port_mesh(4))
    assert port.ranks == port.world_size == 4
    got = port(torch.from_numpy(x))
    if not gather:
        assert isinstance(got, list) and [g.shape[-1] for g in got] == [6] * 4
        got = torch.cat(got, dim=-1)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # rank r's block is a view of the weight's rows
    assert port.weight[6:12].data_ptr() == port.weight.data_ptr() + 6 * 16 * 4


@pytest.mark.parametrize("parallel_input", [True, False])
def test_row_parallel_linear_matches_reference(parallel_input):
    paddle.seed(2)
    x = _x(2, 3, 16, seed=1)
    with _ref_mesh(4):
        ref = pmp.RowParallelLinear(16, 12, has_bias=True,
                                    input_is_parallel=parallel_input)
        want = _np(ref(paddle.to_tensor(x)))
    port = _load(tmp.RowParallelLinear(16, 12, has_bias=True,
                                       input_is_parallel=parallel_input), ref)
    port.shard(_port_mesh(4))
    inp = torch.from_numpy(x)
    if parallel_input:
        inp = list(inp.split(4, dim=-1))
    got = port(inp)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    # the bias once, after the reduce: the partials carry none
    parts = [port.partial(xr, r) for r, xr in enumerate(port.split_input(torch.from_numpy(x)))]
    torch.testing.assert_close(port.reduce(parts) - port.bias, sum(parts))


def test_vocab_parallel_embedding_matches_reference():
    paddle.seed(3)
    ids = np.random.default_rng(4).integers(0, 40, size=(2, 9)).astype(np.int32)
    ids[0, :4] = [0, 9, 10, 39]  # each rank's first and last ids
    with _ref_mesh(4):
        ref = pmp.VocabParallelEmbedding(40, 8)
        want = _np(ref(paddle.to_tensor(ids)))
    port = _load(tmp.VocabParallelEmbedding(40, 8), ref).shard(_port_mesh(4))
    got = port(torch.from_numpy(ids))
    # exactly one rank holds each id, the others add zeros: bit for bit
    np.testing.assert_array_equal(got.detach().numpy(), want)


@pytest.mark.parametrize("label_shape", ["flat", "trailing-1"])
def test_parallel_cross_entropy_matches_reference(label_shape):
    logits = _x(6, 40, seed=5) * 3
    labels = np.random.default_rng(6).integers(0, 40, size=6).astype(np.int64)
    labels[2] = -100
    lab = labels[:, None] if label_shape == "trailing-1" else labels
    with _ref_mesh(4):
        want = _np(pmp.ParallelCrossEntropy()(paddle.to_tensor(logits),
                                              paddle.to_tensor(lab)))
    t = torch.from_numpy(logits)
    got = tmp.ParallelCrossEntropy()(list(t.split(10, dim=-1)), torch.from_numpy(lab))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert got.shape == (6, 1) and got[2, 0] == 0.0
    # one tensor is one rank
    np.testing.assert_allclose(tmp.ParallelCrossEntropy()(t, torch.from_numpy(lab)).numpy(),
                               want, **TOL)


def test_unbound_layers_are_one_rank():
    lin = tmp.ColumnParallelLinear(8, 12, has_bias=False, gather_output=False)
    assert lin.ranks == 1 and lin.mesh is None
    x = torch.randn(2, 8)
    (out,) = lin(x)
    torch.testing.assert_close(out, torch.nn.functional.linear(x, lin.weight))
    assert tmp.rank_bounds(10, 4) == [(0, 2), (2, 5), (5, 7), (7, 10)]


# ---------------------------------------------------------------------------
# shard_llama_for_tp
# ---------------------------------------------------------------------------


CONFIGS = {"mha": dict(), "gqa": dict(num_attention_heads=8, num_key_value_heads=4)}


@pytest.fixture(scope="module")
def ref_llamas():
    """The reference's tp-4 Llama per config, built after a seed on its
    mesh (its layers shard at construction), its state as numpy, and its
    logits and loss on one batch."""
    out = {}
    rng = np.random.default_rng(7)
    ids = rng.integers(1, 256, size=(2, 12)).astype(np.int32)
    labels = ids.astype(np.int64)
    labels[0, :3] = -100
    for name, kw in CONFIGS.items():
        paddle.seed(11)
        with _ref_mesh(4):
            jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(
                tensor_parallel_degree=4, **kw))
            jllama.shard_llama_for_tp(jm)
            loss, logits = jm(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            out[name] = (
                {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()},
                _np(logits), float(_np(loss)),
            )
    return ids, labels, out


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_shard_llama_for_tp_matches_reference(ref_llamas, name, tp):
    ids, labels, refs = ref_llamas
    state, want_logits, want_loss = refs[name]
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(
        tensor_parallel_degree=tp, **CONFIGS[name]), device="cpu")
    load_reference_state(model, state)  # the same names and logical shapes
    tllama.shard_llama_for_tp(model, _port_mesh(tp))
    assert model.tp_ranks == tp
    attn = model.llama.layers[0].self_attn
    assert isinstance(attn.q_proj, tmp.ColumnParallelLinear)
    assert isinstance(attn.o_proj, tmp.RowParallelLinear)
    assert isinstance(model.llama.embed_tokens, tmp.VocabParallelEmbedding)
    loss, logits = model(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, **LOGITS_TOL)
    assert abs(float(loss.detach()) - want_loss) < 1e-5
    # the lm_head's vocabulary blocks, gathered
    parts = model.lm_head(model.llama(torch.from_numpy(ids)))
    assert len(parts) == tp and parts[0].shape[-1] == 256 // tp


def test_shard_llama_for_tp_binds_views_and_checks_the_device():
    model = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(tensor_parallel_degree=2),
                                    device="cpu")
    assert model.tp_ranks == 1  # unbound: one rank
    mesh = _port_mesh(2)
    assert tllama.shard_llama_for_tp(model, mesh) is model
    assert all(m.mesh is mesh for m in model.modules() if isinstance(m, tmp._Sharded))
    # binding copies nothing: the parameters are the model's own
    before = {k: v.data_ptr() for k, v in model.state_dict().items()}
    tllama.shard_llama_for_tp(model, mesh)
    assert {k: v.data_ptr() for k, v in model.state_dict().items()} == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="lives on cpu"):
        tllama.shard_llama_for_tp(model, tmesh.Mesh(mesh.shape, meta, [meta] * 2))


# ---------------------------------------------------------------------------
# K2 and K4 per head shard against the reference's shard_map
# ---------------------------------------------------------------------------


def _shard_case(rng, slots=3, h=8, hk=4, d=16, ps=8, pages=9):
    ak = rng.standard_normal((pages, ps, hk, d)).astype(np.float32)
    av = rng.standard_normal((pages, ps, hk, d)).astype(np.float32)
    q = rng.standard_normal((slots, 1, h, d)).astype(np.float32)
    tables = np.array([[1, 2, 0], [3, 4, 0], [5, 6, 0]], np.int32)[:slots]
    pos = np.array([13, 9, 17], np.int32)[:slots]
    return q, ak, av, tables, pos, 24


def _split(x, tp, axis=2):
    return [torch.from_numpy(np.ascontiguousarray(c)) for c in np.split(x, tp, axis=axis)]


@pytest.mark.parametrize("h,hk", [(4, 4), (8, 4), (16, 4)])
def test_paged_decode_tp_matches_reference_shard_map(h, hk):
    import jax.numpy as jnp

    rng = np.random.default_rng(h * 10 + hk)
    q, ak, av, tables, pos, max_len = _shard_case(rng, h=h, hk=hk)
    args = (jnp.asarray(q), jnp.asarray(ak), jnp.asarray(av), jnp.asarray(tables),
            jnp.asarray(pos), max_len)
    prev = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        with _ref_mesh(4):
            want = np.asarray(fa.paged_decode_attention_array(*args, kernel="fused"))
    finally:
        fa._FORCE_INTERPRET = prev
    tfa.reset_launch_counts()
    outs = tfa.paged_decode_tp(_split(q, 4), _split(ak, 4), _split(av, 4),
                               torch.from_numpy(tables), torch.from_numpy(pos), max_len)
    assert len(outs) == 4 and outs[0].shape == (3, 1, h // 4, 16)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), want, **TOL)
    # CPU tensors run the plain version per shard and count no launch
    assert tfa.launch_counts["paged_decode_tp"] == 0
    assert tfa.launch_counts["paged_decode_fused"] == 0


def test_paged_decode_q8_tp_matches_reference_shard_map():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    q, ak, av, tables, pos, max_len = _shard_case(rng)
    scale = lambda x: np.maximum(np.abs(x).max(-1, keepdims=True), 1e-6) / 127.0  # noqa: E731
    ks, vs = scale(ak).astype(np.float32), scale(av).astype(np.float32)
    ak8 = np.clip(np.round(ak / ks), -127, 127).astype(np.int8)
    av8 = np.clip(np.round(av / vs), -127, 127).astype(np.int8)
    prev = fa._FORCE_INTERPRET
    fa._FORCE_INTERPRET = True
    try:
        with _ref_mesh(4):
            want = np.asarray(fa.paged_decode_attention_array(
                jnp.asarray(q), jnp.asarray(ak8), jnp.asarray(av8), jnp.asarray(tables),
                jnp.asarray(pos), max_len, kernel="fused", k_scale=jnp.asarray(ks),
                v_scale=jnp.asarray(vs)))
    finally:
        fa._FORCE_INTERPRET = prev
    outs = tfa.paged_decode_q8_tp(_split(q, 4), _split(ak8, 4), _split(av8, 4),
                                  _split(ks, 4), _split(vs, 4), torch.from_numpy(tables),
                                  torch.from_numpy(pos), max_len)
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), want, **TOL)


def test_paged_decode_tp_wants_one_shard_per_rank():
    rng = np.random.default_rng(4)
    q, ak, av, tables, pos, max_len = _shard_case(rng)
    with pytest.raises(ValueError, match="one q, arena"):
        tfa.paged_decode_tp(_split(q, 4), _split(ak, 2), _split(av, 4),
                            torch.from_numpy(tables), torch.from_numpy(pos), max_len)
