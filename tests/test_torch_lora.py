"""The port's multi-tenant LoRA (`paddle_tpu_torch.lora` and the engine's
`lora=`) against the JAX package on the CPU.

- Registries: one weights dict registers in both with the same ids, scale
  and validation messages; `make_random` draws the same float32 factors
  for the same seed.
- `lora_delta_add` (index_select + bmm) against the reference's
  `_delta_add` on the same numpy inputs, float32, within 1e-6 relative.
- The arena: refcounts, LRU eviction and the audit as the reference's
  arena keeps them over one sequence of acquires and releases; an upload
  rewrites one row of the same storage, zero-padded.
- Engines on shared weights (`load_reference_state`): greedy tokens of a
  mixed co-batch (base, a1, a2) identical to the JAX engine's, over
  full-precision and int8 pages; base rows identical to a no-LoRA port
  engine; no new trace under adapter churn; 16 adapters in one decode.

The tiny config runs in float32 with page_size 8.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import lora as jlora
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import lora as tlora
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 16], queue_depth=32,
              seed=0, paged=True, page_size=8)
# factors large enough that rank-4 deltas move the tiny model's greedy
# tokens, so "adapters differ" and "the right row was gathered" show
SCALE = 0.1


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(scope="module")
def models():
    paddle.seed(43)
    cfg = dict(num_key_value_heads=2)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**cfg))
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(**cfg), device="cpu")
    return jm, load_reference_state(tm, state)


@pytest.fixture
def invariants():
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    yield
    tcore.set_flags({"FLAGS_serve_debug_invariants": False})


def _registries(models, n, rank=4, scale=SCALE):
    """The same n random adapters registered in both packages: the
    reference's `make_random` dicts, registered as they are in the port."""
    jm, tm = models
    jreg, treg = jlora.AdapterRegistry(jm.config), tlora.AdapterRegistry(tm.config)
    for i in range(1, n + 1):
        a = jlora.make_random(jreg, f"a{i}", rank=rank, seed=i, scale=scale)
        treg.register(a.name, a.weights, a.rank, alpha=a.scale * a.rank)
    return jreg, treg


def _engine(tm, treg=None, capacity=4, rank_max=8, **kw):
    lora = (None if treg is None
            else tlora.AdapterArena(treg, capacity=capacity, rank_max=rank_max,
                                    device="cpu"))
    return ContinuousBatchingEngine(tm, device="cpu", lora=lora, **{**ENGINE, **kw})


def _mixed(eng, new=6):
    """A base request and one per adapter, co-batched; their outputs."""
    reqs = [eng.submit(_prompt(10, 5), max_new_tokens=new),
            eng.submit(_prompt(10, 6), max_new_tokens=new, adapter="a1"),
            eng.submit(_prompt(13, 7), max_new_tokens=new, adapter="a2")]
    eng.run_until_idle()
    return [r.wait(1).tolist() for r in reqs]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------


def test_make_random_draws_the_references_factors(models):
    jm, tm = models
    jreg, treg = jlora.AdapterRegistry(jm.config), tlora.AdapterRegistry(tm.config)
    ja = jlora.make_random(jreg, "x", rank=3, seed=11, alpha=6.0)
    ta = tlora.make_random(treg, "x", rank=3, seed=11, alpha=6.0)
    assert (ta.adapter_id, ta.rank, ta.scale) == (ja.adapter_id, ja.rank, ja.scale)
    assert ta.scale == 2.0 and sorted(ta.weights) == sorted(ja.weights)
    for key, (A, B) in ja.weights.items():
        assert ta.weights[key][0].dtype == np.float32
        np.testing.assert_array_equal(ta.weights[key][0], A)
        np.testing.assert_array_equal(ta.weights[key][1], B)
    assert treg.dims == jreg.dims and tlora.TARGETS == jlora.TARGETS
    assert tlora.target_dims(tm.config) == jlora.target_dims(jm.config)


def _bad_cases(dims):
    d_in, d_out = dims["q_proj"]
    z = np.zeros
    return [
        ("A shape", dict(weights={(0, "q_proj"): (z((d_in, 3)), z((4, d_out)))}, rank=4)),
        ("B shape", dict(weights={(0, "q_proj"): (z((d_in, 4)), z((4, 7)))}, rank=4)),
        ("out of range", dict(weights={(9, "q_proj"): (z((d_in, 4)), z((4, d_out)))},
                              rank=4)),
        ("unknown target", dict(weights={(0, "lm_head"): (z((1, 4)), z((4, 1)))},
                                rank=4)),
        ("rank must be", dict(weights={}, rank=0)),
        ("already registered", dict(weights={}, rank=2, name="a1")),
    ]


def test_registry_ids_and_validation_match_the_reference(models):
    jreg, treg = _registries(models, 2)
    for reg in (jreg, treg):
        a1, a2 = reg.resolve("a1"), reg.resolve("a2")
        assert (a1.adapter_id, a2.adapter_id) == (1, 2)  # ids from 1; 0 = base
        assert reg.resolve(2) is a2 and reg.names() == ["a1", "a2"] and len(reg) == 2
    for what, case in _bad_cases(treg.dims):
        name = case.pop("name", "bad")
        errs = []
        for reg in (jreg, treg):
            with pytest.raises(ValueError, match=what) as ei:
                reg.register(name, **case)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]
    with pytest.raises(tlora.AdapterUnknown) as ei:
        treg.resolve("nope")
    assert ei.value.adapter == "nope" and str(ei.value) == "unknown adapter 'nope'"
    # the ids stay monotonic after failed registrations
    assert tlora.make_random(treg, "a3", rank=2, seed=3).adapter_id == 3


# ---------------------------------------------------------------------------
# the delta
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s", [(3, 1), (2, 5)])
def test_lora_delta_add_matches_reference_delta_add(b, s):
    from paddle_tpu.lora.arena import _delta_add

    rng = np.random.default_rng(7)
    n, d_in, r, d_out = 4, 24, 8, 40
    y = rng.standard_normal((b, s, d_out)).astype(np.float32)
    x = rng.standard_normal((b, s, d_in)).astype(np.float32)
    A = rng.standard_normal((n, d_in, r)).astype(np.float32)
    B = rng.standard_normal((n, r, d_out)).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, n).astype(np.float32)
    A[0], B[0], scale[0] = 0, 0, 0  # the base row
    ids = np.array([2, 0, 3][:b], np.int32)
    got = tlora.lora_delta_add(*(torch.from_numpy(v) for v in (y, x, ids, A, B, scale)))
    ref = np.asarray(_delta_add(*(paddle.to_tensor(v) for v in
                                  (y, x, ids, A, B, scale))).numpy())
    # 1e-6 relative to the output's scale: both sum the same float32
    # products, in another order
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= 1e-6, err
    # id 0 adds exactly nothing
    row = list(ids).index(0)
    np.testing.assert_array_equal(got[row].numpy(), y[row])


# ---------------------------------------------------------------------------
# the arena
# ---------------------------------------------------------------------------


def _arena_script(lora, reg, arena):
    """Acquires, releases and evictions over a 2-slot arena; everything
    observable after each move."""
    a1, a2, a3 = (reg.resolve(f"a{i}") for i in (1, 2, 3))
    seen = []

    def note(what):
        seen.append((what, arena.resident(), arena._pool.refs.tolist(),
                     arena.stats()))

    s1 = arena.acquire(a1)
    s2 = arena.acquire(a2)
    arena.check_invariants({s1: 1, s2: 1})
    note(("acquire", s1, s2))
    with pytest.raises(lora.AdapterArenaFull):
        arena.acquire(a3)
    arena.release(s1)
    arena.check_invariants({s2: 1})
    note("release a1")
    arena.release(s2)
    assert arena.acquire(a2) == s2  # a hit bumps a2's LRU tick
    s3 = arena.acquire(a3)
    assert s3 == s1  # the LRU victim was a1
    arena.check_invariants({s2: 1, s3: 1})
    note(("a3 evicts a1", s3))
    assert arena.acquire(a2) == s2
    arena.check_invariants({s2: 2, s3: 1})
    assert arena.slot_of(a3.adapter_id) == s3 and arena.slot_of(a1.adapter_id) is None
    note("a2 again")
    with pytest.raises(AssertionError, match="refcount mismatch"):
        arena.check_invariants({s2: 1, s3: 1})
    return seen


def test_arena_refcount_lru_and_audit_match_the_reference(models):
    jreg, treg = _registries(models, 3, rank=2)
    ref = _arena_script(jlora, jreg, jlora.AdapterArena(jreg, capacity=2, rank_max=4))
    got = _arena_script(tlora, treg, tlora.AdapterArena(treg, capacity=2, rank_max=4,
                                                        device="cpu"))
    assert got == ref
    assert got[-1][3]["resident"] == 2 and 0.0 < got[-1][3]["hit_rate"] < 1.0


def test_arena_upload_rewrites_one_row_in_place_zero_padded(models):
    _, treg = _registries(models, 2, rank=4)
    partial = {k: v for k, v in treg.resolve("a1").weights.items()
               if k[1] in ("q_proj", "down_proj")}
    treg.register("part", partial, rank=4, alpha=8.0)
    arena = tlora.AdapterArena(treg, capacity=1, rank_max=6, device="cpu")
    ptr = arena._rows.data_ptr()
    views = {k: (A.data_ptr(), B.data_ptr()) for k, (A, B) in arena._stacks.items()}
    assert arena.nbytes == 2 * arena.row_elems * 4
    a2 = treg.resolve("a2")
    slot = arena.acquire(a2)
    arena.release(slot)
    for key, (A, B) in arena._stacks.items():
        wa, wb = a2.weights[key]
        np.testing.assert_array_equal(A[slot, :, :4].numpy(), wa)
        np.testing.assert_array_equal(B[slot, :4].numpy(), wb)
        assert not A[slot, :, 4:].any() and not B[slot, 4:].any()  # rank padding
        assert not A[0].any() and not B[0].any()  # the base row stays zero
    assert arena._scale[slot].item() == 1.0 and arena._scale[0].item() == 0.0
    # the next tenant of the slot: its missing targets are zero, not a2's
    assert arena.acquire(treg.resolve("part")) == slot
    for (layer, t), (A, B) in arena._stacks.items():
        assert bool(A[slot].any()) == (t in ("q_proj", "down_proj"))
    assert arena._scale[slot].item() == 2.0
    assert arena._rows.data_ptr() == ptr
    assert {k: (A.data_ptr(), B.data_ptr())
            for k, (A, B) in arena._stacks.items()} == views
    # tensor parallelism over two ranks (reference arena.py:148-171): column
    # targets split B on d_out, row targets A on d_in, the other factor
    # whole; every shard is a view of the same rows, so the upload above is
    # in every rank's shard already
    from paddle_tpu_torch.distributed import mesh as tmesh

    cpu = torch.device("cpu")
    arena.shard_for_tp(tmesh.Mesh(dict(dict.fromkeys(tmesh.AXIS_ORDER, 1), mp=2),
                                  cpu, [cpu, cpu]))
    for key, (A, B) in arena._stacks.items():
        row = key[1] in ("o_proj", "down_proj")
        shards = [arena.rank_stacks(key, r) for r in range(2)]
        for Ar, Br in shards:
            assert (Br if row else Ar) is (B if row else A)
            assert Ar.untyped_storage().data_ptr() == ptr
            assert Br.untyped_storage().data_ptr() == ptr
        joined = torch.cat([Ar if row else Br for Ar, Br in shards], dim=1 if row else 2)
        assert torch.equal(joined, A if row else B)


def test_arena_reads_its_flags(models):
    _, treg = _registries(models, 1)
    saved = {k: tcore.flag(k) for k in ("FLAGS_serve_lora_capacity",
                                        "FLAGS_serve_lora_rank_max")}
    try:
        tcore.set_flags({"FLAGS_serve_lora_capacity": 3,
                         "FLAGS_serve_lora_rank_max": 5})
        arena = tlora.AdapterArena(treg, device="cpu")
        assert (arena.capacity, arena.rank_max) == (3, 5)
        assert arena._stacks[(0, "q_proj")][0].shape == (4, 64, 5)
    finally:
        tcore.set_flags(saved)
    for bad in (dict(capacity=0), dict(rank_max=0)):
        with pytest.raises(ValueError, match=">= 1"):
            tlora.AdapterArena(treg, device="cpu", **bad)


# ---------------------------------------------------------------------------
# engines against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_mixed_cobatch_tokens_identical_to_jax_engine(models, invariants, kv_quant):
    jm, tm = models
    jreg, treg = _registries(models, 2)
    ref = _mixed(JaxEngine(jm, lora=jlora.AdapterArena(jreg, capacity=4),
                           kv_quant=kv_quant, **ENGINE))
    eng = _engine(tm, treg, kv_quant=kv_quant)
    eng.warmup()
    warm = eng.compile_counts()
    got = _mixed(eng)
    assert got == ref
    assert eng.compile_counts() == warm  # one graph set, any adapter mix
    assert len({tuple(g[10:]) for g in got[:2]}) == 2  # a1 moved the tokens
    base = _engine(tm, kv_quant=kv_quant)
    assert base.generate(_prompt(10, 5), max_new_tokens=6).tolist() == got[0]
    # the adapter's row on its own prompt is not the base model's
    assert base.generate(_prompt(10, 6), max_new_tokens=6).tolist() != got[1]
    health = eng.healthz()["lora"]
    assert health["adapters"] == ["a1", "a2"] and health["resident"] == 2


def test_each_adapter_row_equals_an_engine_holding_it_alone(models):
    _, tm = models
    _, treg = _registries(models, 2)
    mixed = _mixed(_engine(tm, treg))
    for name, idx, (n, seed) in (("a1", 1, (10, 6)), ("a2", 2, (13, 7))):
        _, alone = _registries(models, 2)
        eng = _engine(tm, alone, capacity=1)
        out = eng.generate(_prompt(n, seed), max_new_tokens=6, adapter=name)
        assert out.tolist() == mixed[idx]


def test_no_new_trace_under_adapter_churn(models, invariants):
    _, tm = models
    _, treg = _registries(models, 6, rank=2)
    eng = _engine(tm, treg, capacity=3, rank_max=4, slots=2)
    eng.warmup()
    warm = eng.compile_counts()
    profiler.reset_lora()
    outs = {}
    for rnd in range(2):
        for i in range(1, 7):
            out = eng.generate(_prompt(10, i), max_new_tokens=3,
                               adapter=f"a{i}").tolist()
            if rnd:
                assert outs[i] == out  # a reload reproduces the tokens
            outs[i] = out
    assert eng.compile_counts() == warm
    g = profiler.lora_summary()
    assert g["evictions"] >= 6 and g["loads"] >= 9
    assert eng.healthz()["lora"]["resident"] == 3


def test_sixteen_adapters_cobatched_in_one_decode(models, invariants):
    _, tm = models
    _, treg = _registries(models, 16, rank=2)
    eng = _engine(tm, treg, capacity=16, rank_max=4, slots=16, max_len=32,
                  prefill_buckets=[8])
    eng.warmup()
    warm = eng.compile_counts()
    reqs = [eng.submit(_prompt(6, 99), max_new_tokens=6, adapter=f"a{i}")
            for i in range(1, 17)]
    eng.step()  # admits all 16 and runs one decode step over them
    assert eng.active_slots == 16 and sorted(eng._slot_adapter.tolist()) == list(
        range(1, 17))
    eng.run_until_idle()
    outs = [tuple(r.wait(1).tolist()) for r in reqs]
    assert eng.compile_counts() == warm
    assert len(set(outs)) >= 12  # one prompt, overwhelmingly distinct tokens
    assert eng.healthz()["lora"]["resident"] == 16


def test_engine_refusals_match_the_reference(models):
    jm, tm = models
    jreg, treg = _registries(models, 1, rank=4)
    eng = _engine(tm, treg, rank_max=8)
    with pytest.raises(tlora.AdapterUnknown):
        eng.submit(_prompt(8), max_new_tokens=2, adapter="nope")
    big = tlora.make_random(treg, "big", rank=16, seed=5)
    with pytest.raises(ValueError, match="exceeds the arena rank_max 8"):
        eng.submit(_prompt(8), max_new_tokens=2, adapter=big.name)
    errs = []
    for e in (JaxEngine(jm, **ENGINE), _engine(tm)):
        with pytest.raises(ValueError, match="no LoRA arena") as ei:
            e.submit(_prompt(8), max_new_tokens=2, adapter="a1")
        errs.append(str(ei.value))
    assert errs[0] == errs[1]
    # the dense pool refuses LoRA, as the reference does
    with pytest.raises(ValueError, match="requires the paged engine"):
        _engine(tm, treg, paged=False)
    # an arena of another model's shapes
    other = tlora.AdapterRegistry(tllama.LlamaConfig.tiny(num_hidden_layers=3))
    with pytest.raises(ValueError, match="another model"):
        ContinuousBatchingEngine(tm, device="cpu", **ENGINE,
                                 lora=tlora.AdapterArena(other, capacity=2,
                                                         device="cpu"))
    # adapter 0 is the base model
    assert eng.generate(_prompt(8), max_new_tokens=2, adapter=0).size == 10
