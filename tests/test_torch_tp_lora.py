"""A LoRA co-batch under tensor parallelism: the port's tp-2 and tp-4
engines against the JAX package's tp-4 engine on the CPU (the counterpart
of `tests/test_tp_serving.py::test_tp4_lora_cobatch_identical`).

Both packages register the same reference adapters (`make_random` dicts)
over the tiny Llama on shared weights, float32, paged, page_size 8.  The
port's arena cuts its stacks per rank (`AdapterArena.shard_for_tp`): column
targets split B on d_out, row targets A on d_in, so each rank's row-target
delta is a partial sum that joins the row-parallel reduce.  A co-batch of
three tenants gives the reference's tokens, base rows stay the base
model's, and adapter churn (a fourth and fifth adapter evicting earlier
ones from a two-slot arena) retraces nothing and keeps every rank's shard
a view of the arena's rows.
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu import lora as jlora
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import lora as tlora
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8)


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    state = paddle.get_rng_state()
    saved = pmesh.get_mesh(), tmesh.get_mesh()
    yield
    pmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])
    profiler.reset_mesh()
    paddle.set_rng_state(state)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


PROMPTS = [_prompt(12, seed=s) for s in range(3)]


@pytest.fixture(scope="module")
def setup():
    """The reference's tp-4 Llama (the reference test's seed), the same
    five adapters in both registries, and the reference's co-batch."""
    np.random.seed(1234)
    paddle.seed(1234)
    base = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in base.state_dict().items()}
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(tensor_parallel_degree=4))
    jm.set_state_dict(state)
    jreg = jlora.AdapterRegistry(jm.config)
    adapters = [jlora.make_random(jreg, f"a{i}", rank=4, seed=i, scale=0.1)
                for i in range(1, 6)]
    ref = JaxEngine(jm, lora=jlora.AdapterArena(jreg), tp=4, **ENGINE)
    ref.warmup()
    return state, adapters, _tenants(ref)


def _tenants(engine, names=("a1", "a2", "a3")):
    rs = [engine.submit(p, max_new_tokens=12, adapter=n) for p, n in zip(PROMPTS, names)]
    engine.run_until_idle()
    return [r.wait(1).tolist() for r in rs]


def _port(state, adapters, tp, capacity=4):
    model = load_reference_state(tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(tensor_parallel_degree=tp), device="cpu"), state)
    treg = tlora.AdapterRegistry(model.config)
    for a in adapters:
        treg.register(a.name, a.weights, a.rank, alpha=a.scale * a.rank)
    arena = tlora.AdapterArena(treg, capacity=capacity, device="cpu")
    return ContinuousBatchingEngine(model, device="cpu", lora=arena, tp=tp,
                                    devices=["cpu"] * tp, **ENGINE)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_lora_cobatch_identical_to_reference(setup, tp):
    state, adapters, want = setup
    eng = _port(state, adapters, tp)
    eng.warmup()
    warm = dict(eng.compile_counts())
    got = _tenants(eng)
    assert got == want
    assert len({tuple(g[12:]) for g in got}) == 3  # the adapters moved the tokens
    assert dict(eng.compile_counts()) == warm  # one graph set for any mix
    # base rows on the tp engine are the base model's (arena slot 0)
    r = eng.submit(PROMPTS[0], max_new_tokens=6)
    eng.run_until_idle()
    plain = ContinuousBatchingEngine(eng.model, device="cpu", tp=tp,
                                     devices=["cpu"] * tp, **ENGINE)
    assert r.wait(1).tolist() == plain.generate(PROMPTS[0], max_new_tokens=6).tolist()


def test_tp4_adapter_churn_retraces_nothing(setup):
    state, adapters, want = setup
    eng = _port(state, adapters, 4, capacity=2)
    eng.warmup()
    warm = dict(eng.compile_counts())
    arena = eng._lora
    rows = arena._rows.untyped_storage().data_ptr()
    outs = [_tenants(eng, names) for names in (("a1", "a2", None), ("a4", "a5", None),
                                               ("a1", "a2", None))]
    assert dict(eng.compile_counts()) == warm
    assert outs[0] == outs[2]
    assert outs[0][:2] == want[:2]
    for key in arena._stacks:
        for r in range(4):
            A, B = arena.rank_stacks(key, r)
            assert A.untyped_storage().data_ptr() == B.untyped_storage().data_ptr() == rows
