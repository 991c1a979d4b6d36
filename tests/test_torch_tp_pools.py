"""Tensor-parallel serving under grouped-query attention, over int8 pages
and in the dense slot pool: the port's tp-2 and tp-4 engines against the
JAX package's tp-4 engines on the CPU.

The config is the tiny Llama with 8 q heads over 4 kv heads (rep 2), so
rank r of tp 4 holds q heads 2r, 2r+1 with kv head r and rank r of tp 2 q
heads 4r..4r+3 with kv heads 2r, 2r+1: a head split that broke GQA's
packing would part from the reference here, where the multi-head config
of `test_torch_tp_serving.py` would not see it.  The traffic: a short
prompt, two longer ones, and a prefix-cache hit on the second (paged
engines).  Both packages' engines take the reference's weights, float32,
page_size 8; each holds its tokens against the reference's tp-4 engine
of the same pool, with no trace under traffic:

- the paged engine over full-precision pages (K2 per rank on the card);
- int8 pages (K4 per rank, each rank's scale arenas over its kv heads);
- the dense slot pool (K2 per rank over its caches' page views).
"""

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

GQA = dict(num_attention_heads=8, num_key_value_heads=4)
ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16, seed=0)
POOLS = {
    "paged": dict(paged=True, page_size=8),
    "int8": dict(paged=True, page_size=8, kv_quant="int8"),
    "dense": dict(paged=False),
}


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    state = paddle.get_rng_state()
    saved = pmesh.get_mesh(), tmesh.get_mesh()
    yield
    pmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])
    profiler.reset_mesh()
    paddle.set_rng_state(state)


def _prompt(n, seed):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


TRAFFIC = [_prompt(6, 3), _prompt(20, 4), _prompt(13, 5)]
HIT = np.concatenate([TRAFFIC[1][:16], _prompt(5, 6)])  # shares two pages


@pytest.fixture(scope="module")
def state():
    np.random.seed(21)
    paddle.seed(21)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(**GQA))
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _serve(eng, paged):
    """The traffic one request at a time (each commits its pages before
    the next looks up), then the hit on a paged engine."""
    out = []
    for p in TRAFFIC + ([HIT] if paged else []):
        r = eng.submit(p, max_new_tokens=10)
        eng.run_until_idle()
        out.append(r.wait(1).tolist())
    return out


@pytest.fixture(scope="module")
def reference(state):
    """The reference's tp-4 engine per pool: its tokens."""
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(tensor_parallel_degree=4, **GQA))
    jm.set_state_dict(state)
    return {name: _serve(JaxEngine(jm, tp=4, **ENGINE, **kw), kw["paged"])
            for name, kw in POOLS.items()}


@pytest.fixture(scope="module")
def models(state):
    return {tp: load_reference_state(tllama.LlamaForCausalLM(
        tllama.LlamaConfig.tiny(tensor_parallel_degree=tp, **GQA), device="cpu"), state)
        for tp in (2, 4)}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("pool", list(POOLS))
def test_tp_tokens_equal_reference_tp4(reference, models, pool, tp):
    kw = POOLS[pool]
    eng = ContinuousBatchingEngine(models[tp], device="cpu", tp=tp,
                                   devices=["cpu"] * tp, **ENGINE, **kw)
    eng.warmup()
    warm = dict(eng.compile_counts())
    hits = profiler.paging_summary().get("prefix_hits", 0)
    assert _serve(eng, kw["paged"]) == reference[pool]
    assert dict(eng.compile_counts()) == warm
    kv = 4 // tp
    if kw["paged"]:
        assert profiler.paging_summary()["prefix_hits"] == hits + 1
        for ranks in eng._arenas:
            assert [a.k.shape[2] for a in ranks] == [kv] * tp
            if pool == "int8":
                assert all(a.k_scale.shape == (eng.pool_pages, 8, kv, 1) for a in ranks)
    else:
        for ranks in eng._caches:
            assert [c.k.shape for c in ranks] == [(3, 64, kv, 8)] * tp
