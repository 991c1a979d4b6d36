"""Tensor x context parallel serving of the port (tp 2 x cp 2) against the
JAX package's engine on its ('cp', 'mp') mesh, on the CPU.

The reference's tp-2 x cp-2 engine runs on 4 of the conftest's 8 CPU
devices; the port's ranks run on the CPU, named explicitly (`devices=
["cpu"] * 2`), each rank's arena split into the cp page shards.  Both
serve the tiny Llama on shared weights (the reference's state dict, loaded
by `load_reference_state`), paged, page_size 8, spec_k 3, in float32:

- greedy tokens identical to the reference's on mixed traffic (a short
  prompt, a repetitive one the drafter fires on, a prefix-cache hit on it),
  over full-precision and int8 pages, no trace under traffic, the page
  audit (`_check_invariants`) clean after it;
- `/healthz`'s tp, cp, mesh_shape and page_free_by_shard equal the
  reference's, and the mesh gauges count (2L + 1) + L merges a step;
- one verify step calls `paged_decode_cp_tp` once per layer, each call
  one `paged_decode_cp` (K5) per rank over the rank's head shard (spies);
- `paged_decode_cp_tp` over the ranks' head shards equals `paged_decode_cp`
  over the whole heads, bit for bit, for a decode step and a verify
  window, full precision and int8;
- `serving_mesh(2, cp=2)` records both degrees.

Launch counts read 0 here (CPU tensors run the plain versions).
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.ops import flash_attention as tfa

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8, spec_k=3)
TP, CP = 2, 2
QUANTS = ["none", "int8"]


@pytest.fixture(scope="module", autouse=True)
def _isolation():
    """Engines install both packages' global meshes and record the mesh
    gauges: put the meshes, the gauges and paddle_tpu's generator back."""
    state = paddle.get_rng_state()
    saved = pmesh.get_mesh(), tmesh.get_mesh()
    yield
    pmesh.set_mesh(saved[0])
    tmesh.set_mesh(saved[1])
    profiler.reset_mesh()
    paddle.set_rng_state(state)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


def _cycle_prompt(n=20, period=6, seed=7):
    """A repetitive prompt, so that n-gram drafting fires under spec."""
    pat = _prompt(period, seed=seed)
    return np.tile(pat, -(-n // period))[:n].astype(np.int32)


MIXED = [_prompt(6, seed=3), _cycle_prompt(20), _cycle_prompt(20)]


def _run(engine, prompts, max_new_tokens=16):
    rs = [engine.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    engine.run_until_idle()
    return [r.wait(1).tolist() for r in rs]


@pytest.fixture(scope="module")
def state():
    """The reference tiny Llama's weights as numpy (the tp tests' seed)."""
    np.random.seed(1234)
    paddle.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port(state, **kw):
    cfg = tllama.LlamaConfig.tiny(tensor_parallel_degree=TP)
    model = load_reference_state(tllama.LlamaForCausalLM(cfg, device="cpu"), state)
    eng = ContinuousBatchingEngine(model, device="cpu", tp=TP, cp=CP,
                                   devices=["cpu"] * TP, **{**ENGINE, **kw})
    return eng.warmup()


@pytest.fixture(scope="module")
def served(state):
    """Per KV precision, the reference's tp-2 x cp-2 engine and the port's
    on the mixed traffic: tokens, /healthz and the mesh gauges after it;
    the port's engine (warmed, the page audit on during the traffic) and
    its compile counts after warmup."""
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(tensor_parallel_degree=TP))
    jm.set_state_dict(state)
    out = {}
    for quant in QUANTS:
        ref = JaxEngine(jm, tp=TP, cp=CP, kv_quant=quant, **ENGINE)
        ref.warmup()
        s = dict(ref_tokens=_run(ref, MIXED), ref_health=ref.healthz(),
                 ref_gauges=dict(jprofiler._mesh_gauges))
        eng = _port(state, kv_quant=quant)
        s.update(engine=eng, warm=dict(eng.compile_counts()),
                 gauges=profiler.mesh_summary())
        before = profiler.paging_summary().get("prefix_hits", 0)
        tcore.set_flags({"FLAGS_serve_debug_invariants": True})
        try:
            s["tokens"] = _run(eng, MIXED)
        finally:
            tcore.set_flags({"FLAGS_serve_debug_invariants": False})
        s.update(health=eng.healthz(),
                 hits=profiler.paging_summary()["prefix_hits"] - before)
        out[quant] = s
    return out


@pytest.mark.parametrize("quant", QUANTS)
def test_tp_cp_greedy_identical_to_reference_on_mixed_traffic(served, quant):
    s = served[quant]
    eng = s["engine"]
    assert s["tokens"] == s["ref_tokens"]
    assert s["hits"] >= 1  # the third prompt hits the second's pages
    assert dict(eng.compile_counts()) == s["warm"]
    assert s["warm"]["decode"] == 1 and s["warm"]["verify"] == 1
    eng._check_invariants()
    # every rank's arena: the pool's pages, its head block, its cp shards
    for ranks in eng._arenas:
        assert len(ranks) == TP
        for a in ranks:
            assert a.k.shape == (eng.pool_pages, 8, 4 // TP, 16)
    assert eng.pool_pages % CP == 0


@pytest.mark.parametrize("quant", QUANTS)
def test_healthz_mesh_fields_equal_the_reference(served, quant):
    s = served[quant]
    h, ref = s["health"], s["ref_health"]
    for key in ("tp", "cp", "mesh_shape", "page_free_by_shard"):
        assert h[key] == ref[key], key
    assert h["mesh_shape"] == {"cp": CP, "mp": TP}


def test_mesh_gauges_count_the_reduces_and_the_cp_merges(served):
    """(2L + 1) reduces for tp and L partials merges for cp a step, as the
    reference's gauges read (L = 2 layers)."""
    ref, got = served["none"]["ref_gauges"], served["none"]["gauges"]
    assert ref["allreduce_per_step"] == (2 * 2 + 1) + 2
    for key in ("tp", "cp", "allreduce_per_step"):
        assert got[key] == ref[key], key
    assert got["devices"] == 1  # both ranks on the one CPU device


def test_a_verify_step_runs_k5_once_per_rank_and_layer(served, monkeypatch):
    """The per-shard launch structure the card's launch counts show: one
    `paged_decode_cp_tp` call per layer (llama's import), each making one
    `paged_decode_cp` call per rank (looked up at call time)."""
    eng = served["none"]["engine"]
    outer, inner = [], []
    real_tp, real_cp = tllama.paged_decode_cp_tp, tfa.paged_decode_cp
    monkeypatch.setattr(tllama, "paged_decode_cp_tp",
                        lambda qs, *a, **k: outer.append(len(qs)) or real_tp(qs, *a, **k))
    monkeypatch.setattr(tfa, "paged_decode_cp",
                        lambda q, *a, **k: inner.append(q.shape) or real_cp(q, *a, **k))
    req = eng.submit(_prompt(5, seed=1), max_new_tokens=2)
    eng.step()  # admission + one verify step
    assert outer == [TP] * 2  # one call per layer, tp rank operands each
    # verify window k+1 = 4 rows of 3 slots, 2 of the 4 q heads a rank
    assert inner == [(3, 4, 2, 16)] * (TP * 2)
    eng.run_until_idle()
    assert len(req.wait(1)) == 7


def _cp_case(b, sq, quant, seed):
    """A cp=2 arena (8 kv heads, head_dim 16, pages of 8), its global tables
    and positions, as the engine lays them out (round-robin shards, each
    with its scratch page first)."""
    g = torch.Generator().manual_seed(seed)
    h, hk, d, ps, P = 8, 4, 16, 8, 6
    per = b * (P // CP) + 1
    ak = torch.randn(CP * per, ps, hk, d, generator=g)
    av = torch.randn(CP * per, ps, hk, d, generator=g)
    q = torch.randn(b, sq, h, d, generator=g)
    scales = (None, None)
    if quant:
        (ak, ks), (av, vs) = tllama._quantize_kv_rows(ak), tllama._quantize_kv_rows(av)
        scales = (ks, vs)
    rng = np.random.RandomState(seed)
    tables = np.zeros((b, P), np.int32)
    for s in range(CP):
        ids = rng.permutation(np.arange(s * per + 1, (s + 1) * per))
        tables[:, s::CP] = ids.reshape(b, P // CP)
    pos = torch.tensor(rng.randint(0, P * ps - sq, size=b), dtype=torch.int32)
    return q, ak, av, scales, torch.from_numpy(tables), pos, P * ps


@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
@pytest.mark.parametrize("sq", [1, 4], ids=["decode", "verify"])
def test_paged_decode_cp_tp_equals_k5_on_the_whole_heads(sq, quant):
    q, ak, av, (ks, vs), tables, pos, max_len = _cp_case(3, sq, quant, seed=5 + sq)
    whole = tfa.paged_decode_cp(q, ak, av, tables, pos, max_len, CP, k_scale=ks,
                                v_scale=vs)
    split = lambda t: tpaging.split_kv_heads(t, TP)  # noqa: E731
    qs = split(q)
    sc = (split(ks), split(vs)) if quant else (None, None)
    outs = tfa.paged_decode_cp_tp(qs, split(ak), split(av), tables, pos, max_len,
                                  CP, None, *sc)
    assert len(outs) == TP
    assert torch.equal(tpaging.join_kv_heads(outs), whole)
    assert tfa.launch_counts["paged_decode_cp_tp"] == 0  # CPU tensors
    # the ranks share one set of stacked local tables
    local = tfa.cp_stacked_tables(tables, CP, ak.shape[0] // CP, ak.shape[1])
    again = tfa.paged_decode_cp_tp(qs, split(ak), split(av), tables, pos, max_len,
                                   CP, None, *sc, local=local)
    assert all(torch.equal(a, b) for a, b in zip(again, outs))


def test_paged_decode_cp_tp_wants_one_shard_per_rank():
    q, ak, av, _, tables, pos, max_len = _cp_case(2, 1, False, seed=3)
    with pytest.raises(ValueError, match="one q, arena"):
        tfa.paged_decode_cp_tp(tpaging.split_kv_heads(q, 2), [ak], [av], tables,
                               pos, max_len, CP)
    with pytest.raises(ValueError, match="together"):
        tfa.paged_decode_cp_tp([q], [ak], [av], tables, pos, max_len, CP,
                               k_scales=[ak])


def test_serving_mesh_records_tp_and_cp():
    saved = tmesh.get_mesh()
    try:
        mesh = tmesh.serving_mesh(TP, cp=CP, devices=["cpu"] * TP)
        assert {a: n for a, n in mesh.shape.items() if n > 1} == {"cp": CP, "mp": TP}
        assert tmesh.axis_size("cp") == CP and tmesh.axis_size("mp") == TP
        assert mesh.devices == [torch.device("cpu")] * TP
    finally:
        tmesh.set_mesh(saved)
