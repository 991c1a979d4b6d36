"""Tensor-parallel serving of the port against the JAX package's tp-4
engine on the CPU (the counterpart of `tests/test_tp_serving.py`).

The reference's tp-4 engine runs on an 'mp' mesh of 4 of the conftest's 8
CPU devices; the port's tp-2 and tp-4 engines run their ranks on the CPU,
named explicitly (`devices=["cpu"] * tp`).  Both serve the tiny Llama on
shared weights (the reference's state dict, loaded by
`load_reference_state`), paged, page_size 8, with speculation (spec_k 3)
on, in float32:

- greedy tokens identical to the reference's on mixed traffic (a short
  prompt, a repetitive one the drafter fires on, a prefix-cache hit on it),
  no trace under traffic;
- speculation's counters (steps, proposed, accepted, emitted) equal;
- a warm restart keeps the rank arenas and every graph, and the tokens;
- `/healthz`, `/metrics` and the flight header carry the mesh;
- one decode step runs K2 once per rank and layer (a spy on the wrapper);
- `validate_tp`'s errors and the unsharded-model error are the reference's;
  ranks on distinct devices and a serving mesh of cp alone raise naming
  item 17.

Grouped-query attention, int8 pages and the dense pool are
`test_torch_tp_pools.py`'s; LoRA co-batches `test_torch_tp_lora.py`'s; tp x
cp (K5 per head shard) `test_torch_tp_cp.py`'s; tp in the disaggregated
roles and `export_kv` at tp `test_torch_tp_disagg.py`'s.
"""

import json
import re
import types
import urllib.request

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprofiler
from paddle_tpu.distributed import mesh as pmesh
from paddle_tpu.distributed.sharding import ShardingError as RefShardingError
from paddle_tpu.distributed.sharding import validate_tp as ref_validate_tp
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.distributed import mesh as tmesh
from paddle_tpu_torch.distributed.sharding import ShardingError, validate_tp
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import serve
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state
from paddle_tpu_torch.obs import flight
from paddle_tpu_torch.ops import flash_attention as tfa

ENGINE = dict(slots=3, max_len=64, prefill_buckets=[8, 32], queue_depth=16,
              seed=0, paged=True, page_size=8)
TPS = [2, 4]


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


@pytest.fixture(scope="module")
def state():
    """The reference tiny Llama's weights as numpy (the reference test's
    seed)."""
    np.random.seed(1234)
    paddle.seed(1234)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    return {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}


def _port_model(state, tp):
    cfg = tllama.LlamaConfig.tiny(tensor_parallel_degree=tp)
    return load_reference_state(tllama.LlamaForCausalLM(cfg, device="cpu"), state)


def _port(model, tp, **kw):
    return ContinuousBatchingEngine(model, device="cpu", tp=tp,
                                    devices=["cpu"] * tp, **{**ENGINE, **kw})


@pytest.fixture(scope="module")
def engines(state):
    """The reference's tp-4 engine and the port's tp-2 and tp-4 engines,
    spec_k 3, each warmed, with its compile counts after warmup."""
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny(tensor_parallel_degree=4))
    jm.set_state_dict(state)
    ref = JaxEngine(jm, spec_k=3, tp=4, **ENGINE)
    ref.warmup()
    out = {"ref": ref}
    for tp in TPS:
        eng = _port(_port_model(state, tp), tp, spec_k=3)
        eng.warmup()
        out[tp] = (eng, dict(eng.compile_counts()))
    return out


def _run(engine, prompts, max_new_tokens=16):
    rs = [engine.submit(p, max_new_tokens=max_new_tokens) for p in prompts]
    engine.run_until_idle()
    return [r.wait(1).tolist() for r in rs]


MIXED = [_prompt(6, seed=3), _cycle_prompt(20), _cycle_prompt(20)]


@pytest.fixture(scope="module")
def ref_mixed(engines):
    """The reference's tokens and speculation counters on the mixed
    traffic: the third prompt hits the second's committed pages."""
    jprofiler.reset_speculation()
    return _run(engines["ref"], MIXED), jprofiler.speculation_summary()


# ---------------------------------------------------------------------------
# tokens, speculation, restart
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tp", TPS)
def test_tp_greedy_identical_to_reference_on_mixed_traffic(engines, ref_mixed, tp):
    eng, warm = engines[tp]
    before = profiler.paging_summary().get("prefix_hits", 0)
    profiler.reset_speculation()
    assert _run(eng, MIXED) == ref_mixed[0]
    # the layout costs no executable: the warm budget holds under traffic
    assert dict(eng.compile_counts()) == warm
    assert warm["decode"] == 1 and warm["verify"] == 1
    assert profiler.paging_summary()["prefix_hits"] > before  # the third prompt
    got = profiler.speculation_summary()
    for key in ("steps", "proposed", "accepted", "emitted"):
        assert got[key] == ref_mixed[1][key], key


@pytest.mark.parametrize("tp", TPS)
def test_tp_spec_acceptance_matches_reference(engines, tp):
    eng, _ = engines[tp]
    p = _cycle_prompt(24, period=4, seed=11)
    jprofiler.reset_speculation()
    (want,) = _run(engines["ref"], [p], max_new_tokens=24)
    ref_spec = jprofiler.speculation_summary()
    profiler.reset_speculation()
    (got,) = _run(eng, [p], max_new_tokens=24)
    assert got == want
    spec = profiler.speculation_summary()
    assert spec["accepted"] == ref_spec["accepted"] > 0
    assert spec["proposed"] == ref_spec["proposed"]


def test_tp4_warm_restart_keeps_rank_arenas_and_graphs(engines):
    eng, warm = engines[4]
    p = _cycle_prompt(20, seed=5)
    (before,) = _run(eng, [p])
    ptrs = [[a.k.data_ptr() for a in ranks] for ranks in eng._arenas]
    eng.restart(reason="tp-test")
    assert dict(eng.compile_counts()) == warm
    (after,) = _run(eng, [p])
    assert after == before
    assert [[a.k.data_ptr() for a in ranks] for ranks in eng._arenas] == ptrs


def test_rank_arenas_split_the_kv_heads(engines):
    eng, _ = engines[4]
    assert len(eng._arenas) == 2 and all(len(r) == 4 for r in eng._arenas)
    a = eng._arenas[0]
    assert all(x.k.shape == (eng.pool_pages, 8, 1, 16) for x in a)
    # separate tensors, not views of one arena
    assert len({x.k.untyped_storage().data_ptr() for x in a}) == 4


def test_tp4_decode_step_runs_k2_once_per_rank_and_layer(engines, monkeypatch):
    """The per-shard launch structure the card's launch counts show: a
    spy on K2's wrapper counts its calls in one decode step (the CPU
    replay runs the step's body)."""
    eng, _ = engines[4]
    calls = []
    real = tfa.paged_decode_fused
    monkeypatch.setattr(tfa, "paged_decode_fused",
                        lambda q, *a, **k: calls.append(q.shape) or real(q, *a, **k))
    req = eng.submit(_prompt(5, seed=1), max_new_tokens=2)
    eng.step()  # admission + one decode step
    assert calls == [(3, 4, 1, 16)] * 8  # verify window k+1 = 4 rows, 2 layers x 4 ranks
    eng.run_until_idle()
    assert len(req.wait(1)) == 7


# ---------------------------------------------------------------------------
# the mesh in /healthz, /metrics and the flight header
# ---------------------------------------------------------------------------


def test_healthz_metrics_and_flight_header_carry_the_mesh(engines, tmp_path):
    eng, _ = engines[4]
    ref = engines["ref"].healthz()
    # the port's engines recorded the gauges last; the tp-4 one records again
    eng4 = _port(eng.model, 4)
    server = serve(eng4, port=0, block=False, supervise=False, handle_signals=False)
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}"
        h = json.loads(urllib.request.urlopen(url + "/healthz", timeout=10).read())
        text = urllib.request.urlopen(url + "/metrics", timeout=10).read().decode()
    finally:
        server.stop()
    for key in ("tp", "cp", "mesh_shape"):
        assert h[key] == ref[key], key
    assert h["mesh_shape"] == {"mp": 4}
    # `devices` counts the distinct devices in use (one CPU here, one card
    # on the chip machine); the reference counts every visible jax device
    want = {"paddle_mesh_devices": 1.0, "paddle_mesh_tp_degree": 4.0,
            "paddle_mesh_allreduce_per_step": 5.0}  # 2 layers x 2 + the gather
    for name, val in want.items():
        m = re.search(rf"^{name}{{[^}}]*}} (\S+)$", text, re.M)
        assert m and float(m.group(1)) == val, name
    path = flight.dump("tp-test", path=str(tmp_path / "f.jsonl"))
    with open(path) as f:
        header = json.loads(f.readline())
    # the keys the reference's code writes (its profiler's mesh gauges,
    # `cp` included), the port's device count
    ref_gauges = dict(jprofiler._mesh_gauges)
    assert set(header["mesh"]) == set(ref_gauges)
    assert header["mesh"] == dict(ref_gauges, devices=1)


def test_flags_serve_tp_reaches_the_engine(state):
    saved = tcore.flag("FLAGS_serve_tp")
    try:
        tcore.set_flags({"FLAGS_serve_tp": 2})
        eng = ContinuousBatchingEngine(_port_model(state, 2), device="cpu",
                                       devices=["cpu", "cpu"], **ENGINE)
        assert eng.tp == 2 and eng.healthz()["mesh_shape"] == {"mp": 2}
        # no device list: the visible CUDA devices, none on this machine
        with pytest.raises(ShardingError, match="needs 2 devices"):
            ContinuousBatchingEngine(_port_model(state, 2), device="cpu", **ENGINE)
    finally:
        tcore.set_flags({"FLAGS_serve_tp": saved})


# ---------------------------------------------------------------------------
# typed errors and refusals
# ---------------------------------------------------------------------------


def _cfg(heads, kv_heads):
    return types.SimpleNamespace(num_attention_heads=heads, num_key_value_heads=kv_heads)


@pytest.mark.parametrize("cfg,tp,devices,match", [
    pytest.param(_cfg(4, 4), 3, None, r"num_attention_heads \(4\).*3", id="heads"),
    pytest.param(_cfg(8, 4), 8, None, r"num_key_value_heads \(4\).*8", id="kv-heads"),
    pytest.param(_cfg(16, 16), 16, ["cpu"] * 8, "devices", id="too-few-devices"),
    pytest.param(_cfg(4, 4), 0, None, ">= 1", id="nonpositive"),
    pytest.param(_cfg(6, 6), 4, [], "num_attention_heads", id="heads-before-devices"),
])
def test_validate_tp_errors_match_reference(cfg, tp, devices, match):
    with pytest.raises(RefShardingError, match=match):
        ref_validate_tp(cfg, tp, devices=None if devices is None else [0] * len(devices))
    with pytest.raises(ShardingError, match=match):
        validate_tp(cfg, tp, devices=devices)
    assert issubclass(ShardingError, ValueError)
    validate_tp(cfg, 1)  # tp 1 needs nothing


def test_engine_rejects_unsharded_model_at_tp(state):
    plain = load_reference_state(
        tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu"), state)
    with pytest.raises(ShardingError, match="tensor_parallel_degree"):
        _port(plain, 4)


def test_ranks_on_distinct_devices_name_item_17():
    meta = torch.device("meta")
    with pytest.raises(NotImplementedError, match="item 17"):
        tmesh.serving_mesh(2, devices=["cpu", meta])
    saved = tmesh.get_mesh()
    try:
        mesh = tmesh.serving_mesh(2, devices=["cpu", "cpu"])
        assert tmesh.axis_size("mp") == 2 and mesh.devices == [torch.device("cpu")] * 2
        assert tmesh.axis_size("sep") == 1
    finally:
        tmesh.set_mesh(saved)


@pytest.mark.parametrize("kw,match", [
    pytest.param(dict(tp=1, cp=2), "item 17", id="cp-alone"),
])
def test_serving_mesh_keeps_the_cp_refusal(kw, match):
    """cp joins a serving mesh only beside tp > 1 (each rank's page shards,
    `test_torch_tp_cp.py`): cp alone raises naming item 17 (the
    context-parallel engine's page shards need no mesh) and installs
    nothing."""
    saved = tmesh.get_mesh()
    try:
        with pytest.raises(NotImplementedError, match=match):
            tmesh.serving_mesh(kw["tp"], cp=kw["cp"], devices=["cpu"] * kw["tp"])
        assert tmesh.get_mesh() is saved
    finally:
        tmesh.set_mesh(saved)
