"""The reference's serving knobs: each is accepted where the reference
accepts it, and one the port does not run yet refuses with the reference's
error or a NotImplementedError naming its ROADMAP Queue 1 item.

- `ContinuousBatchingEngine(session_max=)` and `FLAGS_serve_session_max`
  (reference engine.py:590): the bound is read at construction and bounds
  the resident sessions (the least recently used one goes).
- `submit(export_kv=True)` (reference engine.py:1078) lands the request's
  handoff payload in `kv_export` at its finish; False, the default, leaves
  it None.
- `FLAGS_serve_role`, `FLAGS_serve_reserve_ttl_s`,
  `FLAGS_serve_lora_capacity` and `FLAGS_serve_lora_rank_max` exist with the
  reference's defaults, so `set_flags` takes them.  With `role=None` the
  engine reads `FLAGS_serve_role`: a paged engine serves in that role, the
  dense pool refuses a disaggregated one as `role=` does.  The LoRA flags
  set the capacity and `rank_max` of an `AdapterArena` built without them,
  and do nothing to an engine without `lora=`.
"""

import numpy as np
import pytest

from paddle_tpu.framework import core as jcore
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.models import llama as tllama

ENGINE = dict(slots=2, max_len=32, prefill_buckets=[8, 16], queue_depth=4,
              seed=0, page_size=8)
FLAGS = ("FLAGS_serve_session_max", "FLAGS_serve_role",
         "FLAGS_serve_reserve_ttl_s", "FLAGS_serve_lora_capacity",
         "FLAGS_serve_lora_rank_max")


@pytest.fixture(scope="module")
def model():
    return tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu", seed=0)


@pytest.fixture
def flags():
    """Set port flags for one test; the old values come back after."""
    saved = {name: tcore.flag(name) for name in FLAGS}
    yield lambda **kw: tcore.set_flags({f"FLAGS_serve_{k}": v for k, v in kw.items()})
    tcore.set_flags(saved)


def _engine(model, **kw):
    return ContinuousBatchingEngine(model, device="cpu", **{**ENGINE, **kw})


def _prompt(n=5):
    return np.arange(1, n + 1, dtype=np.int32)


@pytest.mark.parametrize("name", FLAGS)
def test_flags_exist_with_the_reference_defaults(name):
    assert tcore.flag(name) == jcore.flag(name)
    assert type(tcore.flag(name)) is type(jcore.flag(name))
    tcore.set_flags({name: tcore.flag(name)})  # no KeyError


def test_session_max_reads_the_flag_and_bounds_the_sessions(model, flags):
    assert _engine(model).session_max == 256
    assert _engine(model, session_max=4).session_max == 4
    flags(session_max=2)
    eng = _engine(model)
    assert eng.session_max == 2 and eng._sessions.capacity == 2
    for i in range(3):
        req = eng.submit(_prompt(5 + i), max_new_tokens=2, session_id=f"chat-{i}")
        eng.run_until_idle()
        req.wait(1)
    stats = eng.healthz()["sessions"]
    assert stats["sessions_resident"] == 2 and stats["session_evictions_total"] == 1
    assert "chat-0" not in eng._sessions and "chat-2" in eng._sessions


def test_export_kv_true_raises_and_false_serves(model):
    """export_kv=True, ported: the payload lands at the finish and carries
    the prompt's rows of every layer and the first token."""
    eng = _engine(model)
    req = eng.submit(_prompt(), max_new_tokens=2, export_kv=True)
    eng.run_until_idle()
    assert len(req.wait(1)) == 7
    pay = req.kv_export
    assert pay["prompt_len"] == 5 and pay["first_token"] == req.tokens[0]
    assert pay["n_layers"] == model.config.num_hidden_layers
    assert pay["dtype"] == "float32" and pay["quant"] == "none"
    kvh, hd = model.config.num_key_value_heads, model.config.head_dim
    assert pay["payload_bytes"] == pay["n_layers"] * 2 * 5 * kvh * hd * 4
    req = eng.submit(_prompt(), max_new_tokens=2, export_kv=False)
    eng.run_until_idle()
    assert len(req.wait(1)) == 7 and req.kv_export is None


@pytest.mark.parametrize("paged", [True, False])
def test_role_flag_is_read_when_role_is_none(model, flags, paged):
    flags(role="colocated")
    assert _engine(model, paged=paged).role == "colocated"
    for role in ("prefill", "decode"):
        flags(role=role)
        if paged:  # the flag's role serves
            eng = _engine(model, paged=paged)
            assert eng.role == role and eng.healthz()["role"] == role
            assert ("import" in eng.compile_counts()) == (role == "decode")
            req = eng.submit(_prompt(), max_new_tokens=2)
            eng.run_until_idle()
            assert len(req.wait(1)) == 7
        else:  # the reference's refusal on the dense pool
            with pytest.raises(ValueError, match="requires the paged engine"):
                _engine(model, paged=paged)
    flags(role="bogus")
    with pytest.raises(ValueError, match="colocated|prefill|decode"):
        _engine(model, paged=paged)
    # an explicit role wins over the flag
    assert _engine(model, paged=paged, role="colocated").role == "colocated"


def test_lora_flags_set_a_default_arena(model, flags):
    from paddle_tpu_torch.lora import AdapterArena, AdapterRegistry, make_random

    flags(lora_capacity=2, lora_rank_max=16, reserve_ttl_s=5.0)
    eng = _engine(model)  # no arena: the flags change nothing
    req = eng.submit(_prompt(), max_new_tokens=3)
    eng.run_until_idle()
    assert len(req.wait(1)) == 8
    reg = AdapterRegistry(model.config)
    make_random(reg, "t1", rank=16, seed=1)
    arena = AdapterArena(reg, device="cpu")
    assert (arena.capacity, arena.rank_max) == (2, 16)
    eng = _engine(model, lora=arena)
    req = eng.submit(_prompt(), max_new_tokens=3, adapter="t1")
    eng.run_until_idle()
    assert len(req.wait(1)) == 8
    assert eng.healthz()["lora"]["capacity"] == 2


def test_a_replica_worker_with_tp_above_one_refuses(monkeypatch):
    """`serving.replica --tp 2` (reference replica.py:482-488) builds the
    tensor-parallel model and engine on the devices `--devices` names; with
    no list it takes the visible CUDA devices, each once, and refuses when
    there are too few (ShardingError, the reference's error on too few
    devices): ranks stack on one device only when the caller names it for
    each.  The worker's engine serves what a --tp 1 worker's serves."""
    from paddle_tpu_torch.distributed import mesh as tmesh
    from paddle_tpu_torch.distributed.sharding import ShardingError
    from paddle_tpu_torch import inference
    from paddle_tpu_torch.serving import replica

    with pytest.raises(ShardingError, match="needs 2 devices"):
        replica.main(["--port", "1", "--device", "cpu", "--tp", "2"])
    served = []
    monkeypatch.setattr(inference, "serve", lambda eng, **kw: served.append(eng))
    saved = tmesh.get_mesh()
    try:
        for argv in (["--tp", "1"], ["--tp", "2", "--devices", "cpu,cpu"]):
            assert replica.main(["--port", "1", "--device", "cpu", *argv]) == 0
    finally:
        tmesh.set_mesh(saved)
    one, two = served
    assert (one.tp, two.tp) == (1, 2)
    assert two.model.config.tensor_parallel_degree == 2
    assert two.healthz()["mesh_shape"] == {"mp": 2}
    outs = []
    for eng in served:
        req = eng.submit(_prompt(7), max_new_tokens=6)
        eng.run_until_idle()
        outs.append(req.wait(1).tolist())
    assert outs[0] == outs[1]


def test_an_autoscaler_spawn_at_tp_above_one_refuses():
    """With devices free and `tp_max` 2 the reference's `choose_tp` picks 2
    (autoscaler.py:433) and the spawn function gets that degree; the port's
    autoscaler takes `tp_max` and spawns as the reference's does, held here
    against the reference's `choose_tp` over the same free devices."""
    from paddle_tpu.serving.autoscaler import choose_tp as ref_choose_tp
    from paddle_tpu_torch.serving import Replica, Router
    from paddle_tpu_torch.serving.autoscaler import Autoscaler, choose_tp

    for free in range(0, 9):
        for tp_max in (1, 2, 4, 8):
            for kv in (None, 2, 4, 6):
                assert choose_tp(free, tp_max, kv) == ref_choose_tp(free, tp_max, kv)
    rep = Replica("r0", "http://127.0.0.1:9")
    rep._note_healthz({"status": "ready", "queue_depth": 9})
    spawned = []

    def build(tp_max):
        return Autoscaler(Router([rep], probe_interval=3600),
                          spawn_fn=lambda idx, tp: spawned.append(tp)
                          or Replica(f"as{idx}", "http://127.0.0.1:9"),
                          min_replicas=1, max_replicas=3, up_ticks=1, tp_max=tp_max,
                          devices_total=4, interval=3600)

    asc = build(2)  # 3 of 4 devices free: a tp-2 spawn
    assert asc.tick(now=10.0)["action"] == "up"
    assert spawned == [ref_choose_tp(3, 2)] == [2]
    asc = build(1)  # a tp-1 spawn goes ahead
    assert asc.tick(now=10.0)["action"] == "up" and spawned == [2, 1]
