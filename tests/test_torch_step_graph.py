"""`inference.graphs.StepGraph` on the CPU: the port's counterpart of the
reference's `StaticFunction` trace counting, and the plumbing its CUDA
graphs rely on.

- One trace per key; later calls with that key replay.
- The outputs are the same tensors on every call (the static outputs of a
  graph), so a caller that keeps one past the next call sees it change.
- Inputs a call does not name keep the values the last run left in the
  static buffers (the decode step advances its own).
- The launch-count delta of the trace is added on every replay, whatever
  the replayed body bumps itself (a CUDA replay runs no Python).
- Under a (simulated) capture a kernel wrapper refuses a host scalar, and
  the engine's steps pass none.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference.engine import ContinuousBatchingEngine
from paddle_tpu_torch.inference.graphs import StepGraph, new_pool
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.ops import flash_attention as pfa


def _doubler():
    runs = []

    def body(x):
        runs.append(tuple(x.shape))
        return (x * 2, x.sum(dim=0, keepdim=True))

    return StepGraph("double", body, "cpu"), runs


def test_one_trace_per_key():
    g, runs = _doubler()
    g(4, x=np.ones(4, np.float32))
    g(4, x=np.full(4, 3.0, np.float32))
    g(8, x=np.zeros(8, np.float32))
    out, _ = g(4, x=np.arange(4, dtype=np.float32))
    assert g.trace_count == 2 and g.replay_count == 2
    assert g.last_key == 4
    assert runs == [(4,), (4,), (8,), (4,)]  # the CPU runs the body each call
    assert torch.equal(out, torch.arange(4, dtype=torch.float32) * 2)
    assert new_pool("cpu") is None


def test_replays_reuse_the_same_output_storage():
    g, _ = _doubler()
    first, total = g(None, x=np.ones(4, np.float32))
    ptrs = (first.data_ptr(), total.data_ptr())
    kept = first.clone()
    second, total2 = g(None, x=np.full(4, 5.0, np.float32))
    assert second is first and total2 is total
    assert (second.data_ptr(), total2.data_ptr()) == ptrs
    # the tensor from the first call now holds the second call's result:
    # what a caller keeps past the next call, it copies
    assert torch.equal(first, torch.full((4,), 10.0))
    assert torch.equal(kept, torch.full((4,), 2.0))
    assert float(total) == 20.0


def test_unnamed_inputs_keep_what_the_last_run_left():
    def body(toks, pos):
        nxt = toks + 1
        toks.copy_(nxt)  # the decode step writes its next tokens back
        pos.add_(1)
        return (nxt,)

    g = StepGraph("loop", body, "cpu")
    g(None, toks=np.zeros(3, np.int32), pos=np.array([5, 6, 7], np.int32))
    for _ in range(3):
        out, = g(None)
    assert out.tolist() == [4, 4, 4]
    assert g.inputs(None)["pos"].tolist() == [9, 10, 11]
    g(None, pos=np.zeros(3, np.int32))  # a reload names what it changes
    assert g.inputs(None)["pos"].tolist() == [1, 1, 1]
    assert g.inputs(None)["toks"].tolist() == [5, 5, 5]
    with pytest.raises(ValueError, match="static buffer"):
        g(None, toks=np.zeros(4, np.int32))
    with pytest.raises(ValueError, match="static buffer"):
        g(None, toks=np.zeros(3, np.int64))
    with pytest.raises(KeyError, match="static input"):
        g(None, temps=np.zeros(3, np.float32))


def test_trace_delta_is_added_on_every_replay():
    counts = {"flash_fwd": 0, "paged_decode_fused": 0}
    calls = []

    def body(x):
        calls.append(1)
        if len(calls) == 1:  # only the trace's run launches in Python
            counts["paged_decode_fused"] += 2
            counts["flash_fwd"] += 1
        return (x + 1,)

    g = StepGraph("counted", body, "cpu", counters=counts)
    g(None, x=np.zeros(2, np.float32))
    assert counts == {"flash_fwd": 1, "paged_decode_fused": 2}
    for _ in range(3):
        g(None)
    assert len(calls) == 4
    assert counts == {"flash_fwd": 4, "paged_decode_fused": 8}


def test_a_body_bumping_its_own_counts_is_not_counted_twice():
    counts = {"k": 0}

    def body(x):
        counts["k"] += 3
        return (x,)

    g = StepGraph("bumps", body, "cpu", counters=counts)
    for _ in range(4):
        g(None, x=np.zeros(1, np.float32))
    assert counts["k"] == 12  # 3 per run: the trace's, then the delta


def test_compare_eager_restores_the_inputs_and_the_counts():
    counts = {"k": 0}

    def body(pos):
        counts["k"] += 1
        out = pos * 10
        pos.add_(1)
        return (out,)

    g = StepGraph("cmp", body, "cpu", counters=counts)
    g(None, pos=np.array([1, 2], np.int32))
    replayed, eager = g.compare_eager(None)
    assert torch.equal(replayed[0], eager[0])
    assert replayed[0].tolist() == [20, 30]
    assert g.inputs(None)["pos"].tolist() == [2, 3]
    assert counts["k"] == 1


def test_body_must_return_a_tuple_of_tensors():
    g = StepGraph("bad", lambda x: x, "cpu")
    with pytest.raises(TypeError, match="tuple of tensors"):
        g(None, x=np.zeros(1, np.float32))


@pytest.fixture
def simulated_capture(monkeypatch):
    monkeypatch.setattr(pfa, "capturing", lambda: True)


def _paged_operands(b=2, sq=1, h=4, hk=2, d=16, pages=5, ps=8, P=2):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=g)
    ak = torch.randn(pages, ps, hk, d, generator=g)
    av = torch.randn(pages, ps, hk, d, generator=g)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)[:b, :P]
    return q, ak, av, tables


def test_wrappers_refuse_a_host_scalar_under_capture(simulated_capture):
    q, ak, av, tables = _paged_operands()
    with pytest.raises(ValueError, match="host value"):
        pfa.paged_decode_fused(q, ak, av, tables, 5, 16)
    with pytest.raises(ValueError, match="host value"):
        pfa.paged_decode_fused_q8(
            q, ak.to(torch.int8), av.to(torch.int8),
            torch.ones(5, 8, 2, 1), torch.ones(5, 8, 2, 1), tables, 5, 16)
    with pytest.raises(ValueError, match="host value"):
        pfa.paged_decode_cp(q, ak[:4], av[:4], tables[:, :2] % 4, 3, 16, cp=2)
    kv = torch.randn(2, 128, 2, 16)
    with pytest.raises(ValueError, match="host value"):
        pfa.dense_decode(torch.randn(2, 64, 4, 16), kv, kv, 0)
    # a tensor on the kernel's device passes
    pos = torch.tensor([5, 9], dtype=torch.int32)
    out = pfa.paged_decode_fused(q, ak, av, tables, pos, 16)
    assert out.shape == q.shape


def test_no_host_scalar_outside_a_capture():
    q, ak, av, tables = _paged_operands()
    out = pfa.paged_decode_fused(q, ak, av, tables, 5, 16)
    assert out.shape == q.shape


@pytest.mark.parametrize("kw", [dict(paged=True), dict(paged=True, cp=2),
                                dict(paged=True, spec_k=2, kv_quant="int8"),
                                dict(paged=False)],
                         ids=["paged", "cp2", "spec-int8", "dense"])
def test_engine_steps_pass_no_host_scalar(simulated_capture, kw):
    """Every step body of the engine, traced and replayed under a simulated
    capture: each wrapper on the path gets device tensors only."""
    cfg = LlamaConfig.tiny(num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device="cpu", seed=1)
    eng = ContinuousBatchingEngine(model, device="cpu", slots=2, max_len=64,
                                   page_size=8, prefill_buckets=[8, 16],
                                   prefix_cache=kw.get("paged", True), **kw)
    eng.warmup()
    shared = np.arange(1, 13, dtype=np.int32)
    first = eng.submit(np.concatenate([shared, [40, 41]]), max_new_tokens=3)
    eng.run_until_idle()
    reqs = [eng.submit(np.concatenate([shared, [50 + i] * (i + 1)]),
                       max_new_tokens=4) for i in range(3)]
    eng.run_until_idle()
    assert all(len(r.wait(1)) == r.prompt.size + 4 for r in reqs)
    assert len(first.wait(1)) == 17
    assert eng.compile_counts()["decode"] == 1
