"""The port's disaggregated prefill/decode (the KV handoff's wire format,
prefill- and decode-role engines, page reservations) against the JAX
package on the CPU.

- Wire format: the port's `serialize_kv_handoff` of the same rows gives the
  reference's dict, for none/int8 and float32/bfloat16 (numpy rows, and the
  port's torch rows); each side's payload deserializes through the other's
  function to the same bits; every typed rejection of the reference's
  `test_handoff_wire_typed_rejection` raises `HandoffFormatError`.
- Engines: prefill export -> `reserve_pages` -> decode import, twice, equal
  to the reference engine's tokens on shared weights, with `compile_counts`
  frozen on both sides after warmup and "import" on the decode role only;
  the same over int8 pages against a colocated int8 engine, with
  `handoff_bytes` under 0.75 of the float32 row bytes.
- Across the packages: the reference prefill engine's export, through JSON,
  imports into the port's decode engine and continues to the reference's
  tokens; the port's export reads back through the reference's
  `deserialize_kv_handoff` within 1e-5 + 1e-5 |ref| of the reference's own
  export.
- Reservations step for step as the reference's
  `test_reservations_gate_admission_and_expire`; the role and handoff
  refusals; a restart during an import and `fail_all` with a queued
  handoff leave no mapped page and no reservation behind.

Tiny Llamas in float32, page_size 8.
"""

import json
import threading
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.inference import paging as jpaging
from paddle_tpu.inference.engine import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.models import llama as jllama
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import paging as tpaging
from paddle_tpu_torch.inference.engine import (
    ContinuousBatchingEngine,
    EngineRestarted,
    QueueFull,
)
from paddle_tpu_torch.models import llama as tllama
from paddle_tpu_torch.models.convert import load_reference_state

ENGINE = dict(slots=2, max_len=64, prefill_buckets=[8, 16], queue_depth=16,
              seed=0, paged=True, page_size=8)


def _prompt(n, seed=0):
    return np.random.RandomState(seed).randint(1, 250, size=n).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _rng_neutral():
    """Building the JAX model draws from paddle_tpu's global generator;
    restore it so later modules see the stream as if this one never ran."""
    state = paddle.get_rng_state()
    yield
    paddle.set_rng_state(state)


@pytest.fixture(autouse=True)
def _clean():
    profiler.reset_disagg()
    yield
    tcore.set_flags({"FLAGS_serve_reserve_ttl_s": 30.0,
                     "FLAGS_serve_debug_invariants": False})


@pytest.fixture(scope="module")
def models():
    paddle.seed(49)
    jm = jllama.LlamaForCausalLM(jllama.LlamaConfig.tiny())
    state = {k: np.asarray(v.numpy()) for k, v in jm.state_dict().items()}
    tm = tllama.LlamaForCausalLM(tllama.LlamaConfig.tiny(), device="cpu")
    return jm, load_reference_state(tm, state)


def _engine(tm, role="colocated", **kw):
    return ContinuousBatchingEngine(tm, device="cpu", role=role, **{**ENGINE, **kw})


def _run(eng, *a, **kw):
    req = eng.submit(*a, **kw)
    eng.run_until_idle()
    return req


# ---------------------------------------------------------------------------
# the wire format
# ---------------------------------------------------------------------------


def _fake_layers(L=5, kvh=4, hd=16, n_layers=2, quant="none", dtype=np.float32):
    """The reference test's rows (`_fake_layers`), in `dtype`."""
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n_layers):
        if quant == "int8":
            ly = {n: rng.randint(-128, 128, size=(L, kvh, hd)).astype(np.int8)
                  for n in ("k", "v")}
            ly.update({n: rng.rand(L, kvh, 1).astype(np.float32)
                       for n in ("k_scale", "v_scale")})
        else:
            ly = {n: rng.randn(L, kvh, hd).astype(dtype) for n in ("k", "v")}
        out.append(ly)
    return out


def _torch_rows(layers):
    """The same rows as host torch tensors (bfloat16 through its bits)."""
    out = []
    for ly in layers:
        d = {}
        for n, a in ly.items():
            if a.dtype == ml_dtypes.bfloat16:
                d[n] = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
            else:
                d[n] = torch.from_numpy(a.copy())
        out.append(d)
    return out


def _bits(x):
    """The raw bytes of a numpy array or a torch tensor."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16) if x.dtype in (torch.bfloat16, torch.float16)
             else x).numpy()
    return np.ascontiguousarray(x).tobytes()


WIRE = [("none", "float32"), ("int8", "float32"), ("none", "bfloat16"),
        ("int8", "bfloat16")]


@pytest.mark.parametrize("quant,dtype", WIRE, ids=[f"{q}-{d}" for q, d in WIRE])
def test_wire_dict_equals_the_reference(quant, dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    layers = _fake_layers(quant=quant, dtype=np_dtype)
    ref = jpaging.serialize_kv_handoff(layers, 5, quant, dtype)
    assert tpaging.serialize_kv_handoff(layers, 5, quant, dtype) == ref
    assert tpaging.serialize_kv_handoff(_torch_rows(layers), 5, quant, dtype) == ref
    assert json.loads(json.dumps(ref)) == ref


@pytest.mark.parametrize("quant,dtype", WIRE, ids=[f"{q}-{d}" for q, d in WIRE])
def test_wire_payloads_cross_both_ways_bit_for_bit(quant, dtype):
    np_dtype = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    layers = _fake_layers(quant=quant, dtype=np_dtype)
    geo = (quant, 4, 16, 2, dtype)
    ref_pay = json.loads(json.dumps(jpaging.serialize_kv_handoff(layers, 5, quant, dtype)))
    port_pay = json.loads(json.dumps(
        tpaging.serialize_kv_handoff(_torch_rows(layers), 5, quant, dtype)))
    got_port, L1 = tpaging.deserialize_kv_handoff(ref_pay, *geo)
    got_ref, L2 = jpaging.deserialize_kv_handoff(port_pay, *geo)
    assert L1 == L2 == 5
    for want, a, b in zip(layers, got_port, got_ref):
        assert sorted(a) == sorted(b) == sorted(want)
        for n in want:
            assert tuple(a[n].shape) == b[n].shape == want[n].shape
            assert _bits(a[n]) == _bits(b[n]) == _bits(want[n])
            assert str(a[n].dtype).replace("torch.", "") == str(want[n].dtype)


def _reject(mutate, **kw):
    pay = jpaging.serialize_kv_handoff(_fake_layers(), 5, "none", "float32")
    bad = json.loads(json.dumps(pay))
    mutate(bad)
    with pytest.raises(tpaging.HandoffFormatError):
        tpaging.deserialize_kv_handoff(
            bad, kw.get("quant", "none"), kw.get("kvh", 4), kw.get("hd", 16),
            kw.get("n_layers", 2), "float32")


REJECTIONS = {
    "version": (lambda b: b.update(version=jpaging.HANDOFF_VERSION + 1), {}),
    "quant": (lambda b: None, {"quant": "int8"}),
    "kv_heads": (lambda b: None, {"kvh": 8}),
    "n_layers": (lambda b: None, {"n_layers": 3}),
    "prompt_len": (lambda b: b.update(prompt_len=0), {}),
    "layer-count": (lambda b: b["layers"].pop(), {}),
    "truncated-row": (lambda b: b["layers"][0].update(k=b["layers"][0]["k"][:-8]), {}),
}


@pytest.mark.parametrize("case", list(REJECTIONS))
def test_wire_typed_rejection_as_the_reference(case):
    mutate, kw = REJECTIONS[case]
    _reject(mutate, **kw)


def test_wire_rejects_a_non_dict_and_an_empty_export():
    with pytest.raises(tpaging.HandoffFormatError):
        tpaging.deserialize_kv_handoff("nope", "none", 4, 16, 2, "float32")
    with pytest.raises(tpaging.HandoffFormatError):
        tpaging.serialize_kv_handoff([], 5, "none", "float32")
    assert issubclass(tpaging.HandoffFormatError, ValueError)


# ---------------------------------------------------------------------------
# engines: export -> reserve -> import
# ---------------------------------------------------------------------------


def _handoff_passes(pre, dec, ref_fn):
    """The reference's `_handoff_passes` (test_disagg_serving.py:204): two
    export -> reserve -> import passes, each against `ref_fn`'s tokens."""
    for i, n_new in ((0, 8), (1, 6)):
        p = _prompt(11 + 3 * i, seed=40 + i)
        ref = ref_fn(p, n_new)
        h = _run(pre, p, max_new_tokens=1, export_kv=True)
        h.wait(1)
        pay = h.kv_export
        assert pay is not None and pay["prompt_len"] == len(p)
        assert pay["first_token"] == int(ref[len(p)])
        rsv = dec.reserve_pages(len(p), n_new)
        assert dec.healthz()["reserved_pages"] == rsv["pages"] > 0
        pay = json.loads(json.dumps(pay))
        got = _run(dec, p, max_new_tokens=n_new, handoff=pay,
                   reservation=rsv["reservation"]).wait(1)
        assert np.array_equal(got, ref)
        assert dec.healthz()["reserved_pages"] == 0  # consumed at admission


def test_handoff_equals_the_reference_engine_with_frozen_compiles(models):
    jm, tm = models
    jeng = JaxEngine(jm, **ENGINE)
    pre, dec = _engine(tm, "prefill").warmup(), _engine(tm, "decode").warmup()
    assert "import" in dec.compile_counts() and "import" not in pre.compile_counts()
    warm = {e: e.compile_counts() for e in (pre, dec)}
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    _handoff_passes(pre, dec, lambda p, n: jeng.generate(p, max_new_tokens=n))
    for e in (pre, dec):
        assert e.compile_counts() == warm[e]
    g = profiler.disagg_summary()
    assert g["exports"] == 2 and g["imports"] == 2
    assert g["import_pages"] == 2 + 2  # 11 and 14 rows of pages of 8
    assert g["handoff_bytes"] == sum(2 * 2 * L * 4 * 16 * 4 for L in (11, 14))


def test_handoff_over_int8_pages_equals_a_colocated_int8_engine(models):
    _, tm = models
    co, pre, dec = (_engine(tm, role, kv_quant="int8").warmup()
                    for role in ("colocated", "prefill", "decode"))
    assert "import" in dec.compile_counts()
    assert "import" not in co.compile_counts()
    warm = {e: e.compile_counts() for e in (co, pre, dec)}
    _handoff_passes(pre, dec, lambda p, n: _run(co, p, max_new_tokens=n).wait(1))
    for e in (co, pre, dec):
        assert e.compile_counts() == warm[e]
    g = profiler.disagg_summary()
    assert g["exports"] == 2 and g["imports"] == 2
    f32_rows = 2 * 2 * (11 * 4 * 16 * 4 + 14 * 4 * 16 * 4)
    assert 0 < g["handoff_bytes"] < 0.75 * f32_rows


def test_a_reference_export_continues_on_the_port(models):
    """A prefill worker of the JAX package hands its KV to a decode worker
    of the port, through JSON: the tokens are the reference colocated
    engine's."""
    jm, tm = models
    jco = JaxEngine(jm, **ENGINE)
    jpre = JaxEngine(jm, role="prefill", **ENGINE)
    dec = _engine(tm, "decode").warmup()
    for p, n in ((_prompt(13, 50), 7), (_prompt(9, 51), 5)):
        ref = jco.generate(p, max_new_tokens=n)
        h = jpre.submit(p, max_new_tokens=1, export_kv=True)
        jpre.run_until_idle()
        h.wait(60)
        pay = json.loads(json.dumps(h.kv_export))
        got = _run(dec, p, max_new_tokens=n, handoff=pay).wait(1)
        assert np.array_equal(got, ref)


def test_the_port_export_reads_back_through_the_reference(models):
    jm, tm = models
    jpre = JaxEngine(jm, role="prefill", **ENGINE)
    pre = _engine(tm, "prefill")
    p = _prompt(13, 52)
    h = jpre.submit(p, max_new_tokens=1, export_kv=True)
    jpre.run_until_idle()
    h.wait(60)
    ref = json.loads(json.dumps(h.kv_export))
    port = json.loads(json.dumps(_run(pre, p, max_new_tokens=1,
                                      export_kv=True).kv_export))
    meta = [k for k in ref if k != "layers"]
    assert sorted(port) == sorted(ref)
    assert {k: port[k] for k in meta} == {k: ref[k] for k in meta}
    cfg = tm.config
    geo = ("none", cfg.num_key_value_heads, cfg.head_dim, cfg.num_hidden_layers,
           "float32")
    got, L = jpaging.deserialize_kv_handoff(port, *geo)
    want, _ = jpaging.deserialize_kv_handoff(ref, *geo)
    assert L == 13
    for a, b in zip(got, want):
        for n in ("k", "v"):
            # K carries RoPE, computed apart by each package: 1e-5 + 1e-5 |ref|
            assert np.all(np.abs(a[n] - b[n]) <= 1e-5 + 1e-5 * np.abs(b[n])), n


# ---------------------------------------------------------------------------
# reservations, refusals, restarts
# ---------------------------------------------------------------------------


def test_reservations_gate_admission_and_expire(models):
    """The reference's test, step for step."""
    _, tm = models
    dec = _engine(tm, "decode")
    with pytest.raises(QueueFull):
        for _ in range(100):
            dec.reserve_pages(56, 8)
    dec._reserved.clear()
    dec._reserved_pages = 0
    free0 = dec.healthz()["page_free_frac"]
    r = dec.reserve_pages(8, 8)
    assert dec.healthz()["page_free_frac"] < free0
    tcore.set_flags({"FLAGS_serve_reserve_ttl_s": 0.05})
    r2 = dec.reserve_pages(8, 8)
    assert r2["ttl_s"] == 0.05
    time.sleep(0.1)
    r3 = dec.reserve_pages(8, 8)  # purges r2 on entry
    assert dec._reserved_pages == r["pages"] + r3["pages"]
    assert r2["reservation"] not in dec._reserved


def test_reservations_hold_headroom_from_other_admissions(models):
    """A held reservation is headroom a plain request cannot take: it parks
    until the hold lapses at a scheduler tick."""
    _, tm = models
    dec = _engine(tm, "decode", pool_pages=9)  # 8 usable pages
    rsv = dec.reserve_pages(40, 8, ttl_s=0.2)  # 6 pages
    assert rsv["pages"] == 6 and dec.healthz()["page_free_frac"] == 0.25
    req = dec.submit(_prompt(20), max_new_tokens=4)  # needs 3
    dec.step()
    assert req.state == "queued" and dec.pending == 1
    time.sleep(0.25)
    dec.run_until_idle()
    assert len(req.wait(1)) == 24 and dec.healthz()["reserved_pages"] == 0


def test_role_and_handoff_validation(models):
    """The reference's test_role_and_handoff_validation, and cp=2 with a
    role."""
    _, tm = models
    with pytest.raises(ValueError, match="requires the paged engine"):
        _engine(tm, "prefill", paged=False)
    for role in ("colocated", "prefill"):
        with pytest.raises(ValueError, match="'decode' role"):
            _engine(tm, role).submit(_prompt(4), max_new_tokens=2,
                                     handoff={"version": 1})
    dense = _engine(tm, paged=False, prefill_buckets=[8], queue_depth=4)
    with pytest.raises(ValueError, match="export_kv requires the paged engine"):
        dense.submit(_prompt(4), max_new_tokens=2, export_kv=True)
    for role in ("prefill", "decode"):
        with pytest.raises(ValueError, match="cp=2 with role"):
            _engine(tm, role, cp=2)


def test_a_handoff_is_held_to_its_prompt_and_first_token(models):
    _, tm = models
    pre, dec = _engine(tm, "prefill"), _engine(tm, "decode")
    p = _prompt(10, 53)
    pay = _run(pre, p, max_new_tokens=1, export_kv=True).kv_export
    bad = [dict(pay, first_token=None), dict(pay, first_token=10 ** 6),
           dict(pay, dtype="bfloat16")]
    for b in bad:
        with pytest.raises(tpaging.HandoffFormatError):
            dec.submit(p, max_new_tokens=3, handoff=b)
    with pytest.raises(tpaging.HandoffFormatError, match="prompt length"):
        dec.submit(p[:-1], max_new_tokens=3, handoff=pay)
    with pytest.raises(ValueError, match="session_id"):
        dec.submit(p, max_new_tokens=3, handoff=pay, session_id="s")
    assert dec.pending == 0


def test_a_failed_export_leaves_none_and_releases_the_pages(models, monkeypatch):
    _, tm = models
    pre = _engine(tm, "prefill")
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})

    def broken(s, L):
        raise RuntimeError("export drill")

    monkeypatch.setattr(pre, "_export_rows_locked", broken)
    req = _run(pre, _prompt(10, 54), max_new_tokens=1, export_kv=True)
    assert len(req.wait(1)) == 11 and req.kv_export is None
    assert not any(pre._slot_pages) and profiler.disagg_summary() == {}


def test_a_restart_during_an_import_releases_its_pages_and_reimports(models):
    """The import body blocks while a restart fences the scheduler out: the
    woken thread lands nothing, the restart released the pages it mapped,
    and the requeued request imports again to the colocated tokens."""
    _, tm = models
    co, pre, dec = (_engine(tm, role) for role in ("colocated", "prefill", "decode"))
    p = _prompt(20, 55)
    ref = _run(co, p, max_new_tokens=6).wait(1)
    pay = _run(pre, p, max_new_tokens=1, export_kv=True).kv_export
    dec.warmup()
    body, entered, release = dec._import_g.body, threading.Event(), threading.Event()

    def held(**kw):
        if not entered.is_set():
            entered.set()
            release.wait(30)
        return body(**kw)

    dec._import_g.body = held
    tcore.set_flags({"FLAGS_serve_debug_invariants": True})
    rsv = dec.reserve_pages(len(p), 6)
    dec.start()
    try:
        req = dec.submit(p, max_new_tokens=6, handoff=pay,
                         reservation=rsv["reservation"])
        assert entered.wait(30)
        assert dec.healthz()["reserved_pages"] == 0  # consumed at admission
        dec.restart(reason="import drill")
        release.set()
        assert np.array_equal(req.wait(30), ref)
    finally:
        release.set()
        dec.stop()
    assert dec.restart_count == 1 and profiler.disagg_summary()["imports"] == 1
    # the page audit: every page's refcount equals its holds, so the first
    # admission's mapping went back to the pool
    dec._check_invariants()
    assert not any(dec._slot_pages) and dec._reserved_pages == 0


def test_fail_all_resolves_a_queued_handoff_and_its_reservation(models):
    _, tm = models
    pre, dec = _engine(tm, "prefill"), _engine(tm, "decode")
    p = _prompt(12, 56)
    pay = _run(pre, p, max_new_tokens=1, export_kv=True).kv_export
    rsv = dec.reserve_pages(len(p), 4)
    req = dec.submit(p, max_new_tokens=4, handoff=pay,
                     reservation=rsv["reservation"])
    assert dec.healthz()["reserved_pages"] == rsv["pages"]
    assert dec.fail_all("drill") == 1
    with pytest.raises(EngineRestarted):
        req.wait(1)
    assert dec._reserved_pages == 0 and not dec._reserved
    assert not any(dec._slot_pages)
