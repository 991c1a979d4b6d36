"""The port's observability spine against the reference's on the CPU, unit
by unit, on the same inputs: `obs.trace` (flag gating, the bounded buffer,
`span`'s error marking, the tree and Chrome-trace shapes), `obs.flight`
(the ring, the armed-region gauge, the dump's format, name and
directory), the profiler's families (`reset()`, `metrics_snapshot()`) and
`obs.metrics.render` (the same `record_*` sequence fed to both packages'
profilers renders the same text, line for line, apart from the lines
listed in `_RENDER_EXCEPTIONS` with their reasons).

Then what the port adds: trace ids that leave the torch generator alone,
the kernels' per-trace dispatch counts under a StepGraph, the
`paddle_sanitizer_*` counters the port has, the watchdog's flight dump
and note of every arm, and the observable end of a monitor pass.
"""

import json
import os
import random
import re
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import profiler as jprof
from paddle_tpu.fault import injection as jinj
from paddle_tpu.obs import flight as jflight
from paddle_tpu.obs import metrics as jmetrics
from paddle_tpu.obs import trace as jtrace
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.fault import watchdog as twd
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.inference import graphs
from paddle_tpu_torch.obs import flight as tflight
from paddle_tpu_torch.obs import metrics as tmetrics
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.ops import flash_attention as tfa

# (trace module, flight module, profiler, set_flags) of each package
PACKAGES = {
    "reference": (jtrace, jflight, jprof, paddle.set_flags),
    "port": (ttrace, tflight, tprof, tcore.set_flags),
}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Recording on, both packages' buffers and profilers clean; flags put
    back afterwards."""
    for trace, flight, prof, set_flags in PACKAGES.values():
        set_flags({"FLAGS_trace": True, "FLAGS_obs_buffer_events": 4096})
        trace.reset()
        flight.reset()
        prof.reset()
    yield
    for trace, flight, prof, set_flags in PACKAGES.values():
        set_flags({"FLAGS_trace": False, "FLAGS_obs_buffer_events": 4096})
        trace.reset()
        flight.reset()
        prof.reset()


def _both(fn):
    """fn(trace, flight, prof, set_flags) on each package: (ref, port)."""
    return tuple(fn(*PACKAGES[k]) for k in ("reference", "port"))


# ---------------------------------------------------------------------------
# trace
# ---------------------------------------------------------------------------


def test_recording_gated_on_flag_minting_always_on():
    def run(trace, flight, prof, set_flags):
        set_flags({"FLAGS_trace": False})
        t0 = time.perf_counter()
        off = trace.record("x", trace.new_trace_id(), t0=t0, t1=t0 + 0.001)
        off_stats = trace.stats()["spans_recorded"]
        minted = len(trace.new_trace_id())
        set_flags({"FLAGS_trace": True})
        tid = trace.new_trace_id()
        sid = trace.record("x", tid, t0=t0, t1=t0 + 0.001)
        return (off, off_stats, minted, trace.stats()["spans_recorded"],
                len(sid), trace.spans(tid)[0]["dur_s"], trace.enabled())

    ref, port = _both(run)
    assert port == pytest.approx(ref)
    assert port[:5] == ("", 0, 16, 1, 16)


def test_span_buffer_bounded_by_flag():
    def run(trace, flight, prof, set_flags):
        set_flags({"FLAGS_obs_buffer_events": 32})
        tid = trace.new_trace_id()
        t0 = time.perf_counter()
        for i in range(100):
            trace.record("tick", tid, t0=t0, t1=t0, i=i)
        last = trace.spans(tid)[-1]["attrs"]["i"]
        set_flags({"FLAGS_obs_buffer_events": 8})  # below the floor of 16
        trace.record("tick", tid, t0=t0, t1=t0, i=100)
        return trace.stats(), last, len(trace.spans(tid))

    ref, port = _both(run)
    assert port == ref
    assert port[0]["spans_dropped"] == 100 - 32 + 1


def test_span_context_manager_marks_errors_tree_and_chrome_shapes():
    def shape(node):
        return (node["name"], node["status"], sorted(node),
                [shape(c) for c in node["children"]])

    def run(trace, flight, prof, set_flags):
        tid = trace.new_trace_id()
        with pytest.raises(ValueError):
            with trace.span("outer", tid, parent_id="c" * 16, who="unit") as s:
                with trace.span("inner", tid, parent_id=s.span_id):
                    pass
                s.attrs["seen"] = 3
                raise ValueError("boom")
        roots = trace.tree(tid)
        chrome = trace.chrome_trace(tid)
        events = sorted(((e["name"], e["ph"], sorted(e), sorted(e["args"]))
                         for e in chrome["traceEvents"]))
        return ([shape(r) for r in roots], roots[0]["attrs"],
                roots[0]["parent_id"], events, chrome["displayTimeUnit"],
                trace.trace_ids() == [tid])

    ref, port = _both(run)
    assert port == ref
    assert port[0][0][:2] == ("outer", "error")
    assert port[1] == {"who": "unit", "seen": 3}


def test_tree_roots_orphans_and_orders_children_by_start():
    def run(trace, flight, prof, set_flags):
        tid = trace.new_trace_id()
        root = trace.new_span_id()
        t = time.perf_counter()
        trace.record("c2", tid, t0=t + 2, t1=t + 3, parent_id=root)
        trace.record("c1", tid, t0=t + 1, t1=t + 2, parent_id=root)
        trace.record("orphan", tid, t0=t + 0.5, t1=t + 1, parent_id="f" * 16)
        trace.record("root", tid, t0=t, t1=t + 4, span_id=root)
        trace.record("other", trace.new_trace_id(), t0=t, t1=t)
        return [(r["name"], [c["name"] for c in r["children"]])
                for r in trace.tree(tid)], len(trace.tree("0" * 16))

    ref, port = _both(run)
    assert port == ref
    assert dict(port[0])["root"] == ["c1", "c2"]


def test_ctx_from_headers_matches_reference():
    for headers in (None, {}, {"X-Trace-Id": "ab" * 8},
                    {"X-Trace-Id": "ab" * 8, "X-Parent-Span": "cd" * 8},
                    {"X-Parent-Span": "cd" * 8}):
        assert ttrace.ctx_from_headers(headers) == jtrace.ctx_from_headers(headers)
    assert (ttrace.HDR_TRACE, ttrace.HDR_PARENT) == (jtrace.HDR_TRACE, jtrace.HDR_PARENT)


def test_trace_ids_leave_the_torch_generator_alone():
    """Ids come from os.urandom (or an explicit random.Random), never from
    torch's generator: the serving sampler's draws must not move."""
    state = torch.random.get_rng_state()
    ids = {ttrace.new_trace_id() for _ in range(64)}
    ids |= {ttrace.new_span_id() for _ in range(64)}
    assert torch.equal(torch.random.get_rng_state(), state)
    assert len(ids) == 128 and all(re.fullmatch("[0-9a-f]{16}", i) for i in ids)
    a = [ttrace.new_trace_id(random.Random(7)) for _ in range(2)]
    assert a[0] == a[1] and re.fullmatch("[0-9a-f]{16}", a[0])


# ---------------------------------------------------------------------------
# flight
# ---------------------------------------------------------------------------


def test_flight_ring_mirrors_fault_events_and_dumps_jsonl(tmp_path):
    def run(trace, flight, prof, set_flags):
        inj = jinj if flight is jflight else tinj
        before = flight.stats()["dumps_total"]  # monotonic across reset()
        inj.record_event("unit", "mirrored into the ring")
        flight.record("breaker", "r9 -> open: unit", fails=3, gone=None)
        flight.note_arm("serve.decode", "tick 7")
        kinds = [e["kind"] for e in flight.events()]
        path = flight.dump("unit test/1", path=None)
        lines = [json.loads(l) for l in open(path)]
        header, events = lines[0], lines[1:]
        name = os.path.basename(path)
        return (kinds, sorted(header), header["reason"], header["armed"]["serve.decode"]["context"],
                header["events"], [(e["kind"], e["detail"], e.get("fails"), "gone" in e)
                                   for e in events],
                flight.stats()["dumps_total"] - before, flight.last_dump_path() == path,
                re.sub(r"-\d+-\d{3}-", "-P-N-", name), flight.events(1)[0]["kind"])

    os.environ["PADDLE_OBS_DIR"] = str(tmp_path)
    try:
        ref, port = _both(run)
    finally:
        del os.environ["PADDLE_OBS_DIR"]
    assert port == ref
    assert port[0] == ["unit", "breaker"]  # the arm is a gauge, not an event
    assert port[8] == "flight-P-N-unit-test-1.jsonl"


def test_flight_ring_bounded_and_reset_keeps_the_dump_count(tmp_path):
    def run(trace, flight, prof, set_flags):
        set_flags({"FLAGS_obs_buffer_events": 16})
        for i in range(40):
            flight.record("tick", str(i))
        ring = [e["detail"] for e in flight.events()]
        flight.dump("a", path=str(tmp_path / f"{id(flight)}.jsonl"))
        dumps = flight.stats()["dumps_total"]
        flight.reset()
        return (ring, flight.events(), flight.last_dump_path(),
                flight.stats()["dumps_total"] == dumps,
                flight.stats()["events_buffered"])

    ref, port = _both(run)
    assert port == ref
    assert port[0] == [str(i) for i in range(24, 40)]


@pytest.mark.parametrize("env", [{"PADDLE_OBS_DIR": "/x/obs"},
                                 {"PADDLE_CKPT_DIR": "/x/ckpt/"},
                                 {"PADDLE_OBS_DIR": "/x/obs", "PADDLE_CKPT_DIR": "/y"},
                                 {}], ids=["obs", "ckpt", "both", "none"])
def test_flight_dump_dir_matches_reference(monkeypatch, env):
    monkeypatch.delenv("PADDLE_OBS_DIR", raising=False)
    monkeypatch.delenv("PADDLE_CKPT_DIR", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tflight.dump_dir() == jflight.dump_dir()


def test_only_request_terminal_spans_reach_the_ring():
    def run(trace, flight, prof, set_flags):
        tid = trace.new_trace_id()
        t0 = time.perf_counter()
        for name in ("serve.handle", "engine.decode", "engine.fetch",
                     "router.admit", "fit.window", "engine.queue"):
            trace.record(name, tid, t0=t0, t1=t0 + 0.0125, status="ok")
        return [(e["detail"], e["status"], e["dur_ms"], e["trace_id"] == tid)
                for e in flight.events() if e["kind"] == "span"]

    ref, port = _both(run)
    assert port == ref
    assert [d for d, *_ in port] == ["serve.handle", "router.admit", "fit.window"]


def test_flight_dump_never_raises():
    assert tflight.dump("x", path="/nonexistent/dir/f.jsonl") is None
    tflight.record("bad", object())  # str() of anything; never raises
    assert tflight.events()[-1]["kind"] == "bad"


# ---------------------------------------------------------------------------
# profiler families
# ---------------------------------------------------------------------------


def _feed(prof, port):
    """The same record_* sequence into either profiler (the serving request
    takes the reference's wall time; the port keeps none)."""
    prof.record_step(dispatch_s=0.25, host_blocked_s=0.125, inflight=3, wall_s=0.5)
    prof.record_step(dispatch_s=0.25, host_blocked_s=0.0, inflight=1, wall_s=0.375)
    for ttft, tok in ((0.01, 4), (0.03, 7), (0.02, 5)):
        if port:
            prof.record_serving_request(ttft, tok)
        else:
            prof.record_serving_request(ttft, tok, 0.5)
    prof.record_serving_tick(0.5, 2, 0.125)
    prof.record_serving_tick(0.75, 1, 0.0625)
    prof.record_serving_fault("restarts")
    prof.record_serving_fault("deadline_miss", 2)
    prof.record_serving_fault("a new kind")
    prof.record_deadline_miss_rate(0.1875)
    prof.record_prefix_lookup(True, tokens_saved=12, cow_copies=1)
    prof.record_prefix_lookup(False)
    prof.record_paging_event("cache_commits", 3)
    prof.record_paging_event("cache_evictions")
    prof.record_paging_tick(5, 40)
    prof.record_paging_tick(9, 40)
    prof.record_kv_quant("int8", 1 << 20, 1 << 14)
    prof.record_kv_quant_event("quantize", 6)
    prof.record_kv_quant_event("dequantize", 10)
    prof.record_speculation(8, 5, 9, 4)
    prof.record_mesh_topology(1, 1, 32, cp=2)
    prof.record_lora_event("loads", 2)
    prof.record_lora_event("residency_hits", 3)
    prof.record_lora_residency(2, 4)
    prof.record_router_event("idem_hits")
    prof.record_router_event("idem_joins", 2)
    prof.record_autoscale_event("ticks", 5)
    prof.record_autoscale_event("scale_ups")
    prof.record_autoscale_replicas(3)
    prof.record_autoscale_replicas(2)
    prof.record_disagg_event("exports")
    prof.record_disagg_event("handoff_bytes", 4096)
    prof.record_session_stats({"sessions_resident": 2, "session_pages_pinned": 6,
                               "session_binds_total": 3, "ignored": 9})
    prof.record_flash_fallback("head_dim > 256")
    prof.record_flash_fallback("head_dim > 256")
    prof.record_flash_pallas_call("flash_fwd")
    prof.record_flash_pallas_call("paged_decode_fused_cp")


# families of metrics_snapshot() the port's path fills or renders
FAMILIES = ("step", "serving", "paging", "speculation", "lora", "router",
            "autoscale", "disagg", "mesh", "kv_quant", "sessions",
            "flash_fallbacks", "flash_pallas")


def _comparable(family, ref, port):
    """The serving family keeps the port's own extra keys (the decode
    window, host fetches); the router family holds only the front door's
    counters the port has (the idempotency cache's) and the replica states,
    the reference's other router counters render as 0 (`g.get(key, 0)`)."""
    if family == "serving":
        port = {k: v for k, v in port.items()
                if k not in ("window_t0", "window_t1", "host_fetches")}
    if family == "router":
        assert all(v == 0 for k, v in ref.items()
                   if k not in port and k != "replica_states")
        ref = {k: ref[k] for k in port}
    return ref, port


@pytest.mark.parametrize("family", FAMILIES)
def test_metrics_snapshot_family_matches_reference(family):
    """Each family's keys and values after the same records."""
    _feed(jprof, port=False)
    _feed(tprof, port=True)
    ref, port = _comparable(family, jprof.metrics_snapshot()[family],
                            tprof.metrics_snapshot()[family])
    assert port == ref


@pytest.mark.parametrize("family", FAMILIES)
def test_profiler_reset_zeroes_every_family(family):
    """reset() after records gives each family what a fresh reference
    profiler's reset gives it."""
    _feed(jprof, port=False)
    _feed(tprof, port=True)
    jprof.reset()
    tprof.reset()
    ref, port = jprof.metrics_snapshot()[family], tprof.metrics_snapshot()[family]
    if family == "serving":
        assert port["host_fetches"] == 0
        assert port["window_t0"] is None and port["window_t1"] is None
    ref, port = _comparable(family, ref, port)
    assert port == ref


def test_summaries_of_the_new_families_match_reference():
    _feed(jprof, port=False)
    _feed(tprof, port=True)
    for name in ("lora_summary", "autoscale_summary",
                 "disagg_summary", "session_summary", "flash_fallback_summary",
                 "flash_pallas_summary"):
        assert getattr(tprof, name)() == pytest.approx(getattr(jprof, name)()), name
    tprof.reset()
    jprof.reset()
    for name in ("lora_summary", "autoscale_summary", "disagg_summary",
                 "session_summary", "flash_fallback_summary", "flash_pallas_summary"):
        assert getattr(tprof, name)() == getattr(jprof, name)() == {}, name


def test_existing_summaries_keep_their_output():
    """The page-occupancy ticks feed /metrics only: paging_summary() keeps
    the keys it had."""
    tprof.record_prefix_lookup(True, tokens_saved=4)
    before = tprof.paging_summary()
    tprof.record_paging_tick(5, 40)
    assert tprof.paging_summary() == before
    assert sorted(tprof.router_summary()) == ["idem_hits", "idem_joins"]


# ---------------------------------------------------------------------------
# metrics.render
# ---------------------------------------------------------------------------

# lines of the two renders that differ on the same records, by metric name
# and line kind, each with its reason
_RENDER_EXCEPTIONS = {
    ("paddle_mesh_devices", "HELP"): "the port counts CUDA devices, not jax devices",
    ("paddle_mesh_allreduce_per_step", "HELP"):
        "the port merges cp partials with torch ops, not GSPMD all-reduces",
    ("paddle_flash_fallbacks_total", "HELP"):
        "the port falls back from its kernels to a plain path, not Pallas to XLA",
    ("paddle_flash_pallas_calls_total", "HELP"):
        "the port's dispatches are its CUDA kernels, counted per compiled shape",
    # the port has no sanitizer yet (ROADMAP Queue 1, slice 6): traces and
    # host_syncs read the port's StepGraph traces and token fetches, the
    # rest are 0; the reference's read its own sanitizer
    **{(f"paddle_sanitizer_{k}_total", "sample"): "the port's own counters"
       for k in ("traces", "host_syncs", "eager_misses", "unexpected_traces",
                 "unexpected_eager", "unexpected_syncs", "allowed_events")},
    # monotonic across flight.reset() in both packages: other tests' dumps
    # and events count
    ("paddle_flight_events_total", "sample"): "monotonic across flight.reset()",
    ("paddle_flight_dumps_total", "sample"): "monotonic across flight.reset()",
}


def _render_lines(text):
    out = {}
    for line in text.splitlines():
        if line.startswith("# "):
            kind, name = line.split()[1], line.split()[2]
        else:
            kind, name = "sample", re.split(r"[{ ]", line, maxsplit=1)[0]
        out.setdefault((name, kind), []).append(line)
    return out


def _render_both(labels):
    def run(trace, flight, prof, set_flags):
        _feed(prof, port=prof is tprof)
        tid = "ab" * 8
        t0 = time.perf_counter()
        for name in ("serve.handle", "engine.queue"):
            trace.record(name, tid, t0=t0, t1=t0)
        flight.record("unit", "event")
        mod = jmetrics if prof is jprof else tmetrics
        return mod.render(labels=labels), mod.CONTENT_TYPE

    return _both(run)


@pytest.mark.parametrize("labels", [None, {"replica": "127.0.0.1:8866"}],
                         ids=["bare", "replica"])
def test_render_matches_reference_line_for_line(labels):
    (ref, ref_ct), (port, port_ct) = _render_both(labels)
    assert port_ct == ref_ct
    ref_lines, port_lines = _render_lines(ref), _render_lines(port)
    assert list(port_lines) == list(ref_lines)  # names and line kinds, in order
    for key in ref_lines:
        if key in _RENDER_EXCEPTIONS:
            assert len(port_lines[key]) == len(ref_lines[key]), key
            continue
        assert port_lines[key] == ref_lines[key], key


def test_metric_names_are_the_reference_render_names():
    names = [l.split()[2] for l in jmetrics.render().splitlines()
             if l.startswith("# TYPE")]
    assert list(tmetrics.METRIC_NAMES) == names
    port = [l.split()[2] for l in tmetrics.render().splitlines()
            if l.startswith("# TYPE")]
    assert port == names


def test_render_zero_fills_kernels_reasons_and_fault_kinds():
    text = tmetrics.render(labels={"replica": "unit"})
    samples = dict(line.rsplit(" ", 1) for line in text.splitlines()
                   if not line.startswith("#"))
    for kern in tfa.PALLAS_KERNELS:
        assert samples[f'paddle_flash_pallas_calls_total{{kernel="{kern}",replica="unit"}}'] == "0"
    reasons = [k for k in samples if k.startswith("paddle_flash_fallbacks_total")]
    assert len(reasons) == 9 and all(samples[k] == "0" for k in reasons)
    for kind in tprof.SERVING_FAULT_KINDS:
        assert samples[f'paddle_serving_faults_total{{kind="{kind}",replica="unit"}}'] == "0"
    assert all(float(v) == float(v) for v in samples.values())  # every value parses


def test_sanitizer_counters_read_the_ports_traces_and_fetches():
    def sample(name):
        line = next(l for l in tmetrics.render().splitlines()
                    if l.startswith(name + " "))
        return int(line.split()[1])

    traces, syncs = sample("paddle_sanitizer_traces_total"), sample(
        "paddle_sanitizer_host_syncs_total")
    g = graphs.StepGraph("unit", lambda x: (x + 1,), "cpu", counters={})
    g(None, x=np.zeros(2, np.float32))
    g(None, x=np.ones(2, np.float32))  # a replay: no trace
    tprof.record_host_fetch(2)
    assert sample("paddle_sanitizer_traces_total") == traces + 1
    assert sample("paddle_sanitizer_host_syncs_total") == syncs + 2
    assert sample("paddle_sanitizer_unexpected_traces_total") == 0


def test_pallas_calls_count_once_per_trace_never_per_replay():
    """A StepGraph body that launches (here: counts a launch of) flash_fwd
    twice and K6 once, as a two-layer step would: a trace counts each
    launch site once, replays and compare_eager add nothing, while the
    launch counts add every replay."""
    counters = {"flash_fwd": 0, "dense_decode": 0}

    def body(x):
        for what in ("flash_fwd", "flash_fwd", "dense_decode"):
            counters[what] += 1
            tfa.pallas_calls[tfa._PALLAS_NAME.get(what, what)] += 1
        return (x * 2,)

    tfa.reset_pallas_calls()
    g = graphs.StepGraph("unit", body, "cpu", counters=counters)
    g(None, x=np.zeros(3, np.float32))
    assert tprof.flash_pallas_summary() == {"flash_fwd": 2, "decode": 1}
    for _ in range(3):
        g(None, x=np.ones(3, np.float32))
    g.compare_eager(None)
    assert tprof.flash_pallas_summary() == {"flash_fwd": 2, "decode": 1}
    assert counters == {"flash_fwd": 8, "dense_decode": 4}
    tprof.reset_flash_pallas()
    assert tprof.flash_pallas_summary() == {}


# ---------------------------------------------------------------------------
# the watchdog's hooks and the end of a monitor pass
# ---------------------------------------------------------------------------


@pytest.fixture
def _quiet_watchdog(capsys):
    yield
    capsys.readouterr()  # the stack dumps


def test_watchdog_trip_dumps_the_ring_and_every_arm_is_noted(tmp_path, monkeypatch,
                                                             _quiet_watchdog):
    monkeypatch.setenv("PADDLE_OBS_DIR", str(tmp_path))
    wd = twd.Watchdog()
    with wd.arm("unit.region", timeout=5.0, context="first"):
        pass
    assert not list(tmp_path.iterdir())  # an arm dumps nothing
    with pytest.raises(twd.WatchdogTimeout):
        with wd.arm("unit.region", timeout=0.05, context="second"):
            time.sleep(0.3)
    assert twd.wait_for_monitor(30)
    (path,) = tmp_path.glob("flight-*-watchdog-unit.region.jsonl")
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert lines[0]["reason"] == "watchdog-unit.region"
    assert lines[0]["armed"]["unit.region"]["context"] == "second"
    assert any(e["kind"] == "watchdog" and "unit.region" in e["detail"]
               for e in lines[1:])
    assert not any(k == "serve.decode" for k in (e["kind"] for e in tflight.events()))


def test_wait_for_monitor_waits_for_the_action_and_is_bounded(_quiet_watchdog):
    release = threading.Event()
    fired = []

    def action(region, timeout):
        fired.append(region)
        release.wait(30)

    wd = twd.Watchdog(action=action)
    try:
        with wd.arm("unit.slow_action", timeout=0.02):
            t_end = time.monotonic() + 30
            while not fired and time.monotonic() < t_end:
                time.sleep(0.005)
        assert fired == ["unit.slow_action"]
        assert twd.wait_for_monitor(0.1) is False  # the action still runs
    finally:
        release.set()  # never leave the monitor blocked for later tests
    assert twd.wait_for_monitor(30) is True
    assert twd.wait_for_monitor(0) is True  # idle: at once


def test_a_raising_action_leaves_the_monitor_serving(_quiet_watchdog):
    def action(region, timeout):
        raise RuntimeError("broken action")

    bad, good = twd.Watchdog(action=action), twd.Watchdog()
    with bad.arm("unit.bad", timeout=0.02):
        time.sleep(0.2)
    assert twd.wait_for_monitor(30)
    with pytest.raises(twd.WatchdogTimeout):
        with good.arm("unit.good", timeout=0.02):
            time.sleep(0.2)
