"""The port's control-plane journal and idempotency cache
(`paddle_tpu_torch.serving.journal`) against the JAX package's, and the
fleet's flags and fault points.

- A journal either package writes replays to the same folded state in
  the other, and its segments are the same bytes for the same records.
- Torn-tail repair, interior corruption, compaction (the state the same
  bit for bit before and after, on disk and live) and TTL pruning hold as
  in the reference, on the same journals.
- The idempotency cache with a journal: the same verdicts and the same
  journaled records; `restore` loads a replayed journal's completed
  responses, skipping expired and live keys.
- The 25 `FLAGS_router_*` / `FLAGS_autoscale_*` flags the fleet reads have
  the reference's defaults, and the fleet's seven fault points are
  registered with the reference's descriptions.
"""

import json
import os
import time

import pytest

from paddle_tpu import profiler as jprof
from paddle_tpu.fault import injection as jinj
from paddle_tpu.framework import core as jcore
from paddle_tpu.serving import journal as jjournal
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.serving import journal as tjournal

PACKAGES = {"reference": jjournal, "port": tjournal}


@pytest.fixture(autouse=True)
def _clean():
    jprof.reset_router()
    tprof.reset_router()
    yield
    jprof.reset_router()
    tprof.reset_router()


def _state_key(state):
    """Canonical bytes of a folded state, its seq left out (a compaction
    takes one)."""
    st = dict(state)
    st.pop("seq", None)
    return json.dumps(st, sort_keys=True)


def _write_history(mod, root, now, segment_records=3):
    """Every record kind, over several segments; returns the journal."""
    j = mod.Journal(root, segment_records=segment_records, ttl_s=30.0)
    for i in range(4):
        j.append("replica", op="register", rid=f"r{i}", url=f"http://u{i}")
    j.append("replica", op="deregister", rid="r3")
    j.append("replica", op="drain", rid="r1", draining=True)
    j.append("breaker", rid="r0", state="open", fails=3, open_until_wall=now + 60)
    j.append("breaker", rid="r2", state="closed", fails=0, open_until_wall=0.0)
    j.append("autoscale", band=[1, 3], last_action_wall=now - 5.0, up_streak=0,
             down_streak=2)
    j.append("idem_admit", key="live")
    j.append("idem_admit", key="done")
    j.append("idem_done", key="done", status=200, body={"tokens": [1, 2, 3]})
    j.append("idem_done", key="typed", status=404,
             body={"type": "AdapterUnknown", "retriable": False})
    j.append("idem_admit", key="shed")
    j.append("idem_drop", key="shed")
    j.append("takeover")
    j.append("a-kind-nobody-folds", x=1)
    return j


def _segments(root):
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root)) if name.endswith(".seg")}


@pytest.mark.parametrize("writer,reader", [("reference", "port"), ("port", "reference")])
def test_a_journal_replays_to_the_same_state_in_the_other_package(tmp_path, writer,
                                                                   reader):
    root = str(tmp_path / "j")
    now = time.time()
    _write_history(PACKAGES[writer], root, now).close()
    state_w, stats_w = PACKAGES[writer].replay(root)
    state_r, stats_r = PACKAGES[reader].replay(root)
    assert stats_r == stats_w == {"records": 17, "torn": 0}
    assert state_r == state_w
    assert state_r["replicas"] == {"r0": {"url": "http://u0", "draining": False},
                                   "r1": {"url": "http://u1", "draining": True},
                                   "r2": {"url": "http://u2", "draining": False}}
    assert set(state_r["idem"]) == {"done", "typed"}
    assert set(state_r["idem_inflight"]) == {"live"}
    # the reader opens it as a successor and keeps appending after its seq
    j = PACKAGES[reader].Journal(root)
    assert j.resumed and j.seq == 17
    assert j.append("takeover") == 18
    j.close()
    assert PACKAGES[writer].replay(root)[0]["takeovers"] == 2


def test_segments_are_the_same_bytes_for_the_same_records(tmp_path, monkeypatch):
    """Both packages encode a record identically (compact sorted JSON and
    its crc32); with the clock pinned the segment files are equal."""
    now = 1.7e9
    segs = {}
    for name, mod in PACKAGES.items():
        monkeypatch.setattr(mod.time, "time", lambda: now)
        root = str(tmp_path / name)
        _write_history(mod, root, now).close()
        segs[name] = _segments(root)
    assert list(segs["port"]) == list(segs["reference"])
    assert segs["port"] == segs["reference"]
    rec = {"seq": 1, "kind": "replica", "op": "register", "rid": "r0", "t": now}
    assert tjournal._encode(rec) == jjournal._encode(rec)
    line = tjournal._encode(rec)
    assert tjournal._decode(line) == jjournal._decode(line) == rec
    for bad in (line[:-4] + "\n", line.replace("r0", "r1"), "no-crc\n", ""):
        assert tjournal._decode(bad) is None and jjournal._decode(bad) is None


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_torn_tail_is_repaired_in_place_by_both(tmp_path, writer):
    """A SIGKILL mid-write leaves half a record at the end of the final
    segment: the port's Journal drops it, counts it and rewrites the
    segment, and both packages then replay the repaired journal alike."""
    root = str(tmp_path / "j")
    j = PACKAGES[writer].Journal(root)
    for i in range(4):
        j.append("replica", op="register", rid=f"r{i}", url="u")
    j.close()
    seg = sorted((tmp_path / "j").glob("journal-*.seg"))[-1]
    seg.write_bytes(seg.read_bytes()[:-7] + b'{"torn')
    assert tjournal.replay(root)[1] == jjournal.replay(root)[1] == {"records": 3,
                                                                    "torn": 1}
    j2 = tjournal.Journal(root)
    assert j2.stats()["torn_records"] == 1
    assert set(j2.state_snapshot()["replicas"]) == {"r0", "r1", "r2"}
    assert tprof.router_summary()["journal_torn_records"] == 1
    j2.append("takeover")  # a new segment: the repaired one is no longer final
    j2.close()
    for mod in PACKAGES.values():
        state, stats = mod.replay(root)
        assert stats == {"records": 4, "torn": 0}
        assert set(state["replicas"]) == {"r0", "r1", "r2"}


def test_interior_corruption_is_refused_by_both(tmp_path):
    root = str(tmp_path / "j")
    j = tjournal.Journal(root, segment_records=2)
    for i in range(5):  # three segments: [1, 2] [3, 4] [5]
        j.append("replica", op="register", rid=f"r{i}", url="u")
    j.close()
    segs = sorted((tmp_path / "j").glob("journal-*.seg"))
    assert [s.name for s in segs] == [f"journal-{n:012d}.seg" for n in (1, 3, 5)]
    lines = segs[0].read_text().splitlines(keepends=True)
    segs[0].write_text("corrupted-beyond-recognition\n" + lines[1])
    for mod in PACKAGES.values():
        with pytest.raises(mod.JournalCorruption):
            mod.replay(root)
        with pytest.raises(mod.JournalCorruption):
            mod.Journal(root)


@pytest.mark.parametrize("name", ["reference", "port"])
def test_compaction_keeps_the_state_bit_for_bit(tmp_path, name):
    """Each package compacts the same history; the state before, live after
    and replayed from disk after are the same bytes, in the port as in the
    reference, and the other package replays the snapshot to it too."""
    mod = PACKAGES[name]
    root = str(tmp_path / "j")
    now = time.time()
    j = _write_history(mod, root, now)
    before = mod.replay(root)[0]
    seq = j.compact(now=now)
    assert seq == 18 and j.stats()["compactions"] == 1
    live = j.state_snapshot()
    assert len(list((tmp_path / "j").glob("journal-*.seg"))) == 1
    for other in PACKAGES.values():
        assert _state_key(other.replay(root)[0]) == _state_key(before) == _state_key(live)
    j.append("takeover")
    j.close()
    assert tjournal.replay(root)[0] == jjournal.replay(root)[0]
    assert tjournal.replay(root)[0]["takeovers"] == 2


def test_compaction_prunes_idempotency_entries_past_their_ttl(tmp_path):
    out = {}
    for name, mod in PACKAGES.items():
        j = mod.Journal(str(tmp_path / name), ttl_s=10.0)
        j.append("idem_done", key="old", status=200, body={})
        t_old = j.state_snapshot()["idem"]["old"]["t"]
        j.append("idem_done", key="new", status=200, body={"tokens": [4]})
        j._state["idem"]["new"]["t"] = t_old + 30.0  # written 30 s later
        j.compact(now=t_old + 35.0)  # "old" is 35 s old, "new" 5 s
        out[name] = sorted(j.state_snapshot()["idem"])
        j.close()
    assert out["port"] == out["reference"] == ["new"]


def _cache_drill(mod, journal):
    """The same keyed sequence through one package's cache."""
    cache = mod.IdempotencyCache(ttl_s=60.0, journal=journal)
    seen = [cache.begin("a")[0]]
    v, entry = cache.begin("a")
    seen.append(v)
    assert cache.complete("a", 200, {"tokens": [1]}, {"X-Trace-Id": "t"}) is True
    seen.append(cache.wait(entry, timeout=1.0))
    seen.append(cache.begin("a"))
    seen.append(cache.begin("shed")[0])
    seen.append(cache.complete("shed", 503, {"type": "QueueFull", "retriable": True}))
    seen.append(cache.begin("shed")[0])
    cache.abandon("shed")
    seen.append(cache.begin("typed")[0])
    seen.append(cache.complete("typed", 404, {"type": "AdapterUnknown",
                                               "retriable": False}))
    seen.append(cache.stats())
    return seen


def test_idempotency_cache_verdicts_and_journal_records_match(tmp_path, monkeypatch):
    now = 1.7e9
    seen, records, counters = {}, {}, {}
    for name, mod in PACKAGES.items():
        monkeypatch.setattr(mod.time, "time", lambda: now)
        root = str(tmp_path / name)
        j = mod.Journal(root)
        seen[name] = _cache_drill(mod, j)
        j.close()
        records[name] = _segments(root)
    counters = ({k: tprof.router_summary()[k] for k in ("idem_hits", "idem_joins",
                                                        "journal_appends")},
                {k: jprof.router_summary()[k] for k in ("idem_hits", "idem_joins",
                                                        "journal_appends")})
    assert seen["port"] == seen["reference"]
    assert seen["port"][:4] == ["new", "join", (200, {"tokens": [1]}, {"X-Trace-Id": "t"}),
                                ("done", (200, {"tokens": [1]}, {"X-Trace-Id": "t"}))]
    assert records["port"] == records["reference"]
    assert counters[0] == counters[1] == {"idem_hits": 1, "idem_joins": 1,
                                          "journal_appends": 8}


def test_restore_loads_completed_responses_and_skips_expired_and_live():
    done = {"fresh": {"t": 1000.0, "status": 200, "body": {"tokens": [5]}},
            "stale": {"t": 100.0, "status": 200, "body": {"tokens": [6]}},
            "live": {"t": 1000.0, "status": 200, "body": {"tokens": [7]}}}
    out = {}
    for name, mod in PACKAGES.items():
        cache = mod.IdempotencyCache(ttl_s=60.0)
        cache.begin("live", now=1000.0)
        n = cache.restore(done, now=1010.0)
        out[name] = (n, cache.begin("fresh", now=1010.0), cache.begin("stale", now=1010.0)[0],
                     cache.begin("live", now=1010.0)[0], cache.stats())
    assert out["port"] == out["reference"]
    assert out["port"][:4] == (1, ("done", (200, {"tokens": [5]}, {})), "new", "join")


FLEET_FLAGS = (
    "FLAGS_router_probe_interval", "FLAGS_router_probe_timeout",
    "FLAGS_router_max_retries", "FLAGS_router_retry_backoff",
    "FLAGS_router_max_inflight", "FLAGS_router_hedge_s",
    "FLAGS_router_breaker_threshold", "FLAGS_router_breaker_cooldown",
    "FLAGS_router_journal_segment_records", "FLAGS_router_retry_after_jitter",
    "FLAGS_router_takeover_timeout", "FLAGS_autoscale_interval",
    "FLAGS_autoscale_min_replicas", "FLAGS_autoscale_max_replicas",
    "FLAGS_autoscale_up_ticks", "FLAGS_autoscale_down_ticks",
    "FLAGS_autoscale_up_cooldown", "FLAGS_autoscale_down_cooldown",
    "FLAGS_autoscale_up_drain_s", "FLAGS_autoscale_up_queue_depth",
    "FLAGS_autoscale_up_miss_rate", "FLAGS_autoscale_min_page_free",
    "FLAGS_autoscale_down_drain_s", "FLAGS_autoscale_down_idle_tokens_s",
    "FLAGS_autoscale_tp_max",
)


@pytest.mark.parametrize("name", FLEET_FLAGS)
def test_fleet_flags_have_the_reference_defaults(name):
    assert tcore.flag(name) == jcore.flag(name)
    assert type(tcore.flag(name)) is type(jcore.flag(name))
    tcore.set_flags({name: tcore.flag(name)})  # registered: no KeyError


FLEET_POINTS = ("router.replica.hang", "router.replica.flap", "router.replica.kill",
                "router.crash", "autoscale.spawn", "disagg.handoff.drop",
                "launch.spawn")


@pytest.mark.parametrize("point", FLEET_POINTS)
def test_fleet_fault_points_are_registered_as_the_reference_does(point):
    assert tinj.fault_points()[point] == jinj.fault_points()[point]
