"""The durable control-plane journal and the idempotency cache
(counterpart of `paddle_tpu/serving/journal.py`, the same on-disk format:
a journal either package writes replays to the same state in the other).

The router's breaker states, replica registry, autoscaler clocks and
completed idempotent responses go into an append-only journal of
checksummed records, so a successor router rehydrates what the dead one
knew.

Journal format (one record per line, within numbered segment files):

    <compact-json>|<crc32-of-json-as-8-hex>\\n

Segment files are named ``journal-<first_seq>.seg``; a new segment opens
every ``FLAGS_router_journal_segment_records`` appends and on every
process life (the previous life's tail may be torn).  ``replay`` folds
every segment oldest first.  A torn or checksum-failing record in the
final segment truncates it there (counted, then repaired in place by
write-tmp and ``os.replace``, so every non-final segment stays fully
valid across lives); corruption in an earlier segment raises
:class:`JournalCorruption`: skipping interior history would rehydrate a
control plane that lies.

``compact()`` folds the whole journal into one ``snapshot`` record in a
fresh segment (tmp and atomic rename, then the older segments go),
pruning idempotency entries past their TTL.  The replayed state is the
same before and after: ``fold`` is the one source of truth for both.

Record kinds folded into the state (an unknown kind is ignored):

    breaker     {rid, state, fails, open_until_wall}
    replica     {op: register|deregister|drain, rid, url, draining}
    autoscale   {band, last_action_wall, up_streak, down_streak}
    idem_admit  {key, rid}           an admitted in-flight idempotency key
    idem_done   {key, status, body}  a kept completed response
    idem_drop   {key}                a retriable outcome: never kept
    takeover    {}                   a successor replayed this journal
    snapshot    {state}              a compaction (replaces the state)

:class:`IdempotencyCache` is the other half of the crash-proof front
door: a TTL'd completed-response cache and an in-flight join, used by the
router and by ``inference.serve()``, so a client's retry after a
connection reset (or a router's death) never produces two generations.
Nothing here touches the card or imports the model stack: a standby must
replay a journal without it.
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib

from .. import profiler as _prof
from ..framework import core as _core
from ..obs import flight as _flight


class JournalCorruption(RuntimeError):
    """A checksum failure in a non-final segment: interior history is gone
    and a replay cannot be trusted.  (A torn final record is the normal
    crash signature and is repaired, not raised.)"""


# -- the fold: one source of truth for replay and compaction ---------------


def empty_state():
    return {
        "seq": 0,
        "takeovers": 0,
        "breakers": {},        # rid -> {breaker, fails, open_until_wall}
        "replicas": {},        # rid -> {url, draining} (registration order)
        "autoscale": None,     # band and cooldown clocks, or None
        "idem": {},            # key -> {t, status, body} completed entries
        "idem_inflight": {},   # key -> {t, rid} admitted, never completed
    }


def fold(state, rec):
    """Fold one journal record into `state` (mutates and returns it); an
    unknown kind is ignored."""
    kind = rec.get("kind")
    state["seq"] = max(state["seq"], int(rec.get("seq", 0)))
    if kind == "breaker":
        state["breakers"][rec["rid"]] = {
            "breaker": rec["state"],
            "fails": int(rec.get("fails", 0)),
            "open_until_wall": float(rec.get("open_until_wall", 0.0)),
        }
    elif kind == "replica":
        op = rec.get("op")
        if op == "register":
            state["replicas"].setdefault(
                rec["rid"], {"url": rec.get("url", ""), "draining": False})
        elif op == "deregister":
            state["replicas"].pop(rec["rid"], None)
            state["breakers"].pop(rec["rid"], None)
        elif op == "drain" and rec["rid"] in state["replicas"]:
            state["replicas"][rec["rid"]]["draining"] = bool(rec["draining"])
    elif kind == "autoscale":
        state["autoscale"] = {
            "band": list(rec.get("band", ())),
            "last_action_wall": float(rec.get("last_action_wall", 0.0)),
            "up_streak": int(rec.get("up_streak", 0)),
            "down_streak": int(rec.get("down_streak", 0)),
        }
    elif kind == "idem_admit":
        state["idem_inflight"][rec["key"]] = {
            "t": float(rec.get("t", 0.0)), "rid": rec.get("rid")}
    elif kind == "idem_done":
        state["idem_inflight"].pop(rec["key"], None)
        state["idem"][rec["key"]] = {
            "t": float(rec.get("t", 0.0)),
            "status": int(rec["status"]),
            "body": rec.get("body"),
        }
    elif kind == "idem_drop":
        state["idem_inflight"].pop(rec["key"], None)
        state["idem"].pop(rec["key"], None)
    elif kind == "takeover":
        state["takeovers"] += 1
    elif kind == "snapshot":
        seq = state["seq"]
        state.clear()
        state.update(rec["state"])
        state["seq"] = max(state["seq"], seq)
    return state


# -- segment encoding ------------------------------------------------------


def _encode(rec):
    payload = json.dumps(rec, separators=(",", ":"), sort_keys=True)
    crc = zlib.crc32(payload.encode()) & 0xFFFFFFFF
    return f"{payload}|{crc:08x}\n"


def _decode(line):
    """One journal line's record; None when torn or checksum-failing."""
    line = line.rstrip("\n")
    payload, sep, crc = line.rpartition("|")
    if not sep or len(crc) != 8:
        return None
    try:
        if int(crc, 16) != (zlib.crc32(payload.encode()) & 0xFFFFFFFF):
            return None
        rec = json.loads(payload)
    except ValueError:
        return None
    return rec if isinstance(rec, dict) else None


def _segment_name(first_seq):
    return f"journal-{int(first_seq):012d}.seg"


def _list_segments(root):
    try:
        names = os.listdir(root)
    except OSError:
        return []
    segs = []
    for name in names:
        if name.startswith("journal-") and name.endswith(".seg"):
            try:
                segs.append((int(name[len("journal-"):-len(".seg")]), name))
            except ValueError:
                continue
    return [name for _, name in sorted(segs)]


def replay(root):
    """Fold every segment under `root` oldest first.

    Returns ``(state, stats)``; stats holds the ``records`` applied and the
    ``torn`` ones dropped from the final segment's tail.  A bad record in
    a non-final segment raises :class:`JournalCorruption`: only a torn
    tail is the honest crash signature."""
    state = empty_state()
    stats = {"records": 0, "torn": 0}
    segs = _list_segments(root)
    for si, name in enumerate(segs):
        final = si == len(segs) - 1
        with open(os.path.join(root, name)) as f:
            lines = f.readlines()
        bad_at = None
        for li, line in enumerate(lines):
            rec = _decode(line)
            if rec is None:
                bad_at = li
                break
            fold(state, rec)
            stats["records"] += 1
        if bad_at is not None:
            if not final:
                raise JournalCorruption(
                    f"corrupt record {bad_at} in non-final segment {name}")
            stats["torn"] += len(lines) - bad_at
    return state, stats


class Journal:
    """Append-only, checksummed, compacting control-plane journal.

    Opening an existing directory replays it (repairing a torn final tail
    in place) and appends into a fresh segment; the folded state is kept
    current, so ``compact()`` and a rehydration never read the disk again.
    Appends come from handler threads, the probe thread, the breakers and
    the autoscaler: every mutable field lives under ``self._mu``."""

    def __init__(self, root, segment_records=None, ttl_s=None, fsync=False):
        self.root = str(root)
        self.segment_records = int(
            segment_records if segment_records is not None
            else _core.flag("FLAGS_router_journal_segment_records"))
        self.ttl_s = float(
            ttl_s if ttl_s is not None else _core.flag("FLAGS_router_idem_ttl"))
        self.fsync = bool(fsync)
        os.makedirs(self.root, exist_ok=True)
        self._mu = threading.Lock()
        state, stats = replay(self.root)
        if stats["torn"]:
            self._repair_tail()
            _prof.record_router_event("journal_torn_records", stats["torn"])
            _flight.record("journal", f"torn tail repaired: {stats['torn']} "
                           "record(s) dropped", root=self.root, seq=state["seq"])
        with self._mu:
            self._state = state
            self._seq = int(state["seq"])
            self._resumed = stats["records"] > 0
            self._active = None  # the open file of the current segment
            self._active_records = 0
            self._compactions = 0
            self._torn = stats["torn"]

    # -- introspection -------------------------------------------------------

    @property
    def seq(self):
        with self._mu:
            return self._seq

    @property
    def resumed(self):
        """True when opening found earlier records: a successor's signature
        (a fresh directory starts empty)."""
        with self._mu:
            return self._resumed

    def state_snapshot(self):
        """A deep copy of the folded state."""
        with self._mu:
            return json.loads(json.dumps(self._state))

    def stats(self):
        with self._mu:
            return {"seq": self._seq,
                    "segments": len(_list_segments(self.root)),
                    "compactions": self._compactions,
                    "torn_records": self._torn}

    # -- appending -----------------------------------------------------------

    def append(self, kind, **fields):
        """Write one record (checksummed, flushed) and fold it into the live
        state.  Returns the record's seq."""
        with self._mu:
            self._seq += 1
            rec = {"seq": self._seq, "kind": str(kind), "t": time.time()}
            rec.update(fields)
            self._write_locked(rec)
            fold(self._state, rec)
            seq = self._seq
        _prof.record_router_event("journal_appends")
        return seq

    def _write_locked(self, rec):
        if self._active is None or self._active_records >= self.segment_records:
            if self._active is not None:
                self._active.close()
            path = os.path.join(self.root, _segment_name(rec["seq"]))
            self._active = open(path, "a")
            self._active_records = 0
        self._active.write(_encode(rec))
        self._active.flush()
        if self.fsync:
            os.fsync(self._active.fileno())
        self._active_records += 1

    # -- compaction ----------------------------------------------------------

    def compact(self, now=None):
        """Fold the whole journal into one snapshot record in a fresh
        segment (write-tmp and atomic rename), then delete the older
        segments; expired idempotency entries are pruned on the way.
        Returns the snapshot's seq."""
        now = time.time() if now is None else now
        with self._mu:
            if self._active is not None:
                self._active.close()
                self._active = None
                self._active_records = 0
            self._prune_idem_locked(now)
            old = _list_segments(self.root)
            self._seq += 1
            rec = {"seq": self._seq, "kind": "snapshot", "t": now,
                   "state": json.loads(json.dumps(self._state))}
            rec["state"]["seq"] = self._seq
            path = os.path.join(self.root, _segment_name(self._seq))
            tmp = f"{path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                f.write(_encode(rec))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
            for name in old:
                if name != _segment_name(self._seq):
                    try:
                        os.remove(os.path.join(self.root, name))
                    except OSError:
                        pass
            fold(self._state, rec)
            self._compactions += 1
            seq = self._seq
        _prof.record_router_event("journal_compactions")
        _flight.record("journal", "compacted", seq=seq, dropped_segments=len(old))
        return seq

    def _prune_idem_locked(self, now):
        idem = self._state["idem"]
        for key in [k for k, v in idem.items() if now - v["t"] > self.ttl_s]:
            del idem[key]

    def _repair_tail(self):
        """Rewrite the final segment with its valid prefix only (tmp and
        atomic rename): once this life appends new segments the torn one
        is no longer final and must replay clean."""
        segs = _list_segments(self.root)
        if not segs:
            return
        path = os.path.join(self.root, segs[-1])
        with open(path) as f:
            lines = f.readlines()
        good = []
        for line in lines:
            if _decode(line) is None:
                break
            good.append(line)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.writelines(good)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    def close(self):
        with self._mu:
            if self._active is not None:
                self._active.close()
                self._active = None


class IdempotencyCache:
    """TTL'd completed-response cache and in-flight join, keyed by the
    client's idempotency key.

    ``begin(key)`` returns one of three verdicts:

      ("new", None)     -- first sight: the caller executes the request and
                           must finish with ``complete`` or ``abandon``
      ("join", entry)   -- the key is live right now: ``wait(entry)`` blocks
                           until the live request completes and returns its
                           exact response (one generation, equal answers)
      ("done", resp)    -- a completed response inside the TTL: replay it

    Only terminal outcomes are kept: 200s and non-retriable typed errors.
    A retriable error (a 503 shed) wakes joiners with the response but
    drops the entry, so a later retry executes again: caching a shed would
    turn one overload into a permanent failure.  With a `journal`, every
    admission and outcome is journaled, and ``restore`` loads a replayed
    journal's completed responses into a successor.  All state lives under
    one lock; entries change only under it."""

    class _Entry:
        __slots__ = ("event", "response", "done", "t_done", "rid")

        def __init__(self):
            self.event = threading.Event()
            self.response = None  # (status, body, headers)
            self.done = False
            self.t_done = 0.0
            self.rid = None

    def __init__(self, ttl_s=None, journal=None):
        self.ttl_s = float(
            ttl_s if ttl_s is not None else _core.flag("FLAGS_router_idem_ttl"))
        self.journal = journal
        self._mu = threading.Lock()
        self._entries = {}

    def begin(self, key, now=None):
        now = time.time() if now is None else now
        journal_admit = False
        with self._mu:
            self._purge_locked(now)
            entry = self._entries.get(key)
            if entry is None:
                self._entries[key] = self._Entry()
                journal_admit = True
                out = ("new", None)
            elif not entry.done:
                out = ("join", entry)
            else:
                out = ("done", entry.response)
        if journal_admit and self.journal is not None:
            self.journal.append("idem_admit", key=key)
        if out[0] == "join":
            _prof.record_router_event("idem_joins")
        elif out[0] == "done":
            _prof.record_router_event("idem_hits")
        return out

    def wait(self, entry, timeout=600.0):
        """Block on a joined entry; returns its (status, body, headers)
        response, or None when the live request abandoned or the wait timed
        out (the caller answers a retriable error)."""
        if not entry.event.wait(timeout):
            return None
        with self._mu:
            return entry.response

    def complete(self, key, status, body, headers=None, now=None):
        """The terminal outcome of a key: wake joiners with the exact
        response; keep (and journal) it only when replaying it later is
        correct.  Returns True when the response was kept."""
        now = time.time() if now is None else now
        retain = status == 200 or (
            isinstance(body, dict) and body.get("retriable") is False)
        with self._mu:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._Entry()
                self._entries[key] = entry
            entry.response = (status, body, dict(headers or {}))
            entry.done = True
            entry.t_done = now
            if not retain:
                self._entries.pop(key, None)
            entry.event.set()
        if self.journal is not None:
            if retain:
                self.journal.append("idem_done", key=key, status=int(status),
                                    body=body)
            else:
                self.journal.append("idem_drop", key=key)
        return retain

    def abandon(self, key):
        """The live request died without a terminal response (a router
        crash, a raising handler): drop the entry and wake joiners with no
        response, so their keyed retries execute again."""
        with self._mu:
            entry = self._entries.pop(key, None)
            if entry is not None:
                entry.event.set()
        if entry is not None and self.journal is not None:
            self.journal.append("idem_drop", key=key)

    def restore(self, done_entries, now=None):
        """Load a replayed journal's completed responses (a successor's
        rehydration); entries past the TTL are skipped, live ones never
        overwritten.  Returns how many were loaded."""
        now = time.time() if now is None else now
        n = 0
        with self._mu:
            for key, v in done_entries.items():
                if now - v["t"] > self.ttl_s or key in self._entries:
                    continue
                entry = self._Entry()
                entry.response = (int(v["status"]), v["body"], {})
                entry.done = True
                entry.t_done = float(v["t"])
                entry.event.set()
                self._entries[key] = entry
                n += 1
        return n

    def stats(self):
        with self._mu:
            done = sum(1 for e in self._entries.values() if e.done)
            return {"cached": done, "inflight": len(self._entries) - done}

    def _purge_locked(self, now):
        dead = [k for k, e in self._entries.items()
                if e.done and now - e.t_done > self.ttl_s]
        for k in dead:
            del self._entries[k]
