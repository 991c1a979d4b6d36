"""Helpers of the serving-fleet tests (`tests/test_torch_router*.py`,
`tests/test_torch_autoscaler.py`): a scripted replica over HTTP that both
packages' routers can drive on the same inputs, the two packages' fleet
modules side by side, and a reset of their router, disagg and autoscale
counters.

`FakeReplica` answers `/healthz` with a dict the test sets and the three
POST hops with deterministic bodies: `/generate` returns the prompt and
`max_new_tokens` tokens derived from it (`gen_tokens`), `/reserve` a
reservation id, `/prefill` the first of those tokens and a small handoff
dict.  `mode` scripts a failure: "close" drops
the connection with no byte of response, "hang" sleeps `hang_s` first,
"error" answers the typed error in `error`; `fail[path] = n` drops the
connection of the next n POSTs to `path`.  Every POST is counted per path
and kept with its headers.
"""

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from paddle_tpu import profiler as jprof
from paddle_tpu.fault import injection as jinj
from paddle_tpu.framework import core as jcore
from paddle_tpu.obs import trace as jtrace
from paddle_tpu.serving import autoscaler as jautoscaler
from paddle_tpu.serving import replica as jreplica
from paddle_tpu.serving import router as jrouter
from paddle_tpu_torch import profiler as tprof
from paddle_tpu_torch.fault import injection as tinj
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.obs import trace as ttrace
from paddle_tpu_torch.serving import autoscaler as tautoscaler
from paddle_tpu_torch.serving import replica as treplica
from paddle_tpu_torch.serving import router as trouter


class Pkg:
    """One package's fleet modules under one set of names."""

    def __init__(self, name, router, replica, autoscaler, prof, inj, core, trace):
        self.name = name
        self.router = router
        self.replica = replica
        self.autoscaler = autoscaler
        self.prof = prof
        self.inj = inj
        self.core = core
        self.trace = trace

    @property
    def Router(self):
        return self.router.Router

    @property
    def Replica(self):
        return self.replica.Replica


REF = Pkg("reference", jrouter, jreplica, jautoscaler, jprof, jinj, jcore, jtrace)
PORT = Pkg("port", trouter, treplica, tautoscaler, tprof, tinj, tcore, ttrace)
BOTH = (REF, PORT)


def reset_counters():
    for pkg in BOTH:
        pkg.prof.reset_router()
        pkg.prof.reset_disagg()
        pkg.prof.reset_autoscale()
        pkg.inj.disarm()


def gen_tokens(ids, n):
    """The fake replica's deterministic continuation of `ids`."""
    s = sum(int(x) for x in ids)
    return [int(x) for x in ids] + [(s + 7 * i) % 251 + 1 for i in range(int(n))]


def strip_trace(body):
    """A typed error body without its per-request trace id."""
    return {k: v for k, v in body.items() if k != "trace_id"} if isinstance(body, dict) else body


class FakeReplica:
    """A scripted serve() stand-in on an ephemeral port."""

    def __init__(self, role="colocated", **health):
        self.health = {"status": "ready", "queue_depth": 0, "active_slots": 0,
                       "drain_estimate_s": 0.0, "page_free_frac": 1.0,
                       "decode_ewma_ms": 0.0, "role": role, **health}
        self.mode = "ok"
        self.modes = {}  # path -> mode, over `mode`
        self.fail = {}  # path -> how many of its next POSTs drop the connection
        self.hang_s = 1.0
        self.error = (503, {"type": "QueueFull", "retriable": True,
                            "error": "queue full", "retry_after_s": 1.0})
        self.calls = []  # (path, body, headers)
        self.counts = {}
        self._mu = threading.Lock()
        self._n_rsv = 0
        fake = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    h = dict(fake.health)
                    self._reply(200 if h["status"] in ("ready", "live") else 503, h)
                else:
                    self._reply(404, {"error": "no"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n))
                with fake._mu:
                    fake.calls.append((self.path, body, dict(self.headers)))
                    fake.counts[self.path] = fake.counts.get(self.path, 0) + 1
                    mode = fake.modes.get(self.path, fake.mode)
                    if fake.fail.get(self.path, 0) > 0:
                        fake.fail[self.path] -= 1
                        mode = "close"
                if mode == "close":
                    self.close_connection = True
                    return
                if mode == "hang":
                    time.sleep(fake.hang_s)
                if mode == "error":
                    self._reply(*fake.error)
                    return
                ids = body.get("input_ids", [])
                if self.path == "/reserve":
                    with fake._mu:
                        fake._n_rsv += 1
                        rid = f"rsv-{fake._n_rsv}"
                    self._reply(200, {"reservation": rid, "pages": 1, "ttl_s": 30.0})
                elif self.path == "/prefill":
                    first = gen_tokens(ids, 1)[-1]
                    handoff = ({"first_token": first, "prompt_len": len(ids),
                                "payload_bytes": 64 * len(ids)}
                               if body.get("export", True) else None)
                    self._reply(200, {"first_token": first, "prompt_len": len(ids),
                                      "handoff": handoff})
                elif self.path == "/generate":
                    n_new = body.get("max_new_tokens") or 32
                    batched = bool(ids) and isinstance(ids[0], list)
                    self._reply(200, {"tokens": [gen_tokens(row, n_new) for row in ids]
                                      if batched else gen_tokens(ids, n_new)})
                else:
                    self._reply(404, {"error": "no"})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def stop(self):
        """The replica dies: its port refuses connections from now on."""
        self.server.shutdown()
        self.server.server_close()


def stop_all(fakes):
    for f in fakes:
        try:
            f.stop()
        except Exception:
            pass
