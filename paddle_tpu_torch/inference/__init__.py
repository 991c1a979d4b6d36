"""Serving entry points of the port (counterpart of `paddle_tpu/inference/
__init__.py`): the inference export (`export`, `Config`, `Predictor`,
`create_predictor`, in `predictor.py`) and an exported program's
`/predict`; `GenerationPredictor`; and `serve()`: the engine's and the
generation predictor's `/generate`, and the engine's disaggregated hops
`/reserve` and `/prefill`.
"""

from __future__ import annotations

import json
import os
import signal as _signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..fault import EngineSupervisor
from ..fault import injection as _inj
from ..framework import core as _fcore
from ..lora.registry import AdapterUnknown
from ..obs import flight as _flight
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs
from ..serving.journal import IdempotencyCache
from .engine import (
    ContextOverflow,
    ContinuousBatchingEngine,
    DeadlineExceeded,
    DeadlineUnattainable,
    EngineRequest,
    EngineRestarted,
    EngineUnavailable,
    NonFiniteLogits,
    QueueFull,
    RequestCancelled,
)
from .predictor import Config, Predictor, create_predictor, export

__all__ = ["serve", "export", "Config", "Predictor", "create_predictor",
           "ContinuousBatchingEngine", "GenerationPredictor",
           "EngineRequest", "QueueFull", "ContextOverflow", "NonFiniteLogits",
           "EngineUnavailable", "DeadlineUnattainable", "DeadlineExceeded",
           "RequestCancelled", "EngineRestarted"]

# the SIGTERM handlers serve() has installed and not yet put back, each
# mapped to the handler it replaced
_sigterm_prev = {}
_sigterm_mu = threading.Lock()


def _sigterm_default_in_child():
    """A forked child starts with SIG_DFL in place of a serve() drain
    handler: the child has no server to drain, and a caught SIGTERM would
    leave it running when its parent tries to end it."""
    try:
        if _signal.getsignal(_signal.SIGTERM) in _sigterm_prev:
            _signal.signal(_signal.SIGTERM, _signal.SIG_DFL)
    except (ValueError, TypeError):
        pass
    _sigterm_prev.clear()


os.register_at_fork(after_in_child=_sigterm_default_in_child)


class GenerationPredictor:
    """Lock-step generation behind `serve()` (reference: inference/
    __init__.py:126): each request runs the model's `generate` over its
    static KV caches and captured steps, one request at a time.  Ids come
    in and go out as numpy arrays."""

    def __init__(self, model, max_new_tokens=32):
        self.model = model
        self.max_new_tokens = max_new_tokens

    def generate(self, input_ids, max_new_tokens=None, temperature=0.0,
                 eos_token_id=None):
        """input_ids: [s0] or [b, s0] ints.  Returns prompt + generated ids
        [b, s0 + n] (np.int32)."""
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        n = self.max_new_tokens if max_new_tokens is None else int(max_new_tokens)
        out = self.model.generate(torch.from_numpy(ids), max_new_tokens=n,
                                  temperature=float(temperature),
                                  eos_token_id=eos_token_id)
        return out.cpu().numpy()

    def warmup(self, batch_size=1, prompt_len=8, max_new_tokens=None,
               temperature=0.0):
        """One dummy generate on zero ids before traffic: it traces the
        prefill and decode steps of that geometry (batch, prompt length,
        cache length, strategy), on the card capturing their CUDA graphs
        after building the kernels, so a later request of the same geometry
        traces nothing (reference: inference/__init__.py:163).  The weights
        are only read."""
        ids = np.zeros((int(batch_size), int(prompt_len)), np.int32)
        self.generate(ids, max_new_tokens=max_new_tokens, temperature=temperature)
        return self


def serve(engine, port=8866, host="127.0.0.1", block=True, supervise=True,
          handle_signals=None):
    """Serve a ContinuousBatchingEngine, a GenerationPredictor, or an
    exported program (a `Predictor`, or the path prefix `export` wrote,
    loaded on the card) over HTTP (stdlib ThreadingHTTPServer); an
    engine's scheduler thread starts here.

    - POST /predict (exported program; reference: inference/__init__.py:
      660-682): body {"inputs": [array, ...]} -> {"outputs": [array, ...]},
      each input cast to its traced dtype, run by `Predictor.run` one call
      at a time; beyond FLAGS_serve_queue_depth running or waiting requests
      the server answers 503, and a bad body or a failing run 400 with
      "error": "Type: message".  Without an exported program, /predict
      answers the reference's 404.

    - POST /generate: body {"input_ids": [...] or [[...], ...],
      "max_new_tokens": n, "temperature": t, "eos_token_id": id, "spec_k":
      k, "deadline_s": s} -> {"tokens": prompt + generated}, one token row
      per input row for a batched body.  Engine: each row is its own
      request; `spec_k` caps the request's draft length (0 opts out of
      speculation); a deadline (`deadline_s`, else the `X-Deadline-Ms`
      header / 1e3) <= 0 answers 504 DeadlineExceeded before admission, not
      retriable; a live one is served: one the queue-drain estimate cannot
      meet answers a retriable 504 DeadlineUnattainable, and one that
      expires in flight a 504 DeadlineExceeded, not retriable.  A full
      queue, a draining or dead engine answer 503 (QueueFull,
      EngineUnavailable; rows already admitted still complete; the client
      retries the batch), and so does a request an engine restart cut off
      (EngineRestarted); every 503 carries Retry-After from the engine's
      queue-drain estimate.  A prompt past the context answers 400 with the
      engine's capacity geometry under "capacity" (per shard under cp); a
      request whose logits went non-finite answers 500 (NonFiniteLogits); a
      bad body, or a request that fails otherwise inside the engine,
      answers 400 with "Type: message".  `adapter` names the request's LoRA
      adapter (an engine built with `lora=`): an unknown one answers the
      reference's terminal 404 AdapterUnknown (`retriable: false`), any
      adapter on an engine without an arena the reference's 400
      ValueError.  `session_id` names the request's KV session (the
      engine's `submit`).  `handoff` (a decode-role engine) imports a
      /prefill answer's payload instead of prefilling, and a bad one
      answers 400 HandoffFormatError; `reservation` names a /reserve hold
      the admission consumes (an unknown one is a no-op).  A request with `X-Idempotency-Key` generates once
      per key: a completed response (200 or a non-retriable error) is kept
      for FLAGS_router_idem_ttl seconds and replayed with
      `X-Idempotency-Replay: hit`; a retry while the first is in flight
      waits for it and answers the same with `X-Idempotency-Replay: join`.
      The response is cached before its bytes go out; a retriable error is
      never cached.  Predictor: calls to the one model run one at a time;
      beyond FLAGS_serve_queue_depth running or waiting requests the server
      answers 503; a bad body, or a request the model refuses, answers 400.
      Error bodies carry "error", "type", "retriable", "retry_after_s" and
      "trace_id", as the reference's do.
    - POST /reserve (engine): {"prompt_len": L, "max_new_tokens": n,
      "ttl_s": t} holds decode-side pages before a prefill starts
      elsewhere (`engine.reserve_pages`): {"reservation", "pages",
      "ttl_s"}, or a retriable 503 QueueFull when the headroom is not
      there; a bad body answers 400.
    - POST /prefill (engine; reference: inference/__init__.py:464-570):
      one prompt (a batch answers 400) prefilled with one sampled token
      and its committed prompt rows exported: {"first_token",
      "prompt_len", "handoff"}, the payload a decode-role engine imports
      through /generate's "handoff".  With "export": false nothing is
      exported and "handoff" is null.  Deadlines, 503s and 504s as
      /generate's; a prefill whose export failed answers a retriable 503
      HandoffExportFailed.  The `disagg.prefill.crash` fault point closes
      the connection after the export with no byte of response.
    - GET /health: {"status": "ok"}.
    - GET /healthz: an engine's status (ready, live, draining, dead),
      occupancy, queue depth, restarts, drain estimate, deadline-miss rate,
      mesh and tokens per step (503 unless ready or live); a predictor's
      {"status": "ready"} (or "draining").
    - GET /metrics: every profiler family as Prometheus text
      (`obs.metrics.render`), each sample labelled {replica="host:port"}
      with the bound address, and {role="prefill"|"decode"} behind an
      engine of a disaggregated role.
    - GET /trace/<id>: {"trace_id", "spans": [root, ...]}, the span tree of
      one trace (`obs.trace.tree`), or 404 when none of its spans is
      buffered.

    Tracing (reference: inference/__init__.py:575-600): every POST joins
    the caller's trace context (`X-Trace-Id`, `X-Parent-Span`) or mints a
    root, and every reply carries `X-Trace-Id`.  Under FLAGS_trace the
    request's `serve.handle` span (its id minted first, so the engine's
    stage spans hang under it; the rows of a batched body share it) is
    recorded after the reply's bytes are out, as the reference records it.

    Fault domain (reference: inference/__init__.py:216-225): an engine runs
    under a `fault.EngineSupervisor` (`supervise=False` opts out), so a
    wedged or dead scheduler gets a bounded warm restart and, past the
    budget, clients get typed 503s instead of hangs.  `server.drain(grace)`
    stops admitting (POSTs answer 503 "Draining" with Retry-After,
    /healthz reads draining), lets in-flight work finish for up to `grace`
    seconds (PADDLE_STOP_GRACE, else FLAGS_serve_drain_grace), then stops
    the supervisor, the engine and the HTTP loop; it returns its worker
    thread.  A drain first writes the flight recorder's ring to a dump
    (`serve-drain`); while it lasts, /metrics, /trace and /healthz still
    answer.  SIGTERM drains too, when serve() runs on the main thread or
    `handle_signals=True`; the previous handler comes back when the server
    stops (servers stopped in any order leave no stopped server's handler
    installed), and a forked child starts with SIG_DFL.

    `port=0` binds a free port (read it from `server.server_address`).
    With `block=False` the server runs on a daemon thread and the returned
    server's `stop()` shuts down the HTTP loop, the supervisor and an
    engine's scheduler, and puts the SIGTERM handler back.
    """
    if isinstance(engine, (str, os.PathLike)):
        engine = Predictor(os.fspath(engine))
    exported = engine if isinstance(engine, Predictor) else None
    predictor = engine if isinstance(engine, GenerationPredictor) else None
    if predictor is not None or exported is not None:
        engine = None
    supervisor = None
    if engine is not None:
        engine.start()
        if supervise:
            supervisor = EngineSupervisor(engine).start()
    lock = threading.Lock()  # one model: serialise the predictor's callers
    gate = threading.BoundedSemaphore(int(_fcore.flag("FLAGS_serve_queue_depth")))
    state = {"draining": False}
    # request dedupe of the engine path (reference: inference/__init__.py:
    # 262-272): a keyed /generate completes into the cache before its
    # response bytes go out
    idem = IdempotencyCache() if engine is not None else None

    class Handler(BaseHTTPRequestHandler):
        _idem_key = None  # the key this handler must complete, if any
        _trace_id = None  # the POST's trace id, echoed on every reply
        _err = None  # the POST's error type, for its serve.handle span

        def log_message(self, *a):
            pass

        def _reply(self, code, payload, headers=None):
            key = self._idem_key
            if key is not None:
                # complete before any response byte leaves: a reset between
                # completion and delivery leaves the response cached for the
                # client's keyed retry
                self._idem_key = None
                idem.complete(key, code, payload, headers)
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if self._trace_id:
                self.send_header(_obs.HDR_TRACE, self._trace_id)
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _reply_error(self, code, err_type, msg, retriable, retry_after=None):
            # the reference's typed error body (`_reply_error`): the trace
            # id joins a failure to its span tree
            self._err = err_type
            headers = {}
            if retry_after is not None:
                headers["Retry-After"] = str(max(1, int(retry_after + 0.5)))
            self._reply(code, {"error": msg, "type": err_type,
                               "retriable": bool(retriable),
                               "retry_after_s": retry_after or 0,
                               "trace_id": self._trace_id}, headers)

        def _error(self, code, err, retry_after=None, msg=None):
            self._reply_error(code, type(err).__name__,
                              str(err) if msg is None else msg,
                              retry_after is not None, retry_after)

        def _busy(self, msg, retry_after=None, err_type="EngineUnavailable"):
            # a retriable 503 whose Retry-After is the queue-drain estimate
            # (reference: `_busy`): a shed client retries when a slot is
            # plausibly free
            if retry_after is None:
                retry_after = engine.estimate_drain_s() if engine is not None else 1.0
            self._reply_error(503, err_type, msg, True, retry_after)

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok"})
            elif self.path == "/healthz":
                if engine is not None:
                    h = engine.healthz()
                    if state["draining"] and h["status"] != "dead":
                        h["status"] = "draining"
                else:
                    h = {"status": "draining" if state["draining"] else "ready"}
                self._reply(200 if h["status"] in ("ready", "live") else 503, h)
            elif self.path == "/metrics":
                # the bound address, not the port argument (0: ephemeral)
                bh, bp = self.server.server_address[:2]
                labels = {"replica": f"{bh}:{bp}"}
                if engine is not None and engine.role != "colocated":
                    labels["role"] = engine.role
                body = _obs_metrics.render(labels=labels).encode()
                self.send_response(200)
                self.send_header("Content-Type", _obs_metrics.CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path.startswith("/trace/"):
                tid = self.path[len("/trace/"):]
                roots = _obs.tree(tid)
                if roots:
                    self._reply(200, {"trace_id": tid, "spans": roots})
                else:
                    self._reply(404, {"error": f"no spans buffered for trace {tid!r}"})
            else:
                self._reply(404, {"error": "use GET /healthz, /metrics, "
                                           "/trace/<id> or POST /generate"})

        def do_POST(self):
            # the caller's trace context, or a minted root (minting is
            # always on: error bodies carry trace_id); the serve.handle
            # span id is minted first so the engine's spans can hang under
            # it before it completes
            ctx = _obs.ctx_from_headers(self.headers)
            self._trace_id = ctx[0] if ctx else _obs.new_trace_id()
            self._handle_sid = _obs.new_span_id()
            self._err = None
            t0 = time.perf_counter()
            try:
                self._do_post()
            finally:
                _obs.record("serve.handle", self._trace_id, t0=t0,
                            t1=time.perf_counter(), span_id=self._handle_sid,
                            parent_id=ctx[1] if ctx else None,
                            status="error" if self._err else "ok",
                            path=self.path, error=self._err)

        def _do_post(self):
            if state["draining"]:
                self._busy("server draining, retry elsewhere", err_type="Draining")
                return
            if engine is not None and self.path == "/reserve":
                self._reserve_engine()
                return
            if engine is not None and self.path == "/prefill":
                self._prefill_engine()
                return
            if self.path == "/predict" and exported is not None:
                self._predict()
                return
            if self.path != "/generate" or exported is not None:
                self._reply(404, {"error": "use POST /predict or /generate"})
                return
            if predictor is not None:
                self._generate_predictor()
                return
            try:
                self._generate_keyed()
            finally:
                key = self._idem_key
                if key is not None:
                    # the handler died without replying: wake joiners with
                    # no response, so their keyed retries execute again
                    self._idem_key = None
                    idem.abandon(key)

        def _generate_keyed(self):
            """The reference's `X-Idempotency-Key` rule (inference/
            __init__.py:605-632) around the engine's /generate."""
            key = self.headers.get("X-Idempotency-Key")
            if key:
                verdict, val = idem.begin(key)
                if verdict == "done":
                    status, body, hdrs = val
                    self._reply(status, body, {**hdrs, "X-Idempotency-Replay": "hit"})
                    return
                if verdict == "join":
                    resp = idem.wait(val)
                    if resp is None:
                        self._error(503, RuntimeError(
                            "idempotent join aborted; retry with the same key"),
                            retry_after=1.0)
                        return
                    status, body, hdrs = resp
                    self._reply(status, body, {**hdrs, "X-Idempotency-Replay": "join"})
                    return
                self._idem_key = key  # first sight: generate, then cache
            self._generate_engine()

        def _deadline_s(self, req):
            """The request's deadline: the body's `deadline_s`, else the
            `X-Deadline-Ms` hop header (reference: inference/__init__.py:
            365-374)."""
            d = req.get("deadline_s")
            if d is not None:
                return float(d)
            hdr = self.headers.get("X-Deadline-Ms")
            return None if hdr is None else float(hdr) / 1e3

        def _generate_engine(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                ids = req["input_ids"]
                deadline_s = self._deadline_s(req)
                if deadline_s is not None and deadline_s <= 0:
                    # the budget was spent in flight: admit nothing
                    self._reply_error(504, "DeadlineExceeded",
                                      "deadline exhausted before admission", False)
                    return
                spec_k = req.get("spec_k")
                # one request per row of a batched body (reference:
                # inference/__init__.py:414)
                rows = ids if ids and isinstance(ids[0], list) else [ids]
                handles = []
                try:
                    for row in rows:
                        handles.append(engine.submit(
                            row,
                            max_new_tokens=int(req.get("max_new_tokens") or 32),
                            temperature=float(req.get("temperature", 0.0)),
                            eos_token_id=req.get("eos_token_id"),
                            spec_k=None if spec_k is None else int(spec_k),
                            deadline_s=deadline_s,
                            adapter=req.get("adapter"),
                            session_id=req.get("session_id"),
                            handoff=req.get("handoff"),
                            reservation=req.get("reservation"),
                            trace=(self._trace_id, self._handle_sid),
                        ))
                except ContextOverflow as e:  # terminal: no retry holds more
                    self._err = type(e).__name__
                    self._reply(400, {"error": str(e), "type": type(e).__name__,
                                      "retriable": False, "retry_after_s": 0,
                                      "capacity": e.body(),
                                      "trace_id": self._trace_id})
                    return
                except AdapterUnknown as e:
                    # terminal: retrying cannot help until someone registers
                    # the adapter
                    self._reply_error(404, type(e).__name__, str(e), False)
                    return
                except DeadlineUnattainable as e:
                    # 504 but retriable: a less loaded replica may meet it
                    self._reply_error(504, type(e).__name__, str(e), True,
                                      e.retry_after_s)
                    return
                except EngineUnavailable as e:  # queue full, draining, dead
                    self._busy(str(e), retry_after=e.retry_after_s,
                               err_type=type(e).__name__)
                    return
                outs = [h.wait(timeout=600).tolist() for h in handles]
                self._reply(200, {"tokens": outs if isinstance(ids[0], list)
                                  else outs[0]})
            except EngineRestarted as e:  # lost to a restart: safe to retry
                self._busy(str(e), err_type=type(e).__name__)
            except DeadlineExceeded as e:  # the same budget cannot succeed
                self._reply_error(504, type(e).__name__, str(e), False)
            except NonFiniteLogits as e:  # the reference's 500, not retriable
                self._error(500, e)
            except Exception as e:  # a bad body, or a failure inside the engine
                self._error(400, e, msg=f"{type(e).__name__}: {e}")

        def _reserve_engine(self):
            # the decode side's page hold, taken before the prefill starts
            # on another server (reference: inference/__init__.py:464-485)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                ttl = req.get("ttl_s")
                out = engine.reserve_pages(
                    int(req["prompt_len"]), int(req.get("max_new_tokens") or 32),
                    ttl_s=None if ttl is None else float(ttl))
                self._reply(200, out)
            except EngineUnavailable as e:  # QueueFull among them
                self._busy(str(e), retry_after=e.retry_after_s,
                           err_type=type(e).__name__)
            except Exception as e:  # a bad body
                self._error(400, e, msg=f"{type(e).__name__}: {e}")

        def _prefill_engine(self):
            # the prefill hop: one sampled token, then the prompt's rows
            # (reference: inference/__init__.py:487-570)
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                ids = req["input_ids"]
                if ids and isinstance(ids[0], list):
                    self._reply_error(400, "ValueError",
                                      "/prefill takes one prompt per request",
                                      False)
                    return
                deadline_s = self._deadline_s(req)
                if deadline_s is not None and deadline_s <= 0:
                    self._reply_error(504, "DeadlineExceeded",
                                      "deadline exhausted before admission", False)
                    return
                # "export": false, the router's single-token fast path: the
                # sampled token is the whole answer
                want_export = bool(req.get("export", True))
                try:
                    h = engine.submit(
                        ids, max_new_tokens=1,
                        temperature=float(req.get("temperature", 0.0)),
                        eos_token_id=req.get("eos_token_id"),
                        deadline_s=deadline_s,
                        trace=(self._trace_id, self._handle_sid),
                        spec_k=0, export_kv=want_export)
                except DeadlineUnattainable as e:
                    self._reply_error(504, type(e).__name__, str(e), True,
                                      e.retry_after_s)
                    return
                except EngineUnavailable as e:
                    self._busy(str(e), retry_after=e.retry_after_s,
                               err_type=type(e).__name__)
                    return
                out = h.wait(timeout=600)
                if _inj.should_fire("disagg.prefill.crash", "serve./prefill"):
                    # the drill: the payload exists here, but no byte of
                    # the answer leaves (a zero-token retriable failure)
                    self.close_connection = True
                    return
                if not want_export:
                    self._reply(200, {"first_token": int(out[len(ids)]),
                                      "prompt_len": len(ids), "handoff": None})
                    return
                if h.kv_export is None:
                    self._reply_error(
                        503, "HandoffExportFailed",
                        "prefill finished but the page export failed; retry",
                        True)
                    return
                payload = h.kv_export
                self._reply(200, {"first_token": payload.get("first_token"),
                                  "prompt_len": payload["prompt_len"],
                                  "handoff": payload})
            except EngineRestarted as e:
                self._busy(str(e), err_type=type(e).__name__)
            except DeadlineExceeded as e:
                self._reply_error(504, type(e).__name__, str(e), False)
            except NonFiniteLogits as e:
                self._error(500, e)
            except Exception as e:
                self._error(400, e, msg=f"{type(e).__name__}: {e}")

        def _predict(self):
            if not gate.acquire(blocking=False):
                self._error(503, RuntimeError("admission queue full, retry later"),
                            retry_after=1.0)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                with lock:  # one program: its callers run one at a time
                    outs = exported.run(req["inputs"], cast=True)
                self._reply(200, {"outputs": [o.tolist() for o in outs]})
            except Exception as e:  # a bad body or a failing run
                self._error(400, e, msg=f"{type(e).__name__}: {e}")
            finally:
                gate.release()

        def _generate_predictor(self):
            if not gate.acquire(blocking=False):
                self._error(503, RuntimeError("admission queue full, retry later"),
                            retry_after=1.0)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                with lock:
                    toks = predictor.generate(
                        req["input_ids"],
                        max_new_tokens=req.get("max_new_tokens"),
                        temperature=req.get("temperature", 0.0),
                        eos_token_id=req.get("eos_token_id"),
                    )
                self._reply(200, {"tokens": toks.tolist()})
            except Exception as e:  # a bad body or a refused request
                self._error(400, e)
            finally:
                gate.release()

    server = ThreadingHTTPServer((host, port), Handler)
    server.engine = engine
    server.predictor = predictor if exported is None else exported
    server.supervisor = supervisor
    prev_handler = {}

    def restore_handler():
        """Put the previous SIGTERM handler back, unless someone replaced
        ours meanwhile, and take ours out of the chain: a server started
        after this one and stopped later falls back to what ours replaced,
        never to ours, whose server is gone (servers stopped in the order
        they started would otherwise leave the first one's handler
        installed, holding its engine).  Only the main thread may install:
        elsewhere (the drain worker) ours stays for a later stop() on the
        main thread."""
        ours = prev_handler.get("ours")
        with _sigterm_mu:
            if ours not in _sigterm_prev:
                return
            prev = _sigterm_prev[ours]
            try:
                if _signal.getsignal(_signal.SIGTERM) is ours:
                    _signal.signal(_signal.SIGTERM, prev)
            except ValueError:
                return
            del _sigterm_prev[ours]
            for h, p in _sigterm_prev.items():
                if p is ours:
                    _sigterm_prev[h] = prev
        prev_handler.clear()

    def stop():
        if supervisor is not None:
            supervisor.stop()
        server.shutdown()
        server.server_close()
        if engine is not None:
            engine.stop()
        restore_handler()

    def drain(grace=None):
        """Stop admitting (503 + Retry-After), let in-flight work finish
        for up to `grace` seconds, then stop the supervisor, the engine
        and the HTTP loop.  Idempotent; returns the worker thread."""
        if state["draining"]:
            return state["drain_thread"]
        state["draining"] = True
        if grace is None:
            grace = float(os.environ.get("PADDLE_STOP_GRACE",
                                         _fcore.flag("FLAGS_serve_drain_grace")))

        def worker():
            # the process's last orderly moment: the ring goes to disk
            # before in-flight work winds down
            _flight.dump("serve-drain")
            if engine is not None:
                engine.drain()
                deadline = time.monotonic() + float(grace)
                while engine.has_work() and time.monotonic() < deadline:
                    time.sleep(0.02)
            if supervisor is not None:
                supervisor.stop()
            if engine is not None:
                engine.stop()
            server.shutdown()

        t = threading.Thread(target=worker, name="serve-drain", daemon=True)
        state["drain_thread"] = t
        t.start()
        return t

    server.stop = stop
    server.drain = drain
    if handle_signals or handle_signals is None:
        handler = lambda signum, frame: drain()  # noqa: E731
        try:
            with _sigterm_mu:
                _sigterm_prev[handler] = _signal.signal(_signal.SIGTERM, handler)
            prev_handler["ours"] = handler
        except ValueError:  # not the main thread
            if handle_signals:
                raise
    if block:
        try:
            server.serve_forever()
        finally:
            stop()
        return server
    threading.Thread(target=server.serve_forever, name="serve-http",
                     daemon=True).start()
    return server
