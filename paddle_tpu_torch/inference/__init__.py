"""Serving entry points of the port (counterpart of `GenerationPredictor`
and `serve()` in `paddle_tpu/inference/__init__.py`, cut to the engine's
and the predictor's `/generate` paths).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..framework import core as _fcore
from .engine import ContextOverflow, ContinuousBatchingEngine, QueueFull

__all__ = ["serve", "ContinuousBatchingEngine", "GenerationPredictor",
           "QueueFull", "ContextOverflow"]


class GenerationPredictor:
    """Lock-step generation behind `serve()` (reference: inference/
    __init__.py:126): each request runs the model's `generate` over its
    static KV caches, one request at a time.  Ids come in and go out as
    numpy arrays."""

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
        """One dummy generate on zero ids before traffic: on the card it
        builds the kernels and warms the matmul library and the allocator
        for that geometry.  The weights are only read."""
        ids = np.zeros((int(batch_size), int(prompt_len)), np.int32)
        self.generate(ids, max_new_tokens=max_new_tokens, temperature=temperature)
        return self


def serve(engine, port=8866, host="127.0.0.1", block=True):
    """Serve a ContinuousBatchingEngine or a GenerationPredictor over HTTP
    (stdlib ThreadingHTTPServer); an engine's scheduler thread starts here.

    - POST /generate: body {"input_ids": [...], "max_new_tokens": n,
      "temperature": t, "eos_token_id": id, "spec_k": k} -> {"tokens":
      prompt + generated}.  Engine: `spec_k` caps the request's draft
      length (0 opts out of speculation); a full queue answers 503 with a
      Retry-After header; a prompt past the context answers 400 with the
      engine's capacity geometry under "capacity" (per shard under cp);
      another bad body answers 400.  Predictor: calls to
      the one model run one at a time; beyond FLAGS_serve_queue_depth
      running or waiting requests the server answers 503; a bad body, or a
      request the model refuses, answers 400.
    - GET /healthz: an engine's status, occupancy and queue depth; a
      predictor's {"status": "ready"}.

    `port=0` binds a free port (read it from `server.server_address`).
    With `block=False` the server runs on a daemon thread and the returned
    server's `stop()` shuts down the HTTP loop (and an engine's scheduler).
    """
    predictor = engine if isinstance(engine, GenerationPredictor) else None
    if predictor is not None:
        engine = None
    lock = threading.Lock()  # one model: serialise the predictor's callers
    gate = threading.BoundedSemaphore(int(_fcore.flag("FLAGS_serve_queue_depth")))

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _reply(self, code, payload, headers=None):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _error(self, code, err, retry_after=None):
            headers = {}
            if retry_after is not None:
                headers["Retry-After"] = str(max(1, int(retry_after + 0.5)))
            self._reply(code, {"error": str(err), "type": type(err).__name__,
                               "retriable": retry_after is not None}, headers)

        def do_GET(self):
            if self.path == "/healthz" and predictor is not None:
                self._reply(200, {"status": "ready"})
            elif self.path == "/healthz":
                h = engine.healthz()
                self._reply(200 if h["status"] in ("ready", "live") else 503, h)
            else:
                self._reply(404, {"error": "use GET /healthz or POST /generate"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "use POST /generate"})
                return
            if predictor is not None:
                self._generate_predictor()
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                spec_k = req.get("spec_k")
                handle = engine.submit(
                    req["input_ids"],
                    max_new_tokens=int(req.get("max_new_tokens") or 32),
                    temperature=float(req.get("temperature", 0.0)),
                    eos_token_id=req.get("eos_token_id"),
                    spec_k=None if spec_k is None else int(spec_k),
                )
            except QueueFull as e:
                self._error(503, e, retry_after=e.retry_after_s)
                return
            except ContextOverflow as e:  # terminal: no retry holds more
                self._reply(400, {"error": str(e), "type": type(e).__name__,
                                  "retriable": False, "capacity": e.body()})
                return
            except (ValueError, KeyError, TypeError) as e:  # bad request
                self._error(400, e)
                return
            try:
                out = handle.wait(timeout=600)
            except Exception as e:  # the request failed inside the engine
                self._error(500, e)
                return
            self._reply(200, {"tokens": out.tolist()})

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
    server.predictor = predictor
    if engine is not None:
        engine.start()

    def stop():
        server.shutdown()
        server.server_close()
        if engine is not None:
            engine.stop()

    server.stop = stop
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            if engine is not None:
                engine.stop()
        return server
    threading.Thread(target=server.serve_forever, name="serve-http",
                     daemon=True).start()
    return server
