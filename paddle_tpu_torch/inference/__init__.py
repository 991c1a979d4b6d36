"""Serving entry point of the port (counterpart of `serve()` in
`paddle_tpu/inference/__init__.py`, cut to the engine's paged greedy path).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import ContextOverflow, ContinuousBatchingEngine, QueueFull

__all__ = ["serve", "ContinuousBatchingEngine", "QueueFull", "ContextOverflow"]


def serve(engine, port=8866, host="127.0.0.1", block=True):
    """Serve a ContinuousBatchingEngine over HTTP (stdlib
    ThreadingHTTPServer), starting its scheduler thread.

    - POST /generate: body {"input_ids": [...], "max_new_tokens": n,
      "temperature": t, "eos_token_id": id} -> {"tokens": prompt +
      generated}.  A full queue answers 503 with a Retry-After header; a
      prompt past the context answers 400.
    - GET /healthz: status, occupancy and queue depth.

    `port=0` binds a free port (read it from `server.server_address`).
    With `block=False` the server runs on a daemon thread and the returned
    server's `stop()` shuts down the HTTP loop and the engine's scheduler.
    """

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
            if self.path == "/healthz":
                h = engine.healthz()
                self._reply(200 if h["status"] in ("ready", "live") else 503, h)
            else:
                self._reply(404, {"error": "use GET /healthz or POST /generate"})

        def do_POST(self):
            if self.path != "/generate":
                self._reply(404, {"error": "use POST /generate"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n))
                handle = engine.submit(
                    req["input_ids"],
                    max_new_tokens=int(req.get("max_new_tokens") or 32),
                    temperature=float(req.get("temperature", 0.0)),
                    eos_token_id=req.get("eos_token_id"),
                )
            except QueueFull as e:
                self._error(503, e, retry_after=e.retry_after_s)
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

    server = ThreadingHTTPServer((host, port), Handler)
    server.engine = engine
    engine.start()

    def stop():
        server.shutdown()
        server.server_close()
        engine.stop()

    server.stop = stop
    if block:
        try:
            server.serve_forever()
        finally:
            server.server_close()
            engine.stop()
        return server
    threading.Thread(target=server.serve_forever, name="serve-http",
                     daemon=True).start()
    return server
