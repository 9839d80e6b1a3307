"""Dependency-free HTTP JSON API around :class:`.engine.PredictEngine`.

Counterpart of the JAX package's ``serving/server.py``, with the same API:

* ``GET  /health``   → ``{"status": "ok", "model": ..., "subjects": N}``
* ``GET  /subjects`` → ``{"subjects": [...]}``
* ``GET  /subjects/<id>`` → fit metadata: shapes, stored stages, the
  persisted sampling record, held-out scores
* ``POST /predict``  → body ``{"subject": "0", "x": [...], "mode": "map"}``
  (``"mode": "sample"`` with an optional ``"n_sample"``, default 100, draws
  over the stored chain) → ``{"mean": [[...]], "std": ..., "lower": ...,
  "upper": ...}``

Built on the stdlib ``http.server`` (threaded; the engine serializes device
work internally).  An unknown subject, or ``mode="sample"`` for a subject
with no stored chain, gets a 404; a bad request a 400.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import PredictEngine


def _json_bytes(obj) -> bytes:
    def default(o):
        try:
            return o.tolist()
        except AttributeError:
            raise TypeError(f"not JSON-serializable: {type(o)}")

    return json.dumps(obj, default=default).encode()


def make_handler(engine: PredictEngine):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = _json_bytes(obj)
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path == "/health":
                self._reply(
                    200,
                    {
                        "status": "ok",
                        "model": engine.model,
                        "dataset": engine.dataset,
                        "subjects": len(engine.subject_ids()),
                    },
                )
            elif self.path == "/subjects":
                self._reply(200, {"subjects": engine.subject_ids()})
            elif self.path.startswith("/subjects/"):
                sid = self.path[len("/subjects/"):]
                try:
                    self._reply(200, engine.info(sid))
                except KeyError as exc:
                    self._reply(404, {"error": str(exc)})
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                req = json.loads(self.rfile.read(length) or b"{}")
                out = engine.predict(
                    str(req["subject"]),
                    req["x"],
                    mode=req.get("mode", "map"),
                    n_sample=int(req.get("n_sample", 100)),
                )
                self._reply(200, out)
            except KeyError as exc:
                self._reply(404, {"error": str(exc)})
            except (ValueError, TypeError) as exc:
                self._reply(400, {"error": str(exc)})

        def log_message(self, fmt, *args):  # quiet by default
            pass

    return Handler


def serve(
    root: str,
    host: str = "127.0.0.1",
    port: int = 8000,
    model: str = "gnmgp",
    dataset: str = "sim",
    warm: bool = True,
    device=None,
    dtype=None,
) -> ThreadingHTTPServer:
    """Build the engine, optionally warm it, and return a ready server.

    The caller owns the loop: ``serve(...).serve_forever()`` (or run it on a
    thread).  ``port=0`` picks a free port (``server.server_port``).
    ``device`` defaults to ``cuda`` and raises when there is none.
    """
    engine = PredictEngine(root, model=model, dataset=dataset, device=device, dtype=dtype)
    if warm:
        engine.warm()
    httpd = ThreadingHTTPServer((host, port), make_handler(engine))
    httpd.engine = engine  # handy for tests and inspection
    return httpd
