"""Stdlib HTTP serving front end: /predict, /healthz, /readyz.

A ThreadingHTTPServer (one thread per connection) in front of per-model
MicroBatchers: handler threads block on their request's pending handle
while the batcher worker coalesces rows across connections into one scorer
call. The model entry is resolved once per batch.

Endpoints (JSON in/out), as the JAX package's server answers them:

  POST /predict    {"features": {...}} one row, or {"rows": [{...}, ...]};
                   optional "model" (default: the first loaded model) and
                   "deadline_ms". 200 -> {"model", "version", "scores",
                   "predictions"}; 400 bad body, 404 unknown model,
                   429 overloaded (queue shed), 503 draining, 504 deadline
  GET /healthz     process liveness and the loaded model versions
  GET /readyz      200 only when models are loaded and not draining

stop() (and SIGTERM, via install_signal_handlers) flips /readyz to 503,
stops intake, drains queued requests to completion, then stops the
listener. /metrics, /admin/*, the prediction cache, AIMD batch sizing and
quality monitoring come with the rest of serving (ROADMAP.md).
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from .batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ServeClosed,
)
from .registry import ModelRegistry

log = logging.getLogger(__name__)


class ServeApp:
    """Registry + batchers + HTTP listener; start()/stop() lifecycle."""

    def __init__(
        self,
        registry: ModelRegistry,
        policy: Optional[BatchPolicy] = None,
        host: str = "127.0.0.1",
        port: int = 0,
    ):
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.host = host
        self.port = port
        self.draining = False
        self._batchers: Dict[str, MicroBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._drain_thread: Optional[threading.Thread] = None
        self._started_at = time.time()

    def batcher_for(self, name: str) -> MicroBatcher:
        """One batcher per model name, created lazily. The score_fn
        resolves the registry entry per batch, so every batch is scored by
        exactly one model version."""
        with self._batchers_lock:
            b = self._batchers.get(name)
            if b is None:
                def score_fn(rows, _name=name):
                    entry = self.registry.get(_name)
                    scores, preds = entry.scorer.score_and_predict(rows)
                    return scores, preds, entry  # entry = version of record

                b = MicroBatcher(score_fn, self.policy)
                self._batchers[name] = b
            return b

    def predict(self, rows, model: Optional[str] = None,
                deadline_ms: Optional[float] = None, timeout: float = 30.0):
        """The serving hot path (HTTP handler and tests both land here)."""
        if self.draining:
            raise ServeClosed("server is draining")
        names = self.registry.names()
        if not names:
            raise KeyError("no models loaded")
        name = model or names[0]
        self.registry.get(name)  # 404 before enqueue for bad names
        pending = self.batcher_for(name).submit(rows, deadline_ms=deadline_ms)
        scores, preds = pending.get(timeout)
        # the version of the entry that actually scored the batch
        entry = pending.meta or self.registry.get(name)
        return {
            "model": name,
            "version": entry.version,
            "scores": np.asarray(scores).tolist(),
            "predictions": np.asarray(preds).tolist(),
        }

    def ready(self) -> bool:
        with self._batchers_lock:
            batchers = list(self._batchers.values())
        return (
            not self.draining
            and len(self.registry) > 0
            and all(not b.closed for b in batchers)
        )

    def health_payload(self) -> dict:
        models = {}
        for n in self.registry.names():
            try:
                models[n] = {"version": self.registry.get(n).version}
            except KeyError:
                continue  # dropped between names() and get()
        return {
            "status": "draining" if self.draining else "ok",
            "uptime_s": round(time.time() - self._started_at, 1),
            "models": models,
        }

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ServeApp":
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # stderr spam -> logging
                log.debug("http: " + fmt, *args)

            def _json(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib handler API
                if self.path == "/healthz":
                    self._json(200, app.health_payload())
                elif self.path == "/readyz":
                    ok = app.ready()
                    self._json(200 if ok else 503,
                               {"ready": ok,
                                "status": "draining" if app.draining else
                                ("ok" if ok else "no models")})
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path != "/predict":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError("request body must be a JSON object")
                    rows = req.get("rows")
                    if rows is None:
                        feats = req.get("features")
                        if feats is None:
                            raise ValueError(
                                'request needs "features" or "rows"')
                        rows = [feats]
                    if not isinstance(rows, list) or not all(
                        isinstance(r, dict) for r in rows
                    ):
                        raise ValueError('"rows" must be a list of objects')
                except ValueError as e:  # json.JSONDecodeError included
                    self._json(400, {"error": str(e), "type": "bad_request"})
                    return
                try:
                    out = app.predict(
                        rows,
                        model=req.get("model"),
                        deadline_ms=req.get("deadline_ms"),
                    )
                except OverloadError as e:
                    self._json(429, {"error": str(e), "type": "overload"})
                    return
                except DeadlineExceeded as e:
                    self._json(504, {"error": str(e), "type": "deadline"})
                    return
                except ServeClosed as e:
                    self._json(503, {"error": str(e), "type": "draining"})
                    return
                except KeyError as e:
                    self._json(404, {"error": str(e.args[0]),
                                     "type": "unknown_model"})
                    return
                except Exception as e:  # noqa: BLE001 — typed 500
                    log.exception("predict failed")
                    self._json(500, {"error": f"{type(e).__name__}: {e}",
                                     "type": "internal"})
                    return
                self._json(200, out)

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ytk-serve-http",
            kwargs={"poll_interval": 0.1}, daemon=True,
        )
        self._serve_thread.start()
        log.info("serve: listening on %s:%d (%d model(s))",
                 self.host, self.port, len(self.registry))
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful by default: refuse new work, finish queued requests,
        then stop the listener and drop the models."""
        self.draining = True  # readyz flips immediately
        with self._batchers_lock:
            batchers = list(self._batchers.values())
        for b in batchers:
            b.close(drain=drain, timeout=timeout)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        self.registry.close()
        log.info("serve: stopped (drained=%s)", drain)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain (in a thread; the handler must
        return so in-flight handler frames can finish their writes)."""

        def _drain(signum, frame):
            log.info("serve: signal %d, draining", signum)
            self._drain_thread = threading.Thread(
                target=self.stop, kwargs={"drain": True}, daemon=True
            )
            self._drain_thread.start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
