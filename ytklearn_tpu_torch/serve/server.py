"""Stdlib HTTP serving front end: /predict, /healthz, /readyz, /metrics
(the JAX package's ``serve/server.py``).

A ThreadingHTTPServer (one thread per connection) in front of per-model
MicroBatchers: handler threads block on their request's pending handle
while the batcher worker coalesces rows across connections into one
scorer call. The model entry is resolved ONCE per batch, so a
hot reload lands between batches, never inside one.

Endpoints (JSON in/out):

  POST /predict    {"features": {...}} one row, or {"rows": [{...}, ...]};
                   optional "model" (default: the first loaded model) and
                   "deadline_ms". 200 -> {"scores", "predictions",
                   "model", "version"}; 429 overloaded (queue shed),
                   504 deadline expired, 503 draining, 404 unknown model
  GET /healthz     process liveness + health.* sentinel counter summary
  GET /readyz      200 only when models are loaded+warm and not draining
  GET /metrics     obs registry snapshot + request latency p50/p99/p999,
                   queue depth, per-model versions; `?raw=1` adds the
                   (ts, ms) latency-ring samples (fleet union input),
                   `?history=1` adds the per-metric time-series rings,
                   `?models=1` adds the mesh-obs per-model accounting
                   table (scoped counters, latency, burn-sentinel state,
                   cache occupancy, and each model's per-rung `prof`
                   attribution while the profiling plane is on);
                   `?quality=1` the drift plane; `?prof=1` the profiling
                   plane (YTK_PROF): per-model per-rung settled execute
                   time, the build ledger and the phases (enabled:false
                   with empty blocks when the plane is off)
  GET /admin/traces  the request-trace exemplar ring: head-sampled +
                   tail-retained (shed/504/SLO-violating) per-hop traces
                   (obs/trace.py, YTK_TRACE_SAMPLE)
  POST /admin/rollback {"model": name}  swap back to the previously served
                   version and pin (undo a bad continual promotion)
  POST /admin/pin  {"model": name}  freeze the served version (watcher
                   skips it); /admin/unpin re-enables hot reload

SIGTERM (install_signal_handlers) flips /readyz to 503, stops intake,
drains queued requests to completion, then stops the listener — the
load-balancer-friendly shutdown order.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from ..obs import enabled as obs_enabled, inc as obs_inc, snapshot as obs_snapshot, span as obs_span
from ..obs import profiler as obs_profiler
from ..obs import health as obs_health
from ..obs import model_metrics as obs_models
from ..obs import quality as obs_quality
from ..obs import trace as obs_trace
from ..obs.core import REGISTRY as OBS_REGISTRY
from ..obs.heartbeat import start_history_sampler
from ..obs.recorder import thread_guard
from ..resilience import chaos_point
from .batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ScoredRateWindow,
    ServeClosed,
    retry_after_s,
)
from .fleet.aimd import maybe_controller
from .fleet.cache import maybe_cache
from .registry import ModelRegistry, NoPreviousVersion

log = logging.getLogger(__name__)


class _HTTPServer(ThreadingHTTPServer):
    """The stdlib's threading server with a listen backlog of 128 in place
    of its 5: a connection that finds the accept queue full may be reset
    while the accept thread waits for the interpreter (the JAX package
    keeps the stdlib's 5)."""

    request_queue_size = 128


class _LatencyWindow:
    """Bounded ring of recent request latencies -> percentiles.

    Samples are (wall_ts, ms) PAIRS: the export (`/metrics?raw=1`) must
    carry timestamps so the fleet front can WINDOW the ring union — an
    idle replica's ring otherwise holds stale samples forever and dilutes
    the fleet p99 with minutes-old latencies."""

    def __init__(self, maxlen: int = 4096):
        self._ring = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._ring.append((time.time(), ms))

    def raw(self) -> list:
        """[(wall_ts, ms)] pairs — the fleet front unions replica rings
        (windowed on ts) so fleet p99 is computed over every replica's
        RECENT samples, not replica-0's and not stale ones."""
        with self._lock:
            return [[round(t, 3), round(v, 3)] for t, v in self._ring]

    def percentiles(self) -> Dict[str, float]:
        # one percentile implementation serves both the per-process ring
        # and the fleet ring union — the payloads must never diverge
        from .fleet.front import latency_percentiles

        with self._lock:
            vals = [v for _, v in self._ring]
        return latency_percentiles(vals)


class ServeApp:
    """Registry + batchers + HTTP listener; start()/stop() lifecycle."""

    def __init__(
        self,
        registry: ModelRegistry,
        policy: Optional[BatchPolicy] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        slo_ms: Optional[float] = None,
        cache_rows: Optional[int] = None,
        replica_id: Optional[int] = None,
    ):
        self.registry = registry
        self.policy = policy or BatchPolicy()
        self.host = host
        self.port = port
        # slo_ms > 0 arms the AIMD batch-size controller per batcher
        # (serve/fleet/aimd.py); None/0 keeps the fixed policy knobs
        self.slo_ms = slo_ms
        # cache_rows > 0 arms the LRU prediction cache (serve/fleet/cache.py)
        self.cache = maybe_cache(cache_rows if cache_rows is not None else 0)
        # fleet identity: stamped into /metrics so the front (and a
        # postmortem) can name this replica; None = solo process
        self.replica_id = replica_id
        # SLO burn-rate sentinel (health.slo_burn): every request feeds
        # it; a windowed violation rate over budget fires the alarm. The
        # same SLO arms the trace plane's tail rule (SLO-violating
        # requests are always kept as exemplars)
        self.slo_burn = (
            obs_health.SLOBurnSentinel("serve.predict", slo_ms)
            if slo_ms and slo_ms > 0 else None
        )
        if slo_ms and slo_ms > 0:
            obs_trace.configure_tracing(slo_ms=slo_ms)
        self.latency = _LatencyWindow()
        # mesh-obs per-model accounting plane (obs/model_metrics.py):
        # bounded scoped families — counters, latency rings, and burn
        # sentinels keyed by model name, fed at the SAME sites as their
        # global twins (exact conservation). Published as the process
        # default so flight dumps carry the per-model block.
        self.models = obs_models.ModelMetrics(slo_ms=slo_ms)
        for _n in registry.names():
            self.models.register(_n)
        obs_models.set_default(self.models)
        # model-quality monitor (obs/quality.py): the predict path feeds
        # sampled rows + predictions into per-model drift sketches; the
        # evaluator thread (armed in start()) judges them against each
        # model's training sidecar. YTK_QUALITY_SAMPLE=0 disables.
        self.quality = obs_quality.default_monitor()
        # recent scored-rows/s (success path) -> the 429 Retry-After
        # queue-drain estimate (same arithmetic as the fleet front);
        # per-model windows back the model-aware Retry-After hint
        self._scored = ScoredRateWindow()
        self._scored_by_model: Dict[str, ScoredRateWindow] = {}
        self.draining = False
        self._batchers: Dict[str, MicroBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._drain_thread: Optional[threading.Thread] = None
        self._started_at = time.time()

    # -- batching ---------------------------------------------------------

    def batcher_for(self, name: str) -> MicroBatcher:
        """One batcher per model name, created lazily. The score_fn
        resolves the registry entry per BATCH, so every batch is scored by
        exactly one model version (hot-reload atomicity)."""
        with self._batchers_lock:
            b = self._batchers.get(name)
            if b is None:
                def score_fn(rows, _name=name):
                    entry = self.registry.get(_name)
                    scores, preds = entry.scorer.score_and_predict(rows)
                    return scores, preds, entry  # entry = version of record

                controller = None
                if self.slo_ms and self.slo_ms > 0:
                    # AIMD searches over THIS model's ladder, so every
                    # size it picks is already warm
                    controller = maybe_controller(
                        self.registry.get(name).scorer.ladder, self.slo_ms
                    )
                b = MicroBatcher(
                    score_fn, self.policy, controller=controller,
                    # shed/expiry counters mirrored per model at the
                    # batcher's own sites (mesh-obs conservation)
                    model_scope=self.models.register(name),
                )
                self._batchers[name] = b
            return b

    def _rate_for(self, name: str) -> ScoredRateWindow:
        """Per-model scored-rows/s window (model-aware Retry-After)."""
        r = self._scored_by_model.get(name)
        if r is None:
            with self._batchers_lock:
                r = self._scored_by_model.get(name)
                if r is None:
                    r = self._scored_by_model[name] = ScoredRateWindow()
        return r

    def _request_done(self, ms: float) -> None:
        """Per-request bookkeeping shared by every completion path."""
        self.latency.record(ms)
        if self.slo_burn is not None:
            self.slo_burn.observe(ms)

    def retry_after_s(self, model: Optional[str] = None) -> int:
        """429 Retry-After hint: queued rows ÷ recent scored-rows/s
        (clamped to a small bound) — how long the queue actually needs
        to drain before a retry has a chance. When the request named a
        model the estimate uses THAT model's own queue depth and drain
        rate: queues drain per batcher, so a cold model's queue behind a
        hot model would otherwise borrow the hot model's rate and be
        wrong by the traffic ratio. Global aggregate is the fallback."""
        with self._batchers_lock:
            batchers = dict(self._batchers)
            rates = dict(self._scored_by_model)
        if model and model in batchers:
            # the model's own window; empty (no drain evidence yet) ->
            # the clamp bound, the honest worst case
            rate = rates.get(model)
            if rate is None:
                rate = ScoredRateWindow()
            return retry_after_s(batchers[model].queued_rows, rate)
        backlog = sum(b.queued_rows for b in batchers.values())
        return retry_after_s(backlog, self._scored)

    def _request_errored(self, status: int) -> None:
        """429/504 burned SLO budget without ever being scored; a 503
        drain is the server going away, not a burn."""
        if self.slo_burn is not None and status in (429, 504):
            self.slo_burn.observe(violated=True)

    def _observe_quality(self, entry, rows, preds) -> None:
        """Feed the model-quality plane (drift sketches). Failures are
        counted and logged — monitoring must never 500 a request."""
        if not self.quality.enabled():
            return
        try:
            self.quality.observe(entry, rows, preds)
        except Exception as e:  # noqa: BLE001 — monitoring, never the request
            obs_inc("quality.errors")
            log.warning("quality observe failed: %s: %s",
                        type(e).__name__, e)

    def predict(self, rows, model: Optional[str] = None,
                deadline_ms: Optional[float] = None, timeout: float = 30.0,
                trace=None):
        """The serving hot path (HTTP handler and tests both land here).

        `trace` is an obs.trace ctx the HTTP handler began (it owns the
        finish — the response write is part of the trace); direct callers
        leave it None and this method begins/finishes its own, so a bench
        or embedded caller gets the same exemplars the HTTP path does."""
        if self.draining:
            raise ServeClosed("server is draining")
        names = self.registry.names()
        if not names:
            raise KeyError("no models loaded")
        name = model or names[0]
        try:
            entry = self.registry.get(name)  # 404 before enqueue for bad names
        except KeyError:
            # unknown-name accounting lands in the bounded __overflow__
            # family (only registry-loaded names get their own) — a 404
            # name-flood moves one counter, never the family map
            self.models.record_not_found(name)
            raise
        scope = self.models.register(name)
        # fleet restart drill: kind=kill here takes this replica down
        # mid-request, exactly like a hardware loss under load
        chaos_point("serve.worker")
        own = trace is None
        ctx = obs_trace.begin() if own else trace
        t0 = time.perf_counter()
        try:
            cache = self.cache
            if cache is not None:
                hit = cache.lookup(cache.model_key(entry), rows, scope=scope)
                ctx.hop_at("serve.cache", t0, time.perf_counter(),
                           hit=hit is not None, rows=len(rows))
                if hit is not None:
                    # every row of this request was scored before by the
                    # CURRENT entry: bypass the queue entirely (no batcher,
                    # no scorer) — the stored values ARE the scored path's
                    # outputs, so the response is bit-identical to a cold one
                    ms = (time.perf_counter() - t0) * 1e3
                    self._request_done(ms)
                    obs_inc("serve.requests")
                    obs_inc("serve.request_rows", len(rows))
                    self.models.record_request(name, len(rows), ms)
                    preds_hit = np.asarray([h[1] for h in hit])
                    # cache hits are served traffic: the drift sketches
                    # must see the distribution clients actually send
                    self._observe_quality(entry, rows, preds_hit)
                    if own:
                        obs_trace.finish(ctx, status=200, latency_ms=ms,
                                         rows=len(rows), cached=True)
                    return {
                        "model": name,
                        "version": entry.version,
                        "cached": True,
                        "scores": np.asarray([h[0] for h in hit]).tolist(),
                        "predictions": preds_hit.tolist(),
                    }
            pending = self.batcher_for(name).submit(
                rows, deadline_ms=deadline_ms, trace=ctx
            )
            scores, preds = pending.get(timeout)
            if ctx.ids and pending.t_done is not None:
                # completion -> this thread resumed: GIL/scheduler wake
                # latency, a real stage of the request under load
                ctx.hop_at("serve.wake", pending.t_done, time.perf_counter())
        except OverloadError:
            self._request_errored(429)
            self.models.record_violation(name, 429)
            if own:
                obs_trace.finish(ctx, status=429, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except DeadlineExceeded:
            self._request_errored(504)
            self.models.record_violation(name, 504)
            if own:
                obs_trace.finish(ctx, status=504, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except ServeClosed:
            if own:  # a drain is not an SLO burn, but the trace closes
                obs_trace.finish(ctx, status=503, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except Exception:
            # batch error, timeout, anything else: an owned head-sampled
            # trace must still land in the ring (status 500) instead of
            # leaking with its hops unrecorded
            if own:
                obs_trace.finish(ctx, status=500, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        self._request_done(ms)
        # scored-path completions only (a cache hit never drained the
        # queue): the Retry-After estimate wants the queue's drain rate
        self._scored.record(len(rows))
        self._rate_for(name).record(len(rows))
        obs_inc("serve.requests")
        obs_inc("serve.request_rows", len(rows))
        self.models.record_request(name, len(rows), ms)
        # version from the batch's own entry resolution — the response
        # must name the model that actually scored it, not whatever was
        # current at enqueue time (hot-reload race)
        entry = pending.meta or self.registry.get(name)
        # quality plane: keyed by the entry that ACTUALLY scored the
        # batch, like the cache below — a swap between submit and score
        # must not attribute rows to the wrong version's sketches
        self._observe_quality(entry, rows, preds)
        if cache is not None:
            # keyed by the entry that ACTUALLY scored the batch: a swap
            # landing between submit and score must not mislabel rows
            cache.store(cache.model_key(entry), rows, scores, preds,
                        scope=scope)
        if own:
            obs_trace.finish(ctx, status=200, latency_ms=ms, rows=len(rows))
        return {
            "model": name,
            "version": entry.version,
            "scores": np.asarray(scores).tolist(),
            "predictions": np.asarray(preds).tolist(),
        }

    # -- status -----------------------------------------------------------

    def ready(self) -> bool:
        with self._batchers_lock:  # batcher_for inserts concurrently
            batchers = list(self._batchers.values())
        return (
            not self.draining
            and len(self.registry) > 0
            and all(not b.closed for b in batchers)
        )

    def _entry_snapshot(self) -> dict:
        """{name: entry} resolved ONCE per model for a whole payload: a
        scrape racing a hot-reload swap must read each model's fields
        from one entry, never blend pre-swap `version` with post-swap
        `rung` (the registry swaps atomically per name; repeated
        `get(n)` calls inside one payload would not)."""
        out = {}
        for n in self.registry.names():
            try:
                out[n] = self.registry.get(n)
            except KeyError:
                continue  # unloaded between names() and get() — skip
        return out

    def health_payload(self) -> dict:
        counters = obs_snapshot()["counters"]
        return {
            "status": "draining" if self.draining else "ok",
            "uptime_s": round(time.time() - self._started_at, 1),
            "models": {
                n: {"version": entry.version}
                for n, entry in self._entry_snapshot().items()
            },
            "health_events": {
                k: v for k, v in sorted(counters.items())
                if k.startswith("health.") and k.count(".") == 1
            },
        }

    def metrics_payload(self, raw: bool = False, history: bool = False,
                        quality: bool = False, prof: bool = False,
                        models: bool = False) -> dict:
        snap = obs_snapshot()
        with self._batchers_lock:  # batcher_for inserts concurrently
            batchers = dict(self._batchers)
        # one entry per model for the WHOLE payload (models block, prof
        # block, per-model plane): no intra-scrape hot-reload blending
        entries = self._entry_snapshot()
        latency = self.latency.percentiles()
        if raw:
            # the fleet front merges replica rings (union windowed on the
            # sample timestamps, then one percentile pass) — fleet p99
            # must be a fleet number computed over RECENT samples
            latency["raw_ms"] = self.latency.raw()
        out = {
            # identity rides every metrics scrape so the front's fleet
            # table (and a postmortem diffing scrapes) names the replica
            "replica": {"replica_id": self.replica_id, "pid": os.getpid()},
            "latency": latency,
            "queue_depth": {n: b.queue_depth for n, b in batchers.items()},
            "batching": {
                n: (
                    b.controller.snapshot()
                    if b.controller is not None
                    else {"max_batch": self.policy.max_batch,
                          "max_wait_ms": self.policy.max_wait_ms}
                )
                for n, b in batchers.items()
            },
            "models": {
                n: {
                    "version": entry.version,
                    "ladder": list(entry.scorer.ladder),
                    "pinned": self.registry.pinned(n),
                    # effective scoring rung + backend (fused/binned
                    # lowering evidence — serve_bench fleet records it)
                    "rung": entry.scorer.rung_info(),
                }
                for n, entry in entries.items()
            },
            "counters": {k: round(v, 3) for k, v in sorted(snap["counters"].items())},
            "gauges": {k: round(v, 4) for k, v in sorted(snap["gauges"].items())},
        }
        if self.cache is not None:
            out["cache"] = {"rows": len(self.cache),
                            "max_rows": self.cache.max_rows}
        if models:
            # mesh-obs per-model table (`/metrics?models=1`): scoped
            # counters + latency percentiles (+ raw rings under &raw=1 —
            # the fleet front's per-model union input) + sentinel state,
            # joined with per-model cache occupancy
            for n in entries:
                self.models.register(n)  # loaded-but-quiet models show up
            block = self.models.snapshot(raw=raw,
                                         counters=snap["counters"])
            if self.cache is not None:
                occupancy = self.cache.scope_rows()
                for s, mb in block["models"].items():
                    mb["cache_rows"] = occupancy.get(s, 0)
            if obs_profiler.enabled():
                for n, entry in entries.items():
                    mb = block["models"].get(self.models.scope_name(n))
                    if mb is not None:
                        mb["prof"] = entry.scorer.prof_snapshot()
            out["model_metrics"] = block
        if history:
            # metrics history plane: bounded per-metric (ts, value) rings
            # sampled by the obs heartbeat thread (YTK_OBS_HISTORY_N) —
            # {} when the plane is off (obs disabled or N=0)
            out["history"] = OBS_REGISTRY.history_snapshot() or {}
        if quality:
            # model-quality plane: per-model drift/calibration metrics +
            # the serialized serve-side GK sketches the fleet front
            # merges (obs/quality.py; {} when YTK_QUALITY_SAMPLE=0)
            out["quality"] = (
                self.quality.snapshot(include_sketches=True)
                if self.quality.enabled() else {}
            )
        if prof:
            # ytkprof plane (obs/profiler.py): per-model per-rung settled
            # execute-time attribution + the process build ledger —
            # enabled:false with empty blocks when YTK_PROF is off
            out["prof"] = {
                "enabled": obs_profiler.enabled(),
                "models": {
                    n: entry.scorer.prof_snapshot()
                    for n, entry in entries.items()
                },
                "compile": obs_profiler.LEDGER.snapshot(limit=16),
                "phases": obs_profiler.phases_snapshot(),
            }
        return out

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "ServeApp":
        app = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # stderr spam -> logging
                log.debug("http: " + fmt, *args)

            def _json(self, code: int, payload: dict,
                      headers: Optional[Dict[str, str]] = None) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _admin(self, action: str) -> None:
                """Registry version control: rollback / pin / unpin by
                model name (default: the first loaded model)."""
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(req, dict):
                        raise ValueError(
                            "request body must be a JSON object"
                        )
                    names = app.registry.names()
                    if not names:
                        raise KeyError("no models loaded")
                    name = req.get("model") or names[0]
                    if action == "rollback":
                        entry = app.registry.rollback(name)
                        self._json(200, {"model": name, "action": action,
                                         "version": entry.version,
                                         "pinned": True})
                    else:
                        getattr(app.registry, action)(name)
                        self._json(200, {"model": name, "action": action,
                                         "pinned": app.registry.pinned(name)})
                except NoPreviousVersion as e:
                    # the model exists; there is just nothing to roll back
                    # to — not an unknown-name 404
                    self._json(409, {"error": str(e.args[0]),
                                     "type": "no_previous_version"})
                except KeyError as e:
                    self._json(404, {"error": str(e.args[0]),
                                     "type": "unknown_model"})
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e), "type": "bad_request"})

            def do_GET(self):  # noqa: N802 — stdlib handler API
                split = urllib.parse.urlsplit(self.path)
                path = split.path
                query = urllib.parse.parse_qs(split.query)
                if path == "/healthz":
                    self._json(200, app.health_payload())
                elif path == "/readyz":
                    ok = app.ready()
                    self._json(200 if ok else 503,
                               {"ready": ok,
                                "status": "draining" if app.draining else
                                ("ok" if ok else "no models")})
                elif path == "/metrics":
                    raw = query.get("raw", ["0"])[0] not in ("0", "")
                    hist = query.get("history", ["0"])[0] not in ("0", "")
                    qual = query.get("quality", ["0"])[0] not in ("0", "")
                    prof = query.get("prof", ["0"])[0] not in ("0", "")
                    mdl = query.get("models", ["0"])[0] not in ("0", "")
                    self._json(200, app.metrics_payload(
                        raw=raw, history=hist, quality=qual, prof=prof,
                        models=mdl))
                elif path == "/admin/traces":
                    # the per-process exemplar ring: head-sampled + tail-
                    # retained request traces (obs/trace.py); obs_report
                    # merges these cross-process into one waterfall
                    self._json(200, obs_trace.exemplars_payload())
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path in ("/admin/rollback", "/admin/pin",
                                 "/admin/unpin"):
                    self._admin(self.path.rsplit("/", 1)[1])
                    return
                if self.path != "/predict":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                t_parse = time.perf_counter()
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
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e), "type": "bad_request"})
                    return
                # request trace: adopt the front's propagated ids (the
                # X-Ytk-Trace header a forwarded batch carries), else let
                # the head sampler decide; the handler owns begin+finish
                # so parse and response write are part of the trace
                ctx = obs_trace.begin(
                    self.headers.get(obs_trace.TRACE_HEADER)
                )
                ctx.hop_at("serve.parse", t_parse, time.perf_counter(),
                           rows=len(rows))

                def _reply(status: int, payload: dict,
                           headers: Optional[Dict[str, str]] = None) -> None:
                    with ctx.hop("serve.write", status=status):
                        self._json(status, payload, headers=headers)
                    obs_trace.finish(
                        ctx, status=status, rows=len(rows),
                        latency_ms=(time.perf_counter() - t_parse) * 1e3,
                    )

                with obs_span("serve.request", rows=len(rows)):
                    try:
                        out = app.predict(
                            rows,
                            model=req.get("model"),
                            deadline_ms=req.get("deadline_ms"),
                            trace=ctx,
                        )
                    except OverloadError as e:
                        # Retry-After: queue-drain estimate so a shed
                        # client backs off intelligently (clamped);
                        # model-aware when the request named one — the
                        # named model's own queue and drain rate
                        _reply(429, {"error": str(e), "type": "overload"},
                               headers={"Retry-After":
                                        str(app.retry_after_s(
                                            req.get("model")))})
                        return
                    except DeadlineExceeded as e:
                        _reply(504, {"error": str(e), "type": "deadline"})
                        return
                    except ServeClosed as e:
                        _reply(503, {"error": str(e), "type": "draining"})
                        return
                    except KeyError as e:
                        _reply(404, {"error": str(e.args[0]),
                                     "type": "unknown_model"})
                        return
                    except Exception as e:  # noqa: BLE001 — typed 500
                        obs_inc("serve.request_errors")
                        log.exception("predict failed")
                        _reply(500, {"error": f"{type(e).__name__}: {e}",
                                     "type": "internal"})
                        return
                _reply(200, out)

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ytk-serve-http",
            kwargs={"poll_interval": 0.1}, daemon=True,
        )
        self._serve_thread.start()
        if obs_enabled():
            # metrics history plane: per-metric rings sampled by the obs
            # heartbeat thread; /metrics?history=1 exports them (no-op
            # when YTK_OBS_HISTORY_N=0)
            start_history_sampler()
        # quality evaluator: periodic drift/calibration judgement against
        # each model's training sidecar (no-op when YTK_QUALITY_SAMPLE=0)
        obs_quality.start_quality_evaluator()
        log.info("serve: listening on %s:%d (%d model(s))",
                 self.host, self.port, len(self.registry))
        return self

    @thread_guard
    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Graceful by default: refuse new work, finish queued requests,
        then stop the listener and the reload watcher."""
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
