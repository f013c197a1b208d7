"""Shared-nothing serving front: spawn, balance, heal a replica fleet (the
JAX package's ``serve/fleet/front.py``).

One front process owns N replica workers (worker.py), each a complete
single-process port server on its own ephemeral localhost port, scoring
on its own `--device` (on the card, every replica launches K6 or K7 in
its own CUDA context). The front
holds no model state at all — it only moves rows:

  balance    every client request goes WHOLE to one replica — picked by
             least queued rows (forwarder backlog + rows already in HTTP
             flight), so a replica digesting a big batch stops receiving
             before it builds a queue
  coalesce   a per-replica *forwarder* (the same MicroBatcher the replica
             runs internally) packs concurrent client requests into one
             HTTP POST, so front<->replica framing is paid per batch, not
             per request — without it the fleet would be capped by
             per-request HTTP overhead, not by the scorers
  heal       a monitor thread watches child liveness + `/readyz`; a
             crashed or wedged replica is marked dead, its traffic
             reroutes, and the slot is respawned (`serve.worker.died` /
             `serve.worker.restarted` evidence). In-flight batches that
             die with a replica are rerouted to a sibling — the
             transient-vs-fatal split is `resilience.retry.is_transient`
             (a connection reset reroutes; a model bug propagates)
  autoscale  an optional control thread (autoscaler.py) watches windowed
             load signals (forwarder backlog, shed rate, client-visible
             p99 vs the SLO, slo-burn fires) and grows or reaps replica
             slots within `--replicas-min/--replicas-max`. Scale-up rides
             the async spawn machinery; scale-down is DRAIN-BASED: the
             victim is fenced out of `_pick_replica`, its queued batches
             complete or reroute via the crash-reroute path, and only
             then does the worker get the SIGTERM drain it already
             honors — zero requests lost to a reap. Topology is
             copy-on-write (`handles`/`_forwarders` dicts are REPLACED,
             never mutated in place, under `_scale_lock`) so the hot
             balancer/monitor iterations need no lock
  propagate  `/admin/{rollback,pin,unpin}` fan out to every replica, so a
             rollback freezes the WHOLE fleet, not one process. Hot
             reload needs no fan-out: each replica's own registry watcher
             picks up the dump, and every batch is still scored by
             exactly one entry inside one replica — the one-version-per-
             batch guarantee survives fleet-wide because requests are
             never split across replicas
  aggregate  `/metrics` unions the replicas' raw latency rings before
             taking percentiles — fleet p99 is computed over every
             replica's samples (a per-replica p99 cannot be averaged,
             and replica-0's p99 is not the fleet's)

The front's own hot path is pure-python dict/queue work; scoring
parallelism comes from the replica processes (one GIL each). The front
itself touches no device.
"""

from __future__ import annotations

import json
import logging
import signal
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from ...obs import (
    enabled as obs_enabled,
    event as obs_event,
    gauge as obs_gauge,
    inc as obs_inc,
    snapshot as obs_snapshot,
    span as obs_span,
)
from ...obs import health as obs_health
from ...obs import trace as obs_trace
from ...obs.core import REGISTRY as OBS_REGISTRY
from ...obs.heartbeat import start_history_sampler
from ...obs.recorder import thread_guard
from ...resilience import is_transient
from ..batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ScoredRateWindow,
    ServeClosed,
    retry_after_s,
)
from .autoscaler import maybe_autoscaler
from .worker import ReplicaHandle, http_json, spawn_replica, stop_replica

log = logging.getLogger("ytklearn_tpu_torch.serve.fleet")

#: consecutive /readyz failures before a live-but-unresponsive replica is
#: declared wedged and recycled
WEDGE_STRIKES = 3

_JSON_WS = " \t\r\n"
_raw_decoder = json.JSONDecoder()


def extract_raw_rows(body: str) -> Optional[List[str]]:
    """Raw-splice HTTP ingress: slice the client's `"rows"` elements out
    of a `{"rows": [...]}` body as VERBATIM per-row JSON fragments, so the
    front forwards the client's own bytes (str.join in _encode_rows)
    instead of dict-decoding and re-encoding every row per forward. Each
    element is still parsed once (json raw_decode, C speed) for
    validation + its end offset — what disappears is the per-forward
    re-serialization, the front's single biggest GIL cost.

    STRICT shape: exactly one top-level `{"rows": [objects...]}` and
    nothing else — a body carrying `model`/`deadline_ms`/`features`, an
    empty rows list, or anything malformed returns None and takes the
    general parse path, so client-visible semantics are unchanged."""
    i = body.find('"rows"')
    if i < 0 or body[:i].strip() != "{":
        return None
    # O(1) tail pre-check: the strict shape ends `...] }` — a named-model
    # or deadline body (`...],"model":...}`) must bail BEFORE the per-row
    # scan, not after parsing every row twice
    tail = body.rstrip()
    if not tail.endswith("}") or not tail[:-1].rstrip().endswith("]"):
        return None
    n = len(body)
    j = i + 6
    while j < n and body[j] in _JSON_WS:
        j += 1
    if j >= n or body[j] != ":":
        return None
    j += 1
    while j < n and body[j] in _JSON_WS:
        j += 1
    if j >= n or body[j] != "[":
        return None
    j += 1
    frags: List[str] = []
    while True:
        while j < n and body[j] in _JSON_WS:
            j += 1
        if j >= n:
            return None
        if body[j] == "]":
            j += 1
            break
        try:
            obj, end = _raw_decoder.raw_decode(body, j)
        except ValueError:
            return None
        if not isinstance(obj, dict):
            return None
        frags.append(body[j:end])
        j = end
        while j < n and body[j] in _JSON_WS:
            j += 1
        if j < n and body[j] == ",":
            j += 1
        elif j < n and body[j] == "]":
            j += 1
            break
        else:
            return None
    # tail must close the object and nothing more
    while j < n and body[j] in _JSON_WS:
        j += 1
    if j >= n or body[j] != "}":
        return None
    j += 1
    while j < n and body[j] in _JSON_WS:
        j += 1
    if j != n or not frags:
        return None
    return frags


def latency_percentiles(vals: List[float]) -> Dict[str, float]:
    """THE latency-percentile computation — server._LatencyWindow and the
    per-model plane delegate here, so their payloads can't diverge."""
    if not vals:
        return {"count": 0}
    arr = np.asarray(vals)
    return {
        "count": len(vals),
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "p999_ms": round(float(np.percentile(arr, 99.9)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


#: samples older than this drop out of a ring union: an IDLE replica's
#: ring holds its last samples forever, and without windowing those stale
#: latencies dilute the union's p99 with minutes-old traffic
RING_UNION_WINDOW_S = 60.0


def window_ring_ms(
    raw: List, now: float, window_s: float = RING_UNION_WINDOW_S
) -> List[float]:
    """`?raw=1` ring samples -> the ms values recent enough for a ring
    union. Samples are (wall_ts, ms) pairs; bare ms floats pass through —
    no timestamp to window on beats dropping the signal."""
    out: List[float] = []
    for v in raw:
        if isinstance(v, (list, tuple)) and len(v) == 2:
            if now - float(v[0]) <= window_s:
                out.append(float(v[1]))
        elif isinstance(v, (int, float)):
            out.append(float(v))
    return out


def merge_model_metrics(
    replica_blocks: Dict[str, dict], now: float
) -> dict:
    """Fleet per-model table from replica `model_metrics` blocks
    (`/metrics?raw=1&models=1`): per-model latency rings UNION across
    replicas — windowed on sample timestamps like the process-level
    union, keyed by model — plus summed scoped counters, summed
    sentinel fires, per-replica latency sub-blocks, and a top-talker
    ranking by served rows. Pure function (unit-testable without a
    fleet)."""
    models: Dict[str, dict] = {}
    for rid, block in sorted(replica_blocks.items()):
        for name, mb in ((block or {}).get("models") or {}).items():
            agg = models.get(name)
            if agg is None:
                agg = models[name] = {
                    "_ring": [], "counters": {}, "replicas": {},
                }
            lat = dict(mb.get("latency") or {})
            agg["_ring"].extend(
                window_ring_ms(lat.pop("raw_ms", None) or [], now)
            )
            for k, v in (mb.get("counters") or {}).items():
                agg["counters"][k] = round(
                    agg["counters"].get(k, 0.0) + v, 3
                )
            rep = {"latency": lat}
            if "cache_rows" in mb:
                agg["cache_rows"] = (
                    agg.get("cache_rows", 0) + mb["cache_rows"]
                )
                rep["cache_rows"] = mb["cache_rows"]
            slo = mb.get("slo")
            if slo:
                fleet_slo = agg.setdefault(
                    "slo", {"slo_ms": slo.get("slo_ms"),
                            "windows_fired": 0}
                )
                fleet_slo["windows_fired"] += int(
                    slo.get("windows_fired") or 0
                )
                rep["slo"] = slo
            agg["replicas"][str(rid)] = rep
    out_models: Dict[str, dict] = {}
    talkers = []
    for name in sorted(models):
        agg = models[name]
        # fleet percentile over the windowed union — a fleet number,
        # not replica-0's and not an average of per-replica p99s
        agg["latency"] = latency_percentiles(agg.pop("_ring"))
        out_models[name] = agg
        talkers.append({
            "model": name,
            "requests": agg["counters"].get("requests", 0.0),
            "request_rows": agg["counters"].get("request_rows", 0.0),
        })
    talkers.sort(key=lambda t: (-t["request_rows"], -t["requests"],
                                t["model"]))
    total = sum(t["request_rows"] for t in talkers)
    for t in talkers:
        t["share"] = round(t["request_rows"] / total, 4) if total else 0.0
    return {"models": out_models, "top_talkers": talkers}


class FleetFront:
    """Owns the replica fleet; predict()/admin()/metrics_payload() are the
    API, start()/stop() the lifecycle, serve_http() the listener."""

    def __init__(
        self,
        worker_argv: List[str],
        replicas: int,
        policy: Optional[BatchPolicy] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        ready_timeout_s: float = 180.0,
        monitor_interval_s: float = 0.25,
        forward_timeout_s: float = 60.0,
        log_dir: Optional[str] = None,
        slo_ms: Optional[float] = None,
        replicas_min: Optional[int] = None,
        replicas_max: Optional[int] = None,
        autoscale: Optional[dict] = None,
    ):
        if replicas < 1:
            raise ValueError(f"fleet needs >= 1 replica, got {replicas}")
        # autoscaling band: defaults collapse to a fixed fleet of
        # `replicas` (max == min arms nothing: a fixed fleet);
        # the initial size is clamped into the band
        self.replicas_min = int(replicas_min if replicas_min is not None
                                else replicas)
        # a floor above --replicas with no explicit ceiling means "start
        # there": the ceiling follows the larger of the two
        self.replicas_max = int(replicas_max if replicas_max is not None
                                else max(replicas, self.replicas_min))
        if self.replicas_min < 1:
            raise ValueError(
                f"replicas-min must be >= 1, got {self.replicas_min}")
        if self.replicas_max < self.replicas_min:
            raise ValueError(
                f"replicas-max {self.replicas_max} < replicas-min "
                f"{self.replicas_min}")
        replicas = min(max(replicas, self.replicas_min), self.replicas_max)
        self.worker_argv = list(worker_argv)
        self.n_replicas = replicas
        self.policy = policy or BatchPolicy()
        self.host = host
        self.port = port
        self.ready_timeout_s = ready_timeout_s
        self.monitor_interval_s = monitor_interval_s
        self.forward_timeout_s = forward_timeout_s
        self.log_dir = log_dir
        # fleet-level SLO burn-rate sentinel over the front's own client-
        # visible latency (health.slo_burn, site serve.front); the same
        # SLO arms the trace tail rule
        self.slo_ms = slo_ms
        self.slo_burn = (
            obs_health.SLOBurnSentinel("serve.front", slo_ms)
            if slo_ms and slo_ms > 0 else None
        )
        if slo_ms and slo_ms > 0:
            obs_trace.configure_tracing(slo_ms=slo_ms)
        self.handles: Dict[int, ReplicaHandle] = {}
        self._forwarders: Dict[int, MicroBatcher] = {}
        # rows currently inside an HTTP round-trip per replica; updated
        # under a lock (dict read-modify-write is several bytecodes — a
        # lost update would skew least-queued-rows balancing FOREVER, the
        # counter is never reconciled); touched once per forwarded batch,
        # not per request, so the lock is off the per-request path
        self._inflight: Dict[int, int] = {}
        self._inflight_lock = threading.Lock()
        self._strikes: Dict[int, int] = {}
        self._restart_not_before: Dict[int, float] = {}
        # async-respawn threads by slot: the MONITOR thread inserts while
        # stop() (main thread or a signal-handler thread) sweeps the dict
        # to join them — an insert landing mid-iteration is a
        # RuntimeError("dictionary changed size during iteration") that
        # would abort the drain and orphan the freshly-spawned worker, so
        # both sides hold one lock (ytklint unguarded-shared-write)
        self._respawns: Dict[int, threading.Thread] = {}
        self._respawns_lock = threading.Lock()
        # topology writes (slot add/remove after start) are serialized
        # here; `handles`/`_forwarders` are COPY-ON-WRITE — writers
        # publish a NEW dict, so the balancer/monitor/metrics threads
        # iterate their stable snapshot without taking any lock
        self._scale_lock = threading.Lock()
        # recent scored-rows/s (success path) -> the 429 Retry-After
        # queue-drain estimate, and the autoscaler's throughput context
        self._scored = ScoredRateWindow()
        # load-driven autoscaler (autoscaler.py); armed in start() when
        # the band is real (replicas_max > replicas_min)
        self.autoscaler = maybe_autoscaler(
            self, self.replicas_min, self.replicas_max, slo_ms=slo_ms,
            params=autoscale,
        )
        self.latency = None  # front-side client-visible ring, set in start()
        self.draining = False
        self._closing = False
        self._monitor: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._serve_thread: Optional[threading.Thread] = None
        self._started_at = time.time()

    # -- lifecycle --------------------------------------------------------

    def start(self) -> "FleetFront":
        from ..server import _LatencyWindow  # shared ring implementation

        self.latency = _LatencyWindow()
        errors: Dict[int, BaseException] = {}

        @thread_guard
        def _spawn(rid: int) -> None:
            try:
                h = spawn_replica(
                    self.worker_argv, rid, env=None, log_dir=self.log_dir,
                    ready_timeout_s=self.ready_timeout_s,
                )
                self.handles[rid] = h
            except Exception as e:  # noqa: BLE001 — collected and re-raised below
                errors[rid] = e

        threads = [
            threading.Thread(target=_spawn, args=(rid,), daemon=True,
                             name=f"ytk-fleet-spawn-{rid}")
            for rid in range(self.n_replicas)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            for h in self.handles.values():
                stop_replica(h, timeout_s=10.0)
            rid, err = sorted(errors.items())[0]
            raise RuntimeError(
                f"fleet startup failed: replica {rid}: {err}"
            ) from err
        with self._scale_lock:  # same discipline as the scale_up publisher
            for rid in range(self.n_replicas):
                self._forwarders[rid] = MicroBatcher(
                    self._make_score_fn(rid), self.policy, trace_site="front"
                )
                with self._inflight_lock:
                    self._inflight[rid] = 0
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="ytk-fleet-monitor", daemon=True
        )
        self._monitor.start()
        if obs_enabled():
            start_history_sampler()  # /metrics?history=1 on the front
        # LIVE ready-slot gauge (not a set-once startup constant): every
        # health/topology transition republishes it, so the metrics
        # history plane renders crashes and scale ramps as a time series
        self._publish_replica_gauge()
        if self.autoscaler is not None:
            self.autoscaler.start()
        log.info("fleet: %d replica(s) up: %s", self.n_replicas,
                 {rid: h.port for rid, h in sorted(self.handles.items())})
        return self

    @thread_guard
    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        self.draining = True
        self._closing = True
        self._stop_evt.set()
        if self.autoscaler is not None:
            # a tick mid-scale-down finishes its drain before exiting;
            # scale_up threads ride _respawns and are joined below
            self.autoscaler.stop(timeout=timeout + 30.0)
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        # in-flight respawns see _closing (spawn abort + early h.proc
        # publication) — join them so no freshly-spawned worker outlives us
        with self._respawns_lock:
            respawns = list(self._respawns.values())
        for t in respawns:
            t.join(timeout=15.0)
        for f in self._forwarders.values():
            f.close(drain=drain, timeout=timeout)
        stoppers = [
            threading.Thread(target=stop_replica, args=(h, timeout),
                             daemon=True)
            for h in self.handles.values()
        ]
        for t in stoppers:
            t.start()
        for t in stoppers:
            t.join(timeout=timeout + 10.0)
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        log.info("fleet: stopped (drained=%s)", drain)

    # -- forwarding -------------------------------------------------------

    def _ready_ids(self) -> List[int]:
        return [rid for rid, h in self.handles.items() if h.state == "ready"]

    def _load_of(self, rid: int) -> int:
        f = self._forwarders.get(rid)
        queued = f._queued_rows if f is not None else 0
        return queued + self._inflight.get(rid, 0)

    def _pick_replica(self) -> int:
        """Least-queued-rows among ready replicas. Hand-rolled single pass
        (no list builds, no bound-method calls): this runs once per client
        request and showed up in the fleet bench profile."""
        best = -1
        best_load = None
        inflight = self._inflight
        forwarders = self._forwarders
        for rid, h in self.handles.items():
            if h.state != "ready":
                continue
            f = forwarders.get(rid)
            load = ((f._queued_rows if f is not None else 0)
                    + inflight.get(rid, 0))
            if best_load is None or load < best_load:
                best, best_load = rid, load
        if best < 0:
            raise ServeClosed("no ready replica (fleet restarting?)")
        return best

    @staticmethod
    def _encode_rows(rows, model: Optional[str] = None,
                     deadline_ms: Optional[float] = None) -> str:
        """Forward-body encoder with a raw-splice fast path: a row may be
        a feature dict OR a pre-serialized JSON object string (what an
        HTTP gateway already holds as request bytes, and what the fleet
        bench pre-encodes). Splicing fragments is a C-speed str.join;
        re-encoding 512 row dicts per batch was the front's single
        biggest GIL cost (14 us a row in the reference's fleet bench)."""
        parts = [r if isinstance(r, str) else json.dumps(r) for r in rows]
        body = '{"rows":[' + ",".join(parts) + "]"
        if model is not None:
            body += ',"model":' + json.dumps(model)
        if deadline_ms is not None and deadline_ms > 0:
            body += ',"deadline_ms":' + json.dumps(round(deadline_ms, 3))
        return body + "}"

    def _post_predict(self, rid: int, rows, model: Optional[str] = None,
                      deadline_ms: Optional[float] = None,
                      trace_ids: Optional[List[str]] = None) -> tuple:
        """One POST to replica `rid`; raises typed errors for non-200.
        Trace-context propagation: the sampled trace ids of this batch
        (explicit `trace_ids` on the direct named-model path, else the
        forwarder's current batch) ride the X-Ytk-Trace header, so the
        replica adopts them and one trace id spans front -> replica."""
        h = self.handles.get(rid)
        if h is None:
            # the slot was scaled away between pick and POST: surface it
            # as a connection-class loss so the caller's transient path
            # reroutes — a KeyError here would masquerade as a 404
            raise ConnectionResetError(f"replica {rid} was scaled away")
        ids = trace_ids or obs_trace.current_batch_ids()
        headers = {obs_trace.TRACE_HEADER: ",".join(ids)} if ids else None
        with self._inflight_lock:
            self._inflight[rid] = self._inflight.get(rid, 0) + len(rows)
        try:
            # the HTTP forward hop: for a coalesced batch this lands on
            # every traced request via the batch staging (no-op when the
            # batch carries no sampled trace)
            with obs_trace.batch_hop("front.forward", replica=rid,
                                     rows=len(rows)):
                status, body = http_json(
                    "POST", h.port, "/predict",
                    self._encode_rows(rows, model, deadline_ms),
                    timeout=self.forward_timeout_s,
                    headers=headers,
                )
        finally:
            with self._inflight_lock:
                # key-presence guard: a scale-down removes the slot only
                # after this counter reads zero, but a named-model POST
                # that picked the victim just before the fence must not
                # resurrect the entry with a negative count
                if rid in self._inflight:
                    self._inflight[rid] -= len(rows)
        if status == 200:
            meta = {
                "version": body.get("version"),
                "model": body.get("model"),
                "replica_id": rid,
                "cached": bool(body.get("cached")),
            }
            return (
                np.asarray(body["scores"]),
                np.asarray(body["predictions"]),
                meta,
            )
        err = body.get("error", f"replica {rid} HTTP {status}")
        if status == 429:
            raise OverloadError(err)
        if status == 504:
            raise DeadlineExceeded(err)
        if status == 503:
            # replica draining (it got a SIGTERM the front didn't send):
            # treat like a connection-level loss -> reroute
            raise ConnectionResetError(f"replica {rid} draining: {err}")
        if status == 404:
            raise KeyError(err)
        raise RuntimeError(f"replica {rid} HTTP {status}: {err}")

    def _make_score_fn(self, rid: int):
        def score_fn(rows):
            h = self.handles.get(rid)  # may be scaled away mid-drain
            if h is not None and h.state == "ready":
                try:
                    return self._post_predict(rid, rows)
                except Exception as e:
                    if not is_transient(e):
                        raise
                    # connection-level loss mid-call: the replica died (or
                    # is draining) with our batch in flight — mark it for
                    # the monitor and move the batch to a sibling; the
                    # client never sees the failure
                    self._note_sick(rid, e)
                    return self._reroute(rows, exclude=rid, cause=e)
            return self._reroute(rows, exclude=rid, cause=None)

        return score_fn

    def _reroute(self, rows, exclude: int, cause,
                 model: Optional[str] = None,
                 trace_ids: Optional[List[str]] = None) -> tuple:
        """Forward `rows` to the least-loaded OTHER ready replica, walking
        the fleet until one answers. Exhaustion re-raises the cause.
        `trace_ids` keeps context propagation alive across the reroute —
        the rerouted request is exactly the one whose trace matters most
        (on the forwarder path the batch staging supplies them instead)."""
        tried = {exclude}
        while True:
            ready = [r for r in self._ready_ids() if r not in tried]
            if not ready:
                if cause is not None:
                    raise cause
                gone = self.handles.get(exclude)
                raise ServeClosed(
                    f"no ready replica to reroute to (replica {exclude} "
                    f"is {gone.state if gone is not None else 'scaled away'})"
                )
            rid = min(ready, key=self._load_of)
            tried.add(rid)
            try:
                out = self._post_predict(rid, rows, model,
                                         trace_ids=trace_ids)
            except Exception as e:
                if not is_transient(e):
                    raise
                self._note_sick(rid, e)
                cause = e
                continue
            obs_inc("serve.front.reroutes")
            obs_event(
                "serve.front.reroute", to_replica=rid, from_replica=exclude,
                rows=len(rows),
                cause=type(cause).__name__ if cause else "not_ready",
            )
            return out

    def _note_sick(self, rid: int, exc: BaseException) -> None:
        h = self.handles.get(rid)
        if h is None or h.state != "ready":
            return
        h.state = "dead"
        self._publish_replica_gauge()
        obs_inc("serve.worker.died")
        obs_event(
            "serve.worker.died", replica_id=rid, pid=h.pid,
            rc=h.proc.poll() if h.proc is not None else None,
            error=f"{type(exc).__name__}: {exc}"[:200],
        )
        log.warning("fleet: replica %d marked dead (%s: %s)",
                    rid, type(exc).__name__, exc)

    # -- the client-facing hot path ---------------------------------------

    def submit(self, rows, deadline_ms: Optional[float] = None, trace=None):
        """Async half of predict() for the default model: route to the
        least-loaded ready replica's forwarder; returns the pending handle
        (a load generator can keep a bounded in-flight window through this).
        `trace` rides the pending handle into the forwarder (queue-wait
        hop + batch-scoped forward hop + header propagation).

        A scale-down can fence the picked replica between the pick and
        the forwarder call (its forwarder raises ServeClosed, or the slot
        is already gone): the FLEET is not draining, so re-pick instead
        of surfacing a spurious 503 — the zero-requests-lost reap
        contract covers this window too."""
        while True:
            if self.draining:
                raise ServeClosed("fleet front is draining")
            rid = self._pick_replica()  # raises ServeClosed when none ready
            f = self._forwarders.get(rid)
            if f is None:
                continue  # slot scaled away between pick and lookup
            try:
                return f.submit(rows, deadline_ms=deadline_ms, trace=trace)
            except ServeClosed:
                # the victim's forwarder closed under the scale-down
                # fence; OverloadError (a real shed) propagates
                continue

    def _request_done(self, ms: float) -> None:
        self.latency.record(ms)
        if self.slo_burn is not None:
            self.slo_burn.observe(ms)

    def _request_errored(self, status: int) -> None:
        if self.slo_burn is not None and status in (429, 504):
            self.slo_burn.observe(violated=True)

    def predict(self, rows, model: Optional[str] = None,
                deadline_ms: Optional[float] = None, timeout: float = 60.0,
                trace=None):
        """Same contract as ServeApp.predict, plus `replica` in the reply.
        Requests go WHOLE to one replica (never split), which resolves the
        model name — a typo still 404s (KeyError) end to end. Deadlines:
        the named-model path forwards `deadline_ms` to the replica; on the
        coalesced path it is enforced at the FRONT's queue (dequeue-time
        504), which in the fleet topology is where queueing happens — each
        replica receives one pre-coalesced batch at a time, so its own
        queue wait is ~zero. `trace` follows the ServeApp.predict
        contract: the HTTP handler owns begin/finish, direct callers get
        their own."""
        if self.draining:
            raise ServeClosed("fleet front is draining")
        own = trace is None
        ctx = obs_trace.begin() if own else trace
        t0 = time.perf_counter()
        try:
            if model is not None:
                # named-model requests skip the coalescer (the common CLI
                # fleet serves one default model): direct, still whole
                rid = self._pick_replica()
                try:
                    with ctx.hop("front.forward", replica=rid,
                                 rows=len(rows)):
                        scores, preds, meta = self._post_predict(
                            rid, rows, model, deadline_ms,
                            trace_ids=list(ctx.ids),
                        )
                except Exception as e:
                    if not is_transient(e):
                        raise
                    self._note_sick(rid, e)
                    with ctx.hop("front.forward", rerouted=True,
                                 rows=len(rows)):
                        scores, preds, meta = self._reroute(
                            rows, exclude=rid, cause=e, model=model,
                            trace_ids=list(ctx.ids),
                        )
            else:
                pending = self.submit(rows, deadline_ms=deadline_ms,
                                      trace=ctx)
                scores, preds = pending.get(timeout)
                if ctx.ids and pending.t_done is not None:
                    # forwarder completion -> handler resumed: the GIL/
                    # scheduler wake gap, named so a loaded front's p99
                    # decomposition accounts for it
                    ctx.hop_at("front.wake", pending.t_done,
                               time.perf_counter())
                meta = pending.meta or {}
        except OverloadError:
            self._request_errored(429)
            if own:
                obs_trace.finish(ctx, status=429, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except DeadlineExceeded:
            self._request_errored(504)
            if own:
                obs_trace.finish(ctx, status=504, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except ServeClosed:
            if own:
                obs_trace.finish(ctx, status=503, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except KeyError:
            if own:  # unknown model name propagated from the replica
                obs_trace.finish(ctx, status=404, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        except Exception:
            # reroute exhaustion / non-transient replica error: close an
            # owned trace as a 500 exemplar instead of leaking it
            if own:
                obs_trace.finish(ctx, status=500, rows=len(rows),
                                 latency_ms=(time.perf_counter() - t0) * 1e3)
            raise
        ms = (time.perf_counter() - t0) * 1e3
        self._request_done(ms)
        self._scored.record(len(rows))  # drain-rate evidence for Retry-After
        obs_inc("serve.front.requests")
        obs_inc("serve.front.request_rows", len(rows))
        if own:
            obs_trace.finish(ctx, status=200, latency_ms=ms, rows=len(rows))
        out = {
            "model": meta.get("model"),
            "version": meta.get("version"),
            "replica": meta.get("replica_id"),
            "scores": np.asarray(scores).tolist(),
            "predictions": np.asarray(preds).tolist(),
        }
        if meta.get("cached"):
            out["cached"] = True  # the replica answered from its cache
        return out

    # -- healing ----------------------------------------------------------

    @thread_guard
    def _monitor_loop(self) -> None:
        while not self._stop_evt.wait(self.monitor_interval_s):
            for rid, h in list(self.handles.items()):
                if self._closing:
                    return
                try:
                    if h.state == "ready":
                        self._check_replica(rid, h)
                    elif h.state == "dead":
                        self._maybe_restart(rid, h)
                except Exception:  # noqa: BLE001 — the monitor must survive
                    log.exception("fleet: monitor pass for replica %d crashed",
                                  rid)

    def _check_replica(self, rid: int, h: ReplicaHandle) -> None:
        if not h.alive():
            self._note_sick(rid, ConnectionResetError(
                f"worker process exited rc={h.proc.returncode}"
            ))
            return
        try:
            status, _ = http_json("GET", h.port, "/readyz", timeout=2.0)
            ok = status == 200
        except OSError:
            ok = False
        if ok:
            self._strikes[rid] = 0
            return
        self._strikes[rid] = self._strikes.get(rid, 0) + 1
        if self._strikes[rid] >= WEDGE_STRIKES:
            # alive but unresponsive: recycle it like a crash (kill first
            # so the old process can't come back and double-serve)
            log.warning("fleet: replica %d wedged (%d strikes); recycling",
                        rid, self._strikes[rid])
            if h.proc is not None and h.proc.poll() is None:
                h.proc.kill()
                h.proc.wait(timeout=10.0)
            self._strikes[rid] = 0
            self._note_sick(rid, TimeoutError("readyz unresponsive (wedged)"))

    def _maybe_restart(self, rid: int, h: ReplicaHandle) -> None:
        """Launch an ASYNC respawn for a dead slot. The spawn itself (torch
        import, kernel load + ladder warmup, seconds for a real worker) must
        not run on the monitor thread: while one replica respawns, the
        monitor has to keep detecting crashes/wedges on the others."""
        if self.handles.get(rid) is not h:
            # the slot was scaled away while this monitor pass held its
            # pre-removal snapshot (stop_replica flips the reaped handle
            # to "dead" at the end of its drain): a respawn here would be
            # an ORPHAN worker no topology references — not ours to heal
            return
        if time.monotonic() < self._restart_not_before.get(rid, 0.0):
            return
        h.state = "starting"  # monitor + balancer skip; no double spawn
        t = threading.Thread(
            target=self._do_restart, args=(rid, h),
            name=f"ytk-fleet-respawn-{rid}", daemon=True,
        )
        with self._respawns_lock:
            # publish AND start under the lock: a stop() sweep that
            # snapshots after the insert must never join a not-yet-
            # started thread (RuntimeError) — start() is sub-ms
            self._respawns[rid] = t
            t.start()

    @thread_guard
    def _do_restart(self, rid: int, h: ReplicaHandle) -> None:
        # reap the corpse before respawning the slot
        if h.proc is not None and h.proc.poll() is None:
            h.proc.kill()
            h.proc.wait(timeout=10.0)
        h.restarts += 1
        try:
            spawn_replica(
                self.worker_argv, rid, handle=h, log_dir=self.log_dir,
                ready_timeout_s=self.ready_timeout_s,
                abort=lambda: self._closing,
            )
        except Exception as e:  # noqa: BLE001 — retry next tick with backoff
            delay = min(30.0, 1.0 * (2 ** min(h.restarts, 5)))
            self._restart_not_before[rid] = time.monotonic() + delay
            h.state = "dead"  # back to the monitor's restart queue
            log.error(
                "fleet: restart of replica %d failed (%s: %s); next attempt "
                "in %.0fs", rid, type(e).__name__, e, delay,
            )
            return
        if self._closing:
            # the fleet shut down while this worker was warming: it must
            # not outlive the front as an orphan
            stop_replica(h, timeout_s=10.0)
            return
        self._strikes[rid] = 0
        self._restart_not_before.pop(rid, None)
        self._publish_replica_gauge()
        obs_inc("serve.worker.restarted")
        obs_event(
            "serve.worker.restarted", replica_id=rid, pid=h.pid,
            port=h.port, restarts=h.restarts,
        )
        log.info("fleet: replica %d restarted (pid=%d port=%d, restart #%d)",
                 rid, h.pid, h.port, h.restarts)

    # -- autoscaling (autoscaler.py drives these) --------------------------

    def _publish_replica_gauge(self) -> None:
        """serve.fleet.replicas tracks the LIVE ready-slot count — fed to
        the metrics history plane so a ramp or a crash renders as a
        time series, not a startup constant."""
        obs_gauge("serve.fleet.replicas", len(self._ready_ids()))

    def scale_up(self, reason: Optional[dict] = None) -> bool:
        """Add one replica slot (async spawn — the replica's warmup must not
        block the caller, exactly like the crash-respawn path). The slot
        is published "starting" immediately so it counts against
        `replicas_max` and defers further decisions until it lands."""
        with self._scale_lock:
            if self._closing:
                return False
            if len(self.handles) >= self.replicas_max:
                return False
            rid = max(self.handles) + 1 if self.handles else 0
            h = ReplicaHandle(rid)  # state "starting"
            handles = dict(self.handles)
            handles[rid] = h
            forwarders = dict(self._forwarders)
            forwarders[rid] = MicroBatcher(
                self._make_score_fn(rid), self.policy, trace_site="front"
            )
            # publish copy-on-write: concurrent balancer/monitor passes
            # keep iterating their old snapshot; the new slot appears
            # atomically and stays unpicked until "ready"
            self.handles = handles
            self._forwarders = forwarders
            with self._inflight_lock:
                self._inflight[rid] = 0
            t = threading.Thread(
                target=self._do_scale_spawn, args=(rid, h, reason),
                name=f"ytk-fleet-scale-up-{rid}", daemon=True,
            )
            with self._respawns_lock:
                # same publish+start-under-lock discipline as
                # _maybe_restart: stop() joins these threads
                self._respawns[rid] = t
                t.start()
        log.info("fleet: scaling up -> slot %d spawning", rid)
        return True

    @thread_guard
    def _do_scale_spawn(self, rid: int, h: ReplicaHandle,
                        reason: Optional[dict]) -> None:
        try:
            spawn_replica(
                self.worker_argv, rid, handle=h, log_dir=self.log_dir,
                ready_timeout_s=self.ready_timeout_s,
                abort=lambda: self._closing,
            )
        except Exception as e:  # noqa: BLE001 — failed grow: slot removed, policy re-decides
            obs_event(
                "serve.scale.up_failed", replica_id=rid,
                error=f"{type(e).__name__}: {e}"[:200],
            )
            log.error("fleet: scale-up spawn for slot %d failed (%s: %s)",
                      rid, type(e).__name__, e)
            self._remove_slot(rid, drain_forwarder=False)
            return
        if self._closing:
            # fleet shut down while the new worker warmed: no orphans
            stop_replica(h, timeout_s=10.0)
            return
        self._publish_replica_gauge()
        obs_event("serve.scale.up_ready", replica_id=rid, pid=h.pid,
                  port=h.port, replicas=len(self._ready_ids()))
        log.info("fleet: scale-up complete — replica %d ready "
                 "(pid=%s port=%d)", rid, h.pid, h.port)

    def scale_down(self, reason: Optional[dict] = None,
                   timeout: float = 30.0) -> Optional[int]:
        """Reap one replica slot, DRAIN-BASED — zero requests lost:

          1. fence: the victim (highest-rid ready slot) flips to
             "draining", so `_pick_replica` stops routing to it and the
             monitor ignores it (it only acts on ready/dead)
          2. drain: its forwarder is closed with drain=True — batches
             already POSTed complete normally, queued batches hit the
             score_fn's not-ready branch and REROUTE to a sibling (the
             crash-reroute path, minus the crash)
          3. settle: wait for the in-HTTP-flight row count to reach zero
             (a named-model POST that picked the victim pre-fence)
          4. remove: the slot leaves the topology (copy-on-write), THEN
             the worker gets the SIGTERM drain it already honors —
             removed first, so the monitor can never see the corpse and
             respawn it

        Returns the reaped replica id, or None when nothing was safely
        reapable (at min, last ready replica, or closing)."""
        with self._scale_lock:
            if self._closing:
                return None
            ready = sorted(self._ready_ids())
            if len(ready) <= max(1, self.replicas_min):
                return None
            rid = ready[-1]
            h = self.handles[rid]
            h.state = "draining"  # the fence
        self._publish_replica_gauge()
        obs_event("serve.scale.drain", replica_id=rid, pid=h.pid,
                  **(reason or {}))
        f = self._forwarders.get(rid)
        if f is not None:
            f.close(drain=True, timeout=timeout)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._inflight_lock:
                left = self._inflight.get(rid, 0)
            if left <= 0:
                break
            time.sleep(0.01)
        self._remove_slot(rid, drain_forwarder=False)  # already drained
        stop_replica(h, timeout_s=timeout, reason="scale_down")
        obs_event("serve.scale.down_done", replica_id=rid,
                  replicas=len(self._ready_ids()))
        log.info("fleet: scale-down complete — replica %d drained and "
                 "stopped", rid)
        return rid

    def _remove_slot(self, rid: int, drain_forwarder: bool) -> None:
        """Take a slot out of the topology (copy-on-write republish)."""
        with self._scale_lock:
            handles = dict(self.handles)
            handles.pop(rid, None)
            forwarders = dict(self._forwarders)
            f = forwarders.pop(rid, None)
            self.handles = handles
            self._forwarders = forwarders
        with self._inflight_lock:
            self._inflight.pop(rid, None)
        # per-slot health state must not leak onto a future slot reusing
        # this rid (scale-up allocates max(handles)+1, which can match a
        # previously reaped id); the monitor only touches rids still in
        # `handles`, so these pops cannot race a same-key write
        self._strikes.pop(rid, None)
        self._restart_not_before.pop(rid, None)
        if f is not None:
            # always release the forwarder's worker thread; drain=False on
            # the failed-spawn path (nothing was ever routed there), and a
            # second close after scale_down's drain is a no-op join
            f.close(drain=drain_forwarder, timeout=10.0)
        self._publish_replica_gauge()

    def retry_after_s(self) -> int:
        """429 Retry-After hint: fleet backlog ÷ recent scored-rows/s
        (clamped) — how long the queues actually need to drain."""
        backlog = sum(self._load_of(rid) for rid in self._ready_ids())
        return retry_after_s(backlog, self._scored)

    # -- admin fan-out ----------------------------------------------------

    def admin(self, action: str, model: Optional[str] = None):
        """POST /admin/<action> to every ready replica -> (all_ok, detail).
        pin/rollback must land fleet-wide: one unpinned replica would keep
        re-promoting the model the operator just rolled back."""
        results: Dict[str, dict] = {}
        ok = True
        for rid, h in sorted(self.handles.items()):
            if h.state != "ready":
                results[str(rid)] = {"skipped": h.state}
                ok = False
                continue
            try:
                status, body = http_json(
                    "POST", h.port, f"/admin/{action}",
                    {"model": model} if model else {}, timeout=30.0,
                )
            except OSError as e:
                status, body = 0, {"error": f"{type(e).__name__}: {e}"}
            results[str(rid)] = {"status": status, **body}
            ok = ok and status == 200
        obs_event("serve.fleet.admin", action=action, ok=ok)
        return ok, results

    # -- status / metrics -------------------------------------------------

    def ready(self) -> bool:
        return not self.draining and bool(self._ready_ids())

    def health_payload(self) -> dict:
        return {
            "status": "draining" if self.draining else (
                "ok" if self.ready() else "degraded"),
            "uptime_s": round(time.time() - self._started_at, 1),
            "replicas": {
                str(rid): {"state": h.state, "pid": h.pid,
                           "restarts": h.restarts}
                for rid, h in sorted(self.handles.items())
            },
        }

    def _scrape_replica(self, rid: int, h: ReplicaHandle,
                        quality: bool = False, prof: bool = False,
                        models: bool = False) -> dict:
        info = {
            "replica_id": rid,
            "pid": h.pid,
            "port": h.port,
            "state": h.state,
            "restarts": h.restarts,
            "queued_rows": self._load_of(rid),
        }
        if h.state != "ready":
            return info
        path = ("/metrics?raw=1" + ("&quality=1" if quality else "")
                + ("&prof=1" if prof else "")
                + ("&models=1" if models else ""))
        try:
            # quality scrapes carry serialized sketches + run an eval on
            # the replica — give them more room than the 2s liveness poll
            status, m = http_json("GET", h.port, path,
                                  timeout=10.0 if quality else 2.0)
        except OSError as e:
            info["scrape_error"] = f"{type(e).__name__}: {e}"[:120]
            return info
        if status == 200:
            lat = dict(m.get("latency") or {})
            info["raw_ms"] = lat.pop("raw_ms", None) or []
            info["latency"] = lat
            info["queue_depth"] = m.get("queue_depth")
            info["batching"] = m.get("batching")
            if "cache" in m:
                info["cache"] = m["cache"]
            if quality and "quality" in m:
                info["quality"] = m["quality"]
            if prof and "prof" in m:
                # per-replica per-rung kernel-time attribution: the
                # profiling plane is not ported (ROADMAP.md 1.12), so
                # every replica answers enabled:false with empty rungs
                info["prof"] = m["prof"]
            if models and "model_metrics" in m:
                # per-model block (raw rings included — the
                # scrape path carries &raw=1); metrics_payload merges
                # these fleet-wide, keyed by model
                info["model_metrics"] = m["model_metrics"]
            counters = m.get("counters") or {}
            info["counters"] = {
                k: v for k, v in counters.items()
                if k.startswith(("serve.", "health.retrace", "health.drift",
                                 "health.calibration", "quality.", "chaos."))
            }
        return info

    def metrics_payload(self, history: bool = False,
                        quality: bool = False, prof: bool = False,
                        models: bool = False) -> dict:
        per: Dict[str, dict] = {}
        ring_union: List[float] = []
        now = time.time()
        total_restarts = 0
        # scrape replicas CONCURRENTLY: one wedged replica (still 'ready'
        # until its strikes accumulate) must not stall /metrics for the
        # whole fleet — an operator needs visibility most mid-incident
        handles = sorted(self.handles.items())
        results: Dict[int, dict] = {}

        @thread_guard
        def _scrape(rid, h):
            results[rid] = self._scrape_replica(
                rid, h, quality=quality, prof=prof, models=models
            )

        scrapers = [
            threading.Thread(target=_scrape, args=(rid, h), daemon=True)
            for rid, h in handles
        ]
        for t in scrapers:
            t.start()
        for t in scrapers:
            t.join(timeout=15.0 if quality else 5.0)
        replica_quality: Dict[str, dict] = {}
        replica_models: Dict[str, dict] = {}
        for rid, h in handles:
            total_restarts += h.restarts
            info = results.get(rid) or {
                "replica_id": rid, "pid": h.pid, "port": h.port,
                "state": h.state, "restarts": h.restarts,
                "scrape_error": "scrape timed out",
            }
            # WINDOWED union: replica rings carry (ts, ms) pairs; stale
            # samples (an idle replica's old traffic) stay out of the
            # fleet percentile instead of diluting it
            ring_union.extend(
                window_ring_ms(info.pop("raw_ms", None) or [], now)
            )
            q = info.pop("quality", None)
            if q:
                replica_quality[str(rid)] = q
            mm = info.pop("model_metrics", None)
            if mm:
                replica_models[str(rid)] = mm
            per[str(rid)] = info
        snap = obs_snapshot()
        out = {
            "fleet": {
                "replicas": len(self.handles),
                "ready": len(self._ready_ids()),
                "restarts": total_restarts,
            },
            # autoscaling state: bounds, thresholds, streaks, cooldown
            # remainders, and the last executed decision (a report
            # renders this block in the fleet table)
            "autoscale": (
                self.autoscaler.snapshot() if self.autoscaler is not None
                else {"enabled": False, "min": self.replicas_min,
                      "max": self.replicas_max}
            ),
            # client-visible latency measured AT the front (queue + hop +
            # replica time) — the number an SLO dashboard should chart
            "latency": self.latency.percentiles() if self.latency else {},
            # replica-ring union: the fleet-wide replica-side percentile
            # (not replica-0's, not an average of per-replica p99s)
            "fleet_latency": latency_percentiles(ring_union),
            "replicas": per,
            "counters": {
                k: round(v, 3) for k, v in sorted(snap["counters"].items())
            },
            "gauges": {
                k: round(v, 4) for k, v in sorted(snap["gauges"].items())
            },
        }
        if history:
            # the FRONT's metric history (client-visible serve.front.*
            # series); per-replica history lives at each replica's own
            # /metrics?history=1
            out["history"] = OBS_REGISTRY.history_snapshot() or {}
        if quality:
            # fleet drift view: every replica's serve-side GK summaries
            # MERGE (obs/quality.merge_quality_payloads — mergeability is
            # the whole point of the sketch), so fleet PSI/KS are
            # computed over the union distribution, not averaged
            from ...obs.quality import merge_quality_payloads

            out["quality"] = merge_quality_payloads(replica_quality)
        if models:
            # per-model fleet table (`/metrics?models=1`): per-model ring
            # union keyed by model + summed counters + top-talker ranking
            out["model_metrics"] = merge_model_metrics(replica_models, now)
        return out

    def traces_payload(self) -> dict:
        """Fleet-wide /admin/traces: the front's own exemplar ring plus
        every ready replica's, one document. Each per-process payload
        carries its `wall_t0` clock origin (the spawn-time banner
        handshake backs it up on the handle, surviving a dead replica),
        so a report can merge all the rings onto one aligned
        timeline."""
        handles = sorted(self.handles.items())
        results: Dict[int, dict] = {}

        @thread_guard
        def _scrape(rid, h):
            try:
                status, body = http_json(
                    "GET", h.port, "/admin/traces", timeout=2.0
                )
                results[rid] = (
                    body if status == 200 and isinstance(body, dict)
                    else {"scrape_error": f"HTTP {status}"}
                )
            except OSError as e:
                results[rid] = {
                    "scrape_error": f"{type(e).__name__}: {e}"[:120]
                }

        scrapers = [
            threading.Thread(target=_scrape, args=(rid, h), daemon=True)
            for rid, h in handles if h.state == "ready"
        ]
        for t in scrapers:
            t.start()
        for t in scrapers:
            t.join(timeout=5.0)
        replicas: Dict[str, dict] = {}
        for rid, h in handles:
            info = results.get(rid) or {"scrape_error": f"state={h.state}"}
            if h.wall_t0 is not None:
                info.setdefault("wall_t0", h.wall_t0)
            replicas[str(rid)] = info
        return {
            "schema": "ytk_traces",
            "schema_version": 1,
            "fleet": True,
            "front": obs_trace.exemplars_payload(),
            "replicas": replicas,
        }

    # -- HTTP listener ----------------------------------------------------

    def serve_http(self) -> "FleetFront":
        # the single server's listener: a backlog of 128, not the stdlib's
        # 5, which resets clients' connections while a replica's spawn
        # holds the host's cores (the JAX package keeps 5)
        from ..server import _HTTPServer

        front = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                log.debug("front http: " + fmt, *args)

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

            def do_GET(self):  # noqa: N802 — stdlib handler API
                split = urllib.parse.urlsplit(self.path)
                path = split.path
                query = urllib.parse.parse_qs(split.query)
                if path == "/healthz":
                    self._json(200, front.health_payload())
                elif path == "/readyz":
                    ok = front.ready()
                    self._json(200 if ok else 503,
                               {"ready": ok,
                                "status": "draining" if front.draining
                                else ("ok" if ok else "no ready replica")})
                elif path == "/metrics":
                    hist = query.get("history", ["0"])[0] not in ("0", "")
                    qual = query.get("quality", ["0"])[0] not in ("0", "")
                    prof = query.get("prof", ["0"])[0] not in ("0", "")
                    mdl = query.get("models", ["0"])[0] not in ("0", "")
                    self._json(200, front.metrics_payload(
                        history=hist, quality=qual, prof=prof,
                        models=mdl))
                elif path == "/admin/traces":
                    self._json(200, front.traces_payload())
                else:
                    self._json(404, {"error": f"unknown path {self.path}"})

            def do_POST(self):  # noqa: N802
                if self.path in ("/admin/rollback", "/admin/pin",
                                 "/admin/unpin"):
                    try:
                        n = int(self.headers.get("Content-Length", 0))
                        req = json.loads(self.rfile.read(n) or b"{}")
                        if not isinstance(req, dict):
                            raise ValueError("request body must be a JSON "
                                             "object")
                    except (ValueError, json.JSONDecodeError) as e:
                        self._json(400, {"error": str(e),
                                         "type": "bad_request"})
                        return
                    ok, detail = front.admin(
                        self.path.rsplit("/", 1)[1], req.get("model")
                    )
                    self._json(200 if ok else 502,
                               {"ok": ok, "replicas": detail})
                    return
                if self.path != "/predict":
                    self._json(404, {"error": f"unknown path {self.path}"})
                    return
                req: dict = {}
                rows = None
                t_parse = time.perf_counter()
                raw_spliced = False
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    raw = self.rfile.read(n)
                    try:
                        frags = extract_raw_rows(raw.decode("utf-8"))
                    except UnicodeDecodeError:
                        frags = None  # json.loads below produces the 400
                    if frags is not None:
                        # raw-splice fast path: the client's own row bytes
                        # ride straight into the forward bodies — no
                        # dict round-trip on the front's GIL
                        rows = frags
                        raw_spliced = True
                        obs_inc("serve.front.raw_splice")
                        obs_inc("serve.front.raw_splice_rows", len(frags))
                    else:
                        req = json.loads(raw or b"{}")
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
                            raise ValueError(
                                '"rows" must be a list of objects')
                except (ValueError, json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e), "type": "bad_request"})
                    return
                # request trace: a client-supplied X-Ytk-Trace id is
                # adopted (forced trace), else the head sampler decides;
                # the parse hop names whether the body rode raw-splice
                ctx = obs_trace.begin(
                    self.headers.get(obs_trace.TRACE_HEADER)
                )
                ctx.hop_at("front.parse", t_parse, time.perf_counter(),
                           rows=len(rows), raw_splice=raw_spliced)

                def _reply(status: int, payload: dict,
                           headers: Optional[Dict[str, str]] = None) -> None:
                    with ctx.hop("front.write", status=status):
                        self._json(status, payload, headers=headers)
                    obs_trace.finish(
                        ctx, status=status, rows=len(rows),
                        latency_ms=(time.perf_counter() - t_parse) * 1e3,
                    )

                with obs_span("serve.front.request", rows=len(rows)):
                    try:
                        out = front.predict(
                            rows, model=req.get("model"),
                            deadline_ms=req.get("deadline_ms"),
                            trace=ctx,
                        )
                    except OverloadError as e:
                        # Retry-After: fleet backlog ÷ recent scored
                        # rows/s, clamped — clients back off for the time
                        # the queues actually need instead of hammering
                        _reply(429, {"error": str(e), "type": "overload"},
                               headers={"Retry-After":
                                        str(front.retry_after_s())})
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
                        obs_inc("serve.front.request_errors")
                        log.exception("front predict failed")
                        _reply(500, {"error": f"{type(e).__name__}: {e}",
                                     "type": "internal"})
                        return
                _reply(200, out)

        self._httpd = _HTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._serve_thread = threading.Thread(
            target=self._httpd.serve_forever, name="ytk-fleet-http",
            kwargs={"poll_interval": 0.1}, daemon=True,
        )
        self._serve_thread.start()
        log.info("fleet: front listening on %s:%d (%d replicas)",
                 self.host, self.port, self.n_replicas)
        return self

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful fleet drain (front stops intake,
        forwarders flush, replicas drain their own queues)."""

        def _drain(signum, frame):
            log.info("fleet: signal %d, draining", signum)
            threading.Thread(
                target=self.stop, kwargs={"drain": True}, daemon=True
            ).start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
