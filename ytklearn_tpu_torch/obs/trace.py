"""Serve-side distributed request tracing: per-hop spans + tail exemplars
(the JAX package's ``obs/trace.py``).

The serving-side counterpart of the obs core (Dapper): every `/predict`
request can
carry a trace id from the fleet front through a replica worker, and each
hop of its life — front parse/raw-splice, forwarder queue, HTTP forward,
replica queue wait, batch assembly, ladder-rung execution, cache hit/miss,
response write — is recorded as a named span, so a p99 spike decomposes
into "the milliseconds went HERE" instead of one opaque latency number.

Three pieces:

  head sampler   deterministic counter-hashed draw (splitmix64 over
                 (YTK_TRACE_SEED, request #) < YTK_TRACE_SAMPLE): same
                 seed + same request order = same kept set, so a drill
                 reproduces exactly. `begin()` returns the cached no-op
                 ctx when the draw says no — the unsampled path is one
                 integer hash + compare per request, no allocation.
  trace ctx      `TraceCtx.hop(name, **args)` / `hop_at(...)` record
                 (name, start, dur) tuples on the request as it flows
                 handler -> batcher -> scorer. Cross-process propagation
                 rides the `X-Ytk-Trace` header: the front forwards the
                 sampled ids of a coalesced batch, the replica adopts
                 them (`begin(inbound=...)`) so one trace id spans
                 front -> replica.
  exemplar ring  bounded per-process deque of finished traces, exported
                 at `/admin/traces`, mergeable cross-process by
                 obs.export.exemplar_trace_events (each payload carries the
                 process's wall-clock origin, so hops align on one
                 timeline). Tail rule: shed (429), deadline (504), and
                 SLO-exceeding requests are ALWAYS retained — with full
                 hops when head-sampled, as a minimal exemplar (id,
                 status, latency) otherwise, because the no-op path
                 records nothing by contract.

Batch-scoped hops: code that runs once per coalesced batch (the scorer's
featurize/execute, the front's HTTP forward) records through
`batch_hop(name, **args)` into a thread-local staging list; the batcher
worker brackets the score_fn call with `set_current_batch(traces)` /
`end_current_batch()`, which copies the staged hops onto every traced
request of the batch. With no traced request in the batch, `batch_hop`
returns the cached no-op span.

Knobs: YTK_TRACE_SAMPLE (0 disables the plane entirely), YTK_TRACE_SEED,
YTK_TRACE_EXEMPLARS (ring capacity). The serving layer feeds the SLO used
by the tail rule via `configure_tracing(slo_ms=...)`.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Dict, List, Optional, Sequence

from . import core
from ..config import knobs

#: HTTP header carrying the sampled trace ids of a forwarded batch
#: (comma-separated); a client may set it on an inbound /predict to force
#: a trace (adopt semantics, Dapper's "debug bit")
TRACE_HEADER = "X-Ytk-Trace"

#: statuses the tail rule always retains (shed / deadline-expired)
TAIL_STATUSES = (429, 504)

_M64 = (1 << 64) - 1


def _mix64(x: int) -> int:
    """splitmix64 finalizer — the same counter-hash family the chaos layer
    uses, inlined here because this runs once per request on the serve hot
    path (a cross-module call + string hash would double the cost)."""
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


class _TraceState:
    __slots__ = ("rate", "seed", "slo_ms", "counter", "tail_counter",
                 "threshold")

    def __init__(self):
        self.rate = 0.0
        self.seed = 0
        self.slo_ms: Optional[float] = None
        self.counter = 0  # advanced under _counter_lock (head-sample order)
        # tail-only exemplars draw ids from their OWN counter: advancing
        # the head counter for them would shift subsequent begin() draws
        # and break the same-seed-same-kept-set determinism contract
        self.tail_counter = 0
        self.threshold = 0  # rate pre-scaled to the 64-bit hash range

    def set_rate(self, rate: float) -> None:
        self.rate = max(0.0, min(1.0, float(rate)))
        # draw < rate compared in integer space: no float division per
        # request, and rate=1.0 keeps everything (threshold = 2^64)
        self.threshold = int(self.rate * float(1 << 64))


_state = _TraceState()
_counter_lock = threading.Lock()

# exemplar ring: bounded deque of finished trace records. Handler threads
# append, /admin/traces snapshots — one small lock, touched once per KEPT
# trace (sample-rate-scaled), never per unsampled request.
_ring: collections.deque = collections.deque(maxlen=256)
_ring_lock = threading.Lock()

_tls = threading.local()


def enabled() -> bool:
    return _state.rate > 0.0


def slo_ms() -> Optional[float]:
    return _state.slo_ms


def configure_tracing(
    sample: Optional[float] = None,
    seed: Optional[int] = None,
    exemplars: Optional[int] = None,
    slo_ms: Optional[float] = None,
    reset: bool = False,
) -> None:
    """Runtime override of the YTK_TRACE_* env knobs (serving layer arms
    the SLO; tests/drills pin the sampler). `reset=True` clears the
    exemplar ring and rewinds the sample counter (determinism tests)."""
    global _ring
    if sample is not None:
        _state.set_rate(sample)
    if seed is not None:
        _state.seed = int(seed)
    if slo_ms is not None:
        _state.slo_ms = float(slo_ms) if slo_ms > 0 else None
    if exemplars is not None and int(exemplars) != _ring.maxlen:
        with _ring_lock:
            _ring = collections.deque(_ring, maxlen=max(1, int(exemplars)))
    if reset:
        with _ring_lock:
            _ring.clear()
        with _counter_lock:
            _state.counter = 0
            _state.tail_counter = 0


def _configure_from_env() -> None:
    _state.set_rate(knobs.get_float("YTK_TRACE_SAMPLE") or 0.0)
    _state.seed = knobs.get_int("YTK_TRACE_SEED") or 0
    n = knobs.get_int("YTK_TRACE_EXEMPLARS")
    if n and n != _ring.maxlen:
        configure_tracing(exemplars=n)


def head_keep(seed: int, n: int) -> bool:
    """The deterministic head-sampling decision for request `n` (1-based)
    under `seed` — public so tests and drills can precompute the kept set
    exactly (the chaos `site_draw` discipline)."""
    return _mix64((seed * 0x9E3779B97F4A7C15 + n) & _M64) < _state.threshold


class _NoopTrace:
    """Cached do-nothing trace ctx — the whole unsampled request path.
    `ids` is empty, which is how every integration point (batcher submit,
    batch-hop bracketing, header propagation) tests for "really traced"."""

    __slots__ = ()
    ids: tuple = ()
    kept = None

    def hop(self, name, **args):
        return core.NOOP_SPAN

    def hop_at(self, name, t0, t1, **args):
        return None

    def add_hops(self, hops):
        return None


NOOP_TRACE = _NoopTrace()


class TraceCtx:
    """One sampled (or adopted) request's hop log.

    Hops are appended by the handler thread AND the batcher worker thread
    (strictly sequenced by the pending handle's completion signal, but a
    lock keeps the container honest under the lockwatch twin); `finish`
    snapshots them into the exemplar record. Timestamps are obs-clock
    offsets (`core._now()`), the same origin as every other obs event, so
    `wall_t0 + ts` aligns traces across processes.
    """

    __slots__ = ("ids", "kept", "t0", "hops", "_lock")

    def __init__(self, ids: Sequence[str], kept: str):
        self.ids = tuple(ids)
        self.kept = kept  # head | adopted (finish may upgrade to tail_*)
        self.t0 = core._now()
        self.hops: List[dict] = []
        self._lock = threading.Lock()

    def hop_at(self, name: str, t0: float, t1: float, **args) -> None:
        """Record one hop from explicit perf_counter timestamps (queue
        waits are measured between enqueue and dequeue, which straddle
        threads)."""
        h = {"name": name, "ts": round(t0 - core._T0, 6),
             "dur_ms": round((t1 - t0) * 1e3, 4)}
        if args:
            h["args"] = args
        with self._lock:
            self.hops.append(h)

    def hop(self, name: str, **args) -> "_HopSpan":
        """`with ctx.hop("front.forward", replica=rid): ...`"""
        return _HopSpan(self, name, args)

    def add_hops(self, hops: List[dict]) -> None:
        """Batch-scoped hops copied onto this request (already in record
        form — shared dicts are fine, records are write-once)."""
        with self._lock:
            self.hops.extend(hops)


class _HopSpan:
    __slots__ = ("_ctx", "_name", "_args", "_t0")

    def __init__(self, ctx, name, args):
        self._ctx = ctx
        self._name = name
        self._args = args

    def __enter__(self) -> "_HopSpan":
        self._t0 = time.perf_counter()
        return self

    def add(self, **kw) -> "_HopSpan":
        self._args.update(kw)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        self._ctx.hop_at(self._name, self._t0, time.perf_counter(),
                         **self._args)
        return False


def _new_id(n: int) -> str:
    """Process-unique trace id: pid + counter + a wall-clock nibble so two
    fleets started back to back cannot collide."""
    return f"{os.getpid():x}-{n:x}-{int(time.time() * 1e3) & 0xFFFFFF:x}"


def begin(inbound: Optional[str] = None) -> "TraceCtx | _NoopTrace":
    """Start (or adopt) a request trace.

    `inbound` is the raw X-Ytk-Trace header value: non-empty adopts the
    upstream sampling decision verbatim (the ids were sampled at the
    front — a replica must record them, Dapper's propagated decision).
    Otherwise the deterministic head sampler decides; "no" returns the
    cached no-op ctx."""
    if _state.rate <= 0.0:
        return NOOP_TRACE
    if inbound:
        ids = [t.strip() for t in inbound.split(",") if t.strip()]
        if ids:
            return TraceCtx(ids[:64], kept="adopted")
        return NOOP_TRACE
    with _counter_lock:
        _state.counter += 1
        n = _state.counter
    if not head_keep(_state.seed, n):
        return NOOP_TRACE
    return TraceCtx((_new_id(n),), kept="head")


def finish(
    ctx,
    status: int = 200,
    latency_ms: Optional[float] = None,
    rows: Optional[int] = None,
    **args,
) -> Optional[dict]:
    """Close a request trace and decide exemplar retention.

    Head-sampled / adopted traces are always admitted (that IS the
    sample). Unsampled requests are admitted by the tail rule only —
    shed (429), deadline (504), or latency over the configured SLO — as a
    minimal record without hop decomposition (the no-op ctx recorded
    nothing, by the near-zero-cost contract). Returns the admitted record
    (tests introspect it) or None."""
    if _state.rate <= 0.0:
        return None
    slo = _state.slo_ms
    violated = status in TAIL_STATUSES or (
        slo is not None and latency_ms is not None and latency_ms > slo
    )
    sampled = ctx is not None and ctx is not NOOP_TRACE and ctx.ids
    if not sampled and not violated:
        return None
    if sampled:
        with ctx._lock:
            hops = list(ctx.hops)
        rec = {"trace_id": ctx.ids[0], "ts": round(ctx.t0, 6),
               "kept": ctx.kept, "hops": hops}
        if len(ctx.ids) > 1:
            rec["trace_ids"] = list(ctx.ids)
    else:
        # tail-only exemplar: no hops were recorded, but the incident is
        # still named (when, what, how slow) — a 504 storm must not be
        # invisible just because the head sampler skipped those requests.
        # Ids come from the tail counter so a same-millisecond storm of
        # sheds still yields unique trace ids
        with _counter_lock:
            _state.tail_counter += 1
            t_n = _state.tail_counter
        # ts is the request START like every sampled exemplar (finish
        # time minus the latency) — a tail span placed at its END would
        # render one-latency late on the merged Perfetto timeline
        start = core._now() - (latency_ms / 1e3 if latency_ms else 0.0)
        rec = {"trace_id": f"{os.getpid():x}-t{t_n:x}-"
                           f"{int(time.time() * 1e3) & 0xFFFFFF:x}",
               "ts": round(max(start, 0.0), 6), "kept": "tail", "hops": []}
    if violated:
        rec["kept"] = (
            "tail_shed" if status == 429
            else "tail_deadline" if status == 504
            else "tail_slo"
        )
    rec["status"] = int(status)
    if latency_ms is not None:
        rec["latency_ms"] = round(float(latency_ms), 3)
    if rows is not None:
        rec["rows"] = int(rows)
    if core.IDENTITY:
        rec.update({k: v for k, v in core.IDENTITY.items()
                    if k not in rec})
    if args:
        rec["args"] = args
    with _ring_lock:
        _ring.append(rec)
    core.inc("trace.exemplars")
    core.inc(f"trace.kept.{rec['kept']}")
    return rec


# ---------------------------------------------------------------------------
# Batch-scoped hops (scorer featurize/execute, front HTTP forward)
# ---------------------------------------------------------------------------


def set_current_batch(traces: List[TraceCtx]) -> None:
    """Batcher worker: the traced requests of the batch about to score.
    Only called when the batch HAS traced requests (the untraced hot path
    never enters this module)."""
    _tls.batch = traces
    _tls.staged = []


def end_current_batch() -> None:
    """Copy the staged batch hops onto every traced request, then clear."""
    traces = getattr(_tls, "batch", None)
    staged = getattr(_tls, "staged", None)
    _tls.batch = None
    _tls.staged = None
    if traces and staged:
        for t in traces:
            t.add_hops(staged)


def current_batch_ids() -> List[str]:
    """Trace ids of the in-flight batch (the front's forwarder reads this
    inside score_fn to build the X-Ytk-Trace propagation header)."""
    traces = getattr(_tls, "batch", None)
    if not traces:
        return []
    out: List[str] = []
    for t in traces:
        out.extend(t.ids)
    return out


class _BatchHopSpan:
    __slots__ = ("_name", "_args", "_t0")

    def __init__(self, name, args):
        self._name = name
        self._args = args

    def __enter__(self) -> "_BatchHopSpan":
        self._t0 = time.perf_counter()
        return self

    def add(self, **kw) -> "_BatchHopSpan":
        self._args.update(kw)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        t1 = time.perf_counter()
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        h = {"name": self._name, "ts": round(self._t0 - core._T0, 6),
             "dur_ms": round((t1 - self._t0) * 1e3, 4)}
        if self._args:
            h["args"] = self._args
        staged = getattr(_tls, "staged", None)
        if staged is not None:
            staged.append(h)
        return False


def batch_hop(name: str, **args):
    """Span over once-per-batch work, attributed to every traced request
    of the current batch. No-op (cached ctx manager) when the batch has
    no traced request — the scorer calls this on every batch."""
    if getattr(_tls, "batch", None):
        return _BatchHopSpan(name, args)
    return core.NOOP_SPAN


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


def exemplars(clear: bool = False) -> List[dict]:
    with _ring_lock:
        out = list(_ring)
        if clear:
            _ring.clear()
    return out


def exemplars_payload() -> Dict[str, object]:
    """The /admin/traces document for THIS process. `wall_t0` anchors the
    obs-clock hop offsets to the wall clock (hop wall time = wall_t0 +
    ts), which is how exemplar_trace_events merges front + replica rings onto one
    timeline — the same handshake value the worker banner carries."""
    return {
        "schema": "ytk_traces",
        "schema_version": 1,
        "pid": os.getpid(),
        "wall_t0": core.WALL_T0,
        "sample": _state.rate,
        "seed": _state.seed,
        "slo_ms": _state.slo_ms,
        "ring_capacity": _ring.maxlen,
        "identity": dict(core.IDENTITY),
        "exemplars": exemplars(),
    }


_configure_from_env()
