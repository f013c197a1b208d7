"""Dynamic micro-batching queue with backpressure (Clipper, NSDI'17; the
JAX package's ``serve/batcher.py``).

Requests (one or more feature-dict rows each) enqueue into a bounded queue;
one worker thread coalesces them into batches of up to `max_batch` rows,
waiting at most `max_wait_ms` for stragglers after the first request
arrives. The scorer's shape ladder then pads the coalesced batch to a
rung the scorer warmed at load.

Backpressure is load *shedding*, not buffering: when the queue holds
`max_queue` pending requests, submit() raises OverloadError immediately —
the caller (server.py) turns that into a typed 429 so the client can back
off, instead of every request slowly timing out (Clipper's
"reject early under overload" rule). Per-request deadlines are checked at
dequeue time: a request that already waited past its deadline is failed
with DeadlineExceeded without wasting scorer time on it.

Shutdown is graceful by default: close(drain=True) stops intake, lets the
worker finish everything already queued, and joins it — the SIGTERM path
(server.py) rides this so in-flight requests complete.

The scorer runs on the worker thread: it launches on that thread's current
CUDA stream, and its `.cpu()` copies synchronise before results are handed
back to the callers.
"""

from __future__ import annotations

import collections
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ..obs import event as obs_event, gauge as obs_gauge, inc as obs_inc, span as obs_span
from ..obs import trace as obs_trace
from ..obs.recorder import thread_guard

log = logging.getLogger(__name__)


class OverloadError(RuntimeError):
    """Bounded queue full — the request was shed, not enqueued."""


#: Retry-After hints are clamped to this bound: a drain estimate past it
#: means "overloaded, come back soon-ish" — a huge honest number would
#: just push clients into one synchronized retry storm later
RETRY_AFTER_MAX_S = 8


class ScoredRateWindow:
    """Recent scored-rows/s estimate feeding the 429 Retry-After hint.

    Both shed paths (replica/solo server and fleet front) derive the
    header from the same arithmetic: backlog rows ÷ this window's rate,
    clamped to [1, RETRY_AFTER_MAX_S] seconds — so a client backs off
    roughly as long as the queue actually needs to drain instead of
    hammering an overloaded process. record() is called once per
    completed request on the success path; reads tolerate an empty
    window (no drain evidence -> the clamp bound, the honest worst case).
    """

    def __init__(self, window_s: float = 10.0, maxlen: int = 1024):
        self.window_s = float(window_s)
        self._ring: collections.deque = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, rows: int) -> None:
        with self._lock:
            self._ring.append((time.time(), int(rows)))

    def rows_per_s(self) -> float:
        now = time.time()
        with self._lock:
            pts = [(t, r) for t, r in self._ring if now - t <= self.window_s]
        if not pts:
            return 0.0
        total = sum(r for _t, r in pts)
        # divide by the span the retained samples ACTUALLY cover: under
        # load the bounded ring holds far less than window_s of history
        # (1024 entries at 50k req/s is ~20ms) and dividing by the full
        # window would underestimate throughput ~500x, degenerating every
        # Retry-After to the clamp bound exactly when the estimate
        # matters most
        span = now - pts[0][0]
        return total / max(span, 0.05)


def retry_after_s(backlog_rows: float, rate: ScoredRateWindow) -> int:
    """Queue-drain estimate in whole seconds for a Retry-After header."""
    rows_per_s = rate.rows_per_s()
    if rows_per_s <= 0.0:
        return RETRY_AFTER_MAX_S
    est = math.ceil(backlog_rows / rows_per_s)
    return max(1, min(RETRY_AFTER_MAX_S, int(est)))


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before it reached the scorer."""


class ServeClosed(RuntimeError):
    """The batcher is draining or closed; no new work is accepted."""


@dataclass
class BatchPolicy:
    """Micro-batching knobs (CLI flags / YTK_SERVE_* env, docs/serving.md)."""

    max_batch: int = 512  # rows per scorer call (ladder top is the ceiling)
    max_wait_ms: float = 2.0  # straggler wait after the first queued request
    max_queue: int = 2048  # pending requests before shedding
    default_deadline_ms: float = 0.0  # 0 = no deadline


class _Pending:
    """One submitted request: rows in, result (or typed error) out.

    The worker stores the whole batch result + this request's offset; the
    slice happens in get() on the caller's thread. Completion signaling
    is LAZY: the common high-throughput pattern (a deep in-flight window
    where results land before get() is called) pays one flag write under
    a shared lock per request, and a threading.Event is allocated and set
    only when a caller actually has to block — at 30k req/s the per-
    request Event create + set is a measurable slice of the GIL budget."""

    __slots__ = ("rows", "result", "meta", "_off", "error", "t_enq",
                 "t_done", "deadline", "trace", "_done", "_event", "_sig")

    def __init__(self, rows, deadline: Optional[float], sig: threading.Lock,
                 trace=None):
        self.rows = rows
        self.result = None  # (batch_scores, batch_preds) shared by the batch
        self.meta = None  # score_fn's optional 3rd return (e.g. model entry)
        self._off = 0
        self.error: Optional[BaseException] = None
        self.t_enq = time.perf_counter()
        self.t_done = None  # set by the worker at completion: the caller
        # measures its wake-up gap (completion -> get() return) from it
        self.deadline = deadline  # perf_counter timestamp or None
        # sampled request-trace ctx (obs/trace.py) or None: the worker
        # records the queue-wait hop and copies the batch's sub-hops
        # (scorer assemble/execute, front forward) onto it
        self.trace = trace
        self._done = False
        self._event: Optional[threading.Event] = None
        self._sig = sig  # shared per-batcher signal lock (lost-wake guard)

    def finish(self) -> None:
        """Worker side: result/meta/error fields are set — publish. The
        flag flip and the waiter's event creation are serialized by the
        shared lock, so a wake can never be lost."""
        with self._sig:
            self._done = True
            ev = self._event
        if ev is not None:
            ev.set()

    def get(self, timeout: Optional[float] = None):
        if not self._done:
            with self._sig:
                if not self._done and self._event is None:
                    self._event = threading.Event()
                ev = self._event if not self._done else None
            if ev is not None and not ev.wait(timeout):
                raise TimeoutError("serve request did not complete in time")
        if self.error is not None:
            raise self.error
        scores, preds = self.result
        n = len(self.rows)
        return (
            np.asarray(scores[self._off : self._off + n]),
            np.asarray(preds[self._off : self._off + n]),
        )


class MicroBatcher:
    """Coalesce submitted rows into scorer batches on a worker thread.

    `score_fn(rows) -> (scores, preds)` is called with at most
    `policy.max_batch` rows; results are split back per request. Thread-safe
    for any number of producers.
    """

    def __init__(
        self,
        score_fn: Callable,
        policy: Optional[BatchPolicy] = None,
        controller=None,
        model_scope: Optional[str] = None,
        trace_site: str = "serve",
    ):
        self.score_fn = score_fn
        self.policy = policy or BatchPolicy()
        # hop-name prefix for request traces through this batcher:
        # "serve" inside a replica/solo server, "front" for the fleet
        # front's per-replica forwarders (queue hop = f"{site}.queue")
        self.trace_site = trace_site
        # mesh-obs family scope (obs/model_metrics.py): when set, the shed
        # and deadline-expiry counters are mirrored per model at the SAME
        # sites as their global twins — the exact-conservation identity
        # (sum over `serve.model.*.shed` == `serve.shed`) holds because no
        # other code path increments either
        self.model_scope = model_scope
        # optional AIMD batch-size controller (serve/fleet/aimd.py): when
        # set, it supplies max_batch/max_wait_ms live (snapped to the
        # scorer's ladder) and is fed per-request latencies by the worker;
        # None keeps the fixed BatchPolicy knobs
        self.controller = controller
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0  # maintained with _queue; O(1) linger checks
        self._lock = threading.Lock()
        self._sig = threading.Lock()  # _Pending completion signaling
        self._not_empty = threading.Condition(self._lock)
        self._closing = False
        self._closed = False
        self._worker = threading.Thread(
            target=self._loop, name="ytk-serve-batcher", daemon=True
        )
        self._worker.start()

    # -- producer side ----------------------------------------------------

    def submit(
        self,
        rows: Sequence[Dict[str, float]],
        deadline_ms: Optional[float] = None,
        trace=None,
    ) -> _Pending:
        """Enqueue rows; returns a pending handle (.get(timeout) blocks).
        Raises OverloadError (queue full) or ServeClosed synchronously.
        `trace` is an optional obs.trace ctx; the NOOP ctx is normalized
        to None here so the worker's per-request check stays one `is not
        None` on the unsampled path."""
        if deadline_ms is None:
            deadline_ms = self.policy.default_deadline_ms
        deadline = (
            time.perf_counter() + deadline_ms / 1e3 if deadline_ms and deadline_ms > 0
            else None
        )
        if trace is not None and not trace.ids:
            trace = None
        req = _Pending(list(rows), deadline, self._sig, trace=trace)
        with self._not_empty:
            if self._closing:
                raise ServeClosed("serve batcher is draining")
            if len(self._queue) >= self.policy.max_queue:
                obs_inc("serve.shed")
                if self.model_scope is not None:
                    obs_inc(f"serve.model.{self.model_scope}.shed")
                raise OverloadError(
                    f"serve queue full ({self.policy.max_queue} pending)"
                )
            was_empty = not self._queue
            self._queue.append(req)
            self._queued_rows += len(req.rows)
            # queue_depth gauge is maintained by the worker (once per batch);
            # a per-submit gauge write is measurable at 30k req/s
            # wake the worker only on the transitions it acts on (first
            # request, or a full batch ready); notifying every submit makes
            # the linger window a notify/wake ping-pong that caps throughput
            if was_empty or self._queued_rows >= self._max_batch():
                self._not_empty.notify()
        return req

    def score(self, rows, deadline_ms=None, timeout: Optional[float] = 30.0):
        """submit() + get(): (scores, preds) numpy arrays for `rows`."""
        return self.submit(rows, deadline_ms).get(timeout)

    # -- worker side ------------------------------------------------------

    def _max_batch(self) -> int:
        c = self.controller
        return c.max_batch if c is not None else self.policy.max_batch

    def _max_wait_ms(self) -> float:
        c = self.controller
        return c.max_wait_ms if c is not None else self.policy.max_wait_ms

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block for the first request, linger max_wait_ms for more, then
        take up to max_batch rows' worth. None = closed and drained."""
        wait_s = self._max_wait_ms() / 1e3
        max_batch = self._max_batch()
        with self._not_empty:
            while not self._queue:
                if self._closing:
                    return None
                self._not_empty.wait(timeout=0.05)
            if wait_s > 0 and not self._closing:
                deadline = time.perf_counter() + wait_s
                while self._queued_rows < max_batch:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._not_empty.wait(timeout=remaining)
            batch: List[_Pending] = []
            n_rows = 0
            while self._queue:
                nxt = len(self._queue[0].rows)
                if batch and n_rows + nxt > max_batch:
                    break
                req = self._queue.popleft()
                batch.append(req)
                n_rows += nxt
            self._queued_rows -= n_rows
            obs_gauge("serve.queue_depth", len(self._queue))
            return batch

    @thread_guard
    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                break
            now = time.perf_counter()
            live: List[_Pending] = []
            traced = None
            for req in batch:
                if req.trace is not None:
                    # queue-wait hop: enqueue -> dequeue, recorded for the
                    # expired requests too (the 504's trace must SHOW the
                    # queue is where its deadline went)
                    req.trace.hop_at(
                        self.trace_site + ".queue", req.t_enq, now,
                        rows=len(req.rows),
                    )
                if req.deadline is not None and now > req.deadline:
                    obs_inc("serve.deadline_expired")
                    if self.model_scope is not None:
                        obs_inc(
                            f"serve.model.{self.model_scope}"
                            ".deadline_expired"
                        )
                    req.error = DeadlineExceeded(
                        f"deadline expired after "
                        f"{(now - req.t_enq) * 1e3:.1f} ms in queue"
                    )
                    req.finish()
                else:
                    live.append(req)
                    if req.trace is not None:
                        if traced is None:
                            traced = []
                        traced.append(req.trace)
            if not live:
                continue
            rows: List[dict] = []
            for req in live:
                rows.extend(req.rows)
            if traced:
                # batch-scoped sub-hops (scorer assemble/execute, front
                # forward) recorded during score_fn land on every traced
                # request of this batch; the untraced path never touches
                # the trace module
                obs_trace.set_current_batch(traced)
            try:
                with obs_span("serve.batch", rows=len(rows), requests=len(live)):
                    out = self.score_fn(rows)
                if traced:
                    # copy the staged hops BEFORE finish(): the handler
                    # thread closes the trace the moment its pending
                    # handle completes
                    obs_trace.end_current_batch()
                    traced = None
                # score_fn returns (scores, preds) or (scores, preds, meta);
                # meta rides along per batch — the server uses it to report
                # WHICH model version actually scored these rows (resolving
                # it before enqueue would race a hot reload)
                scores, preds = out[0], out[1]
                meta = out[2] if len(out) > 2 else None
                obs_inc("serve.batches")
                obs_inc("serve.batch_rows", len(rows))
                result = (scores, preds)
                off = 0
                t_done = time.perf_counter()
                for req in live:
                    req.result = result
                    req.meta = meta
                    req._off = off
                    off += len(req.rows)
                    req.t_done = t_done
                    req.finish()
                    if self.controller is not None:
                        # client-visible latency (enqueue -> scored): the
                        # number the SLO is written against
                        self.controller.observe((t_done - req.t_enq) * 1e3)
                if self.controller is not None:
                    self.controller.note_batch()
            except Exception as e:  # noqa: BLE001 — fail the requests, not the worker
                if traced:
                    obs_trace.end_current_batch()  # partial hops still land
                log.exception("serve batch of %d rows failed", len(rows))
                obs_inc("serve.batch_errors")
                obs_event("serve.batch_error", error=type(e).__name__)
                for req in live:
                    req.error = e
                    req.finish()
        self._closed = True

    # -- shutdown ---------------------------------------------------------

    def close(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop intake; drain=True processes everything already queued
        before the worker exits, drain=False fails queued requests."""
        with self._not_empty:
            self._closing = True
            if not drain:
                for req in self._queue:
                    req.error = ServeClosed("serve batcher closed")
                    req.finish()
                self._queue.clear()
                self._queued_rows = 0
                obs_gauge("serve.queue_depth", 0)
            self._not_empty.notify_all()
        self._worker.join(timeout=timeout)

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    @property
    def queued_rows(self) -> int:
        """Rows currently queued (one racy int read — the Retry-After
        estimate and the front's balancer both want a cheap snapshot,
        not a fenced count)."""
        return self._queued_rows

    @property
    def closed(self) -> bool:
        return self._closed
