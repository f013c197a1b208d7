"""Dynamic micro-batching queue with backpressure (Clipper, NSDI'17).

Requests (one or more feature-dict rows each) enqueue into a bounded queue;
one worker thread coalesces them into batches of up to `max_batch` rows,
waiting at most `max_wait_ms` for stragglers after the first request
arrives. The scorer's shape ladder then pads the batch to a rung.

Backpressure is load shedding: when `max_queue` requests are pending,
submit() raises OverloadError at once (the server's 429). A request whose
deadline passed while it queued fails with DeadlineExceeded without
reaching the scorer. close(drain=True) stops intake, lets the worker
finish everything queued, and joins it.

The scorer runs on the worker thread: it launches on that thread's current
CUDA stream, and its `.cpu()` copies synchronise before results are handed
back to the callers.
"""

from __future__ import annotations

import collections
import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

log = logging.getLogger(__name__)


class OverloadError(RuntimeError):
    """Bounded queue full — the request was shed, not enqueued."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before it reached the scorer."""


class ServeClosed(RuntimeError):
    """The batcher is draining or closed; no new work is accepted."""


@dataclass
class BatchPolicy:
    """Micro-batching knobs (CLI flags)."""

    max_batch: int = 512  # rows per scorer call (ladder top is the ceiling)
    max_wait_ms: float = 2.0  # straggler wait after the first queued request
    max_queue: int = 2048  # pending requests before shedding
    default_deadline_ms: float = 0.0  # 0 = no deadline


class _Pending:
    """One submitted request: rows in, result (or typed error) out. The
    worker stores the whole batch result + this request's offset; the
    slice happens in get() on the caller's thread. A threading.Event is
    made only when a caller actually has to block."""

    __slots__ = ("rows", "result", "meta", "_off", "error", "t_enq",
                 "deadline", "_done", "_event", "_sig")

    def __init__(self, rows, deadline: Optional[float], sig: threading.Lock):
        self.rows = rows
        self.result = None  # (batch_scores, batch_preds) shared by the batch
        self.meta = None  # score_fn's optional 3rd return (the model entry)
        self._off = 0
        self.error: Optional[BaseException] = None
        self.t_enq = time.perf_counter()
        self.deadline = deadline  # perf_counter timestamp or None
        self._done = False
        self._event: Optional[threading.Event] = None
        self._sig = sig  # shared per-batcher signal lock (lost-wake guard)

    def finish(self) -> None:
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

    `score_fn(rows) -> (scores, preds[, meta])` is called with at most
    `policy.max_batch` rows; results are split back per request.
    Thread-safe for any number of producers."""

    def __init__(self, score_fn: Callable, policy: Optional[BatchPolicy] = None):
        self.score_fn = score_fn
        self.policy = policy or BatchPolicy()
        self._queue: collections.deque = collections.deque()
        self._queued_rows = 0  # maintained with _queue
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
    ) -> _Pending:
        """Enqueue rows; returns a pending handle (.get(timeout) blocks).
        Raises OverloadError (queue full) or ServeClosed synchronously."""
        if deadline_ms is None:
            deadline_ms = self.policy.default_deadline_ms
        deadline = (
            time.perf_counter() + deadline_ms / 1e3
            if deadline_ms and deadline_ms > 0 else None
        )
        req = _Pending(list(rows), deadline, self._sig)
        with self._not_empty:
            if self._closing:
                raise ServeClosed("serve batcher is draining")
            if len(self._queue) >= self.policy.max_queue:
                raise OverloadError(
                    f"serve queue full ({self.policy.max_queue} pending)"
                )
            was_empty = not self._queue
            self._queue.append(req)
            self._queued_rows += len(req.rows)
            # wake the worker only on the transitions it acts on (first
            # request, or a full batch ready)
            if was_empty or self._queued_rows >= self.policy.max_batch:
                self._not_empty.notify()
        return req

    def score(self, rows, deadline_ms=None, timeout: Optional[float] = 30.0):
        """submit() + get(): (scores, preds) numpy arrays for `rows`."""
        return self.submit(rows, deadline_ms).get(timeout)

    # -- worker side ------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Block for the first request, linger max_wait_ms for more, then
        take up to max_batch rows' worth. None = closed and drained."""
        wait_s = self.policy.max_wait_ms / 1e3
        max_batch = self.policy.max_batch
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
                batch.append(self._queue.popleft())
                n_rows += nxt
            self._queued_rows -= n_rows
            return batch

    def _loop(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                break
            now = time.perf_counter()
            live: List[_Pending] = []
            for req in batch:
                if req.deadline is not None and now > req.deadline:
                    req.error = DeadlineExceeded(
                        f"deadline expired after "
                        f"{(now - req.t_enq) * 1e3:.1f} ms in queue"
                    )
                    req.finish()
                else:
                    live.append(req)
            if not live:
                continue
            rows: List[dict] = []
            for req in live:
                rows.extend(req.rows)
            try:
                out = self.score_fn(rows)
            except Exception as e:  # noqa: BLE001 — fail the requests, not the worker
                log.exception("serve batch of %d rows failed", len(rows))
                for req in live:
                    req.error = e
                    req.finish()
                continue
            result = (out[0], out[1])
            meta = out[2] if len(out) > 2 else None
            off = 0
            for req in live:
                req.result = result
                req.meta = meta
                req._off = off
                off += len(req.rows)
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
            self._not_empty.notify_all()
        self._worker.join(timeout=timeout)

    @property
    def closed(self) -> bool:
        return self._closed
