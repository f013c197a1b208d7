"""AIMD adaptive batch sizing under a latency SLO (Clipper, NSDI'17 §4.3;
the JAX package's ``serve/fleet/aimd.py``).

Fixed `max_batch`/`max_wait_ms` knobs make the operator
guess the largest batch that still meets the latency target, and a wrong
guess either wasted throughput (too small) or blew the SLO (too large).
Clipper's answer is an additive-increase / multiplicative-decrease search
— the same control law TCP uses for congestion windows — over the batch
size itself:

  - every `window` batches the controller judges the window's WORST
    observed request latency (enqueue -> response, the client-visible
    number) against the SLO,
  - a clean window additively raises the raw target by `inc` rows,
  - a violating window multiplicatively backs the raw target off by
    `backoff` (default 0.5 — halve, like TCP),

so the batch size climbs toward the throughput knee and retreats fast
when the SLO breaks (queue buildup, a slow replica, a noisy neighbor).

Ladder twist: the raw AIMD target is continuous, but the *effective* batch
bound always snaps DOWN to a shape-ladder rung — the controller can only
ever pick sizes the scorer already warmed at load (the kernels' launch
shapes and allocations settled there), so adaptation never lands a request
on a cold shape. The linger window is derived from the SLO instead of
a fixed `max_wait_ms`: waiting longer than a small fraction of the SLO
for stragglers eats budget the scorer needs.

Thread-safety: `observe()`/`note_batch()` run on the batcher worker
thread only; `max_batch`/`max_wait_ms` are single-attribute reads safe
from any producer.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from ...config import knobs
from ...obs import event as obs_event, gauge as obs_gauge, inc as obs_inc

#: linger budget as a fraction of the SLO — a batch should never spend
#: more than this share of its deadline waiting for stragglers
_WAIT_SLO_FRACTION = 0.05
_WAIT_CAP_MS = 5.0


class AIMDController:
    """Searches the largest ladder-snapped batch size meeting the p99 SLO."""

    def __init__(
        self,
        ladder: Sequence[int],
        slo_ms: Optional[float] = None,
        inc: Optional[int] = None,
        backoff: Optional[float] = None,
        window: Optional[int] = None,
    ):
        self.ladder: Tuple[int, ...] = tuple(sorted(set(int(r) for r in ladder)))
        if not self.ladder or self.ladder[0] < 1:
            raise ValueError(f"bad AIMD ladder {ladder!r}: rungs must be >= 1")
        self.slo_ms = float(
            slo_ms if slo_ms is not None else knobs.get_float("YTK_SERVE_SLO_MS")
        )
        self.inc = int(inc if inc is not None else knobs.get_int("YTK_SERVE_AIMD_INC"))
        self.backoff = float(
            backoff if backoff is not None
            else knobs.get_float("YTK_SERVE_AIMD_BACKOFF")
        )
        if not 0.0 < self.backoff < 1.0:
            raise ValueError(
                f"bad AIMD backoff {self.backoff!r}: must be in (0, 1)"
            )
        self.window = max(
            1,
            int(window if window is not None
                else knobs.get_int("YTK_SERVE_AIMD_WINDOW")),
        )
        # start one rung below the top (or the only rung): the search should
        # climb into the big batches, not start out violating the SLO
        start = self.ladder[-2] if len(self.ladder) > 1 else self.ladder[0]
        self._raw = float(start)
        self.max_batch = self._snap(self._raw)
        self.max_wait_ms = min(_WAIT_CAP_MS, self.slo_ms * _WAIT_SLO_FRACTION)
        self._window_worst_ms = 0.0
        self._window_batches = 0
        obs_gauge("serve.aimd.max_batch", self.max_batch)

    def _snap(self, raw: float) -> int:
        """Largest ladder rung <= raw (floor: the smallest rung)."""
        best = self.ladder[0]
        for r in self.ladder:
            if r <= raw:
                best = r
        return best

    # -- worker-thread side ----------------------------------------------

    def observe(self, latency_ms: float) -> None:
        """Feed one completed request's client-visible latency."""
        if latency_ms > self._window_worst_ms:
            self._window_worst_ms = latency_ms

    def note_batch(self) -> None:
        """One scored batch done; adjust once per `window` batches."""
        self._window_batches += 1
        if self._window_batches < self.window:
            return
        worst = self._window_worst_ms
        self._window_batches = 0
        self._window_worst_ms = 0.0
        before = self.max_batch
        if worst > self.slo_ms:
            # multiplicative decrease, floored at the smallest rung
            self._raw = max(float(self.ladder[0]), self._raw * self.backoff)
            obs_inc("serve.aimd.backoff")
        else:
            # additive increase, capped at the top rung (no headroom above
            # the ladder: the scorer has no warmed shape to grow into)
            self._raw = min(float(self.ladder[-1]), self._raw + self.inc)
            obs_inc("serve.aimd.increase")
        self.max_batch = self._snap(self._raw)
        if self.max_batch != before:
            obs_gauge("serve.aimd.max_batch", self.max_batch)
            obs_event(
                "serve.aimd.adjust",
                from_batch=before, to_batch=self.max_batch,
                worst_ms=round(worst, 3), slo_ms=self.slo_ms,
            )

    def snapshot(self) -> dict:
        return {
            "slo_ms": self.slo_ms,
            "max_batch": self.max_batch,
            "raw_target": round(self._raw, 2),
            "max_wait_ms": round(self.max_wait_ms, 3),
        }


def maybe_controller(ladder, slo_ms: Optional[float] = None):
    """An AIMDController when the SLO knob is armed, else None (fixed
    `max_batch`/`max_wait_ms` semantics). `slo_ms=0` disables explicitly."""
    slo = slo_ms if slo_ms is not None else knobs.get_float("YTK_SERVE_SLO_MS")
    if not slo or slo <= 0:
        return None
    return AIMDController(ladder, slo_ms=slo)
