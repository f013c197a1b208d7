"""The fault-tolerance layer (``ytklearn_tpu/resilience``), on its own.

Three pillars over the atomic dumps (``io/fs.py::atomic_open``):

  chaos     deterministic fault injection: named `chaos_point(site)`
            seams armed by `YTK_CHAOS=<site>:<kind>:<rate>:<seed>` with
            counter-based draws, so every injected fault reproduces
            exactly and leaves a counter behind
  retry     `retry_call(fn, site)` and `retry_lines`: exponential backoff,
            deterministic jitter, typed transient-vs-fatal classification
  preempt   `PreemptionGuard`: SIGTERM/SIGINT deferred to the next safe
            training boundary, an emergency checkpoint through the
            ordinary dump path, `Preempted` -> exit 128+signum; the
            relaunch resumes with `--resume auto`

Knobs: YTK_CHAOS, YTK_RETRY_{MAX,BASE_S,MAX_S}, YTK_PREEMPT.

The reference records its evidence in its obs plane (counters, flight-ring
events, the flight recorder's dumps). The port has no obs plane yet
(ROADMAP.md 1.12): the layer counts into the one map below, under the
reference's counter names (`chaos.injected`, `chaos.injected.<site>`,
`io.retry.attempts`, `io.retry.<site>`, `io.retry.recovered`,
`io.retry.giveup`, `preempt.exits`), and logs each event.
"""

from __future__ import annotations

import threading
from typing import Dict

_COUNTERS: Dict[str, int] = {}
_COUNTERS_LOCK = threading.Lock()


def inc(name: str, by: int = 1) -> None:
    """Add `by` to counter `name`."""
    with _COUNTERS_LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + by


def counters() -> Dict[str, int]:
    """A snapshot of every counter."""
    with _COUNTERS_LOCK:
        return dict(_COUNTERS)


def reset_counters() -> None:
    with _COUNTERS_LOCK:
        _COUNTERS.clear()


from .chaos import (  # noqa: E402,F401
    FAULT_SITES,
    KINDS,
    ChaosError,
    ChaosOSError,
    ChaosRule,
    chaos_enabled,
    chaos_point,
    parse_chaos_spec,
    reset_chaos,
    site_draw,
)
from .preempt import (  # noqa: E402,F401
    Preempted,
    PreemptionGuard,
    preemption_guard,
    trainer_guard,
)
from .retry import (  # noqa: E402,F401
    RetryPolicy,
    is_transient,
    retry_call,
    retry_lines,
)

__all__ = [
    "FAULT_SITES",
    "KINDS",
    "ChaosError",
    "ChaosOSError",
    "ChaosRule",
    "Preempted",
    "PreemptionGuard",
    "RetryPolicy",
    "chaos_enabled",
    "chaos_point",
    "counters",
    "inc",
    "is_transient",
    "parse_chaos_spec",
    "preemption_guard",
    "reset_chaos",
    "reset_counters",
    "retry_call",
    "retry_lines",
    "site_draw",
    "trainer_guard",
]
