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

The evidence lands in the obs plane (``obs/``) under the JAX package's
names: the counters `chaos.injected`, `chaos.injected.<site>`,
`io.retry.attempts`, `io.retry.<site>`, `io.retry.recovered`,
`io.retry.giveup` and `preempt.exits` in the obs registry, and the events
`chaos.inject`, `io.retry`, `io.retry.recovered`, `io.retry.giveup` and
`preempt.checkpoint` in its flight ring; each is logged as well. The
counters are written whether or not obs collection is on (in the JAX
package they land only while it is), so `counters()` always holds the
layer's evidence.
"""

from __future__ import annotations

from typing import Dict

from ..obs.core import REGISTRY

#: the counter namespaces of this layer
COUNTER_PREFIXES = ("chaos.", "io.retry.", "preempt.")


def inc(name: str, by: int = 1) -> None:
    """Add `by` to the obs registry's counter `name`."""
    REGISTRY.inc(name, float(by))


def counters() -> Dict[str, int]:
    """A snapshot of this layer's counters in the obs registry."""
    snap = REGISTRY.snapshot()["counters"]
    return {k: int(v) for k, v in snap.items()
            if k.startswith(COUNTER_PREFIXES)}


def reset_counters() -> None:
    """Drop this layer's counters from the obs registry."""
    with REGISTRY._lock:
        for k in [k for k in REGISTRY.counters
                  if k.startswith(COUNTER_PREFIXES)]:
            del REGISTRY.counters[k]


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
