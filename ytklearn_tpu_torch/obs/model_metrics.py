"""Per-model accounting plane (mesh-obs): scoped metric families.

Every serving signal used to be process-global — one latency ring, one
SLO-burn sentinel, global shed/504 counters — so an abusive tenant and
its victims were indistinguishable in `/metrics`, traces, and flight
dumps. This module gives each *registered* model name its own family:

  counters   `serve.model.<name>.{requests,request_rows,shed,
             deadline_expired,cache.hit,cache.miss,not_found}` — plain
             registry counters, so they ride the existing history-ring
             sampling, the fleet front's `serve.`-prefix scrape filter,
             and flight-dump snapshots for free, and are the same
             cached no-op as every other counter under YTK_OBS=0
  latency    a bounded per-model (wall_ts, ms) ring — the SAME sample
             shape as the process ring, so the fleet front's windowed
             ring union (serve/fleet/front.py) merges it unchanged
  sentinel   a per-model SLOBurnSentinel whose `health.slo_burn` event
             names the model (site `serve.model.<name>`); SLO resolved
             per model: YTK_SERVE_SLO_MODELS="name:ms,..." override,
             else the app-wide --slo-ms default

Cardinality is bounded BY CONSTRUCTION (the Prometheus label-flood
lesson): only `register()` — called for names the registry actually
loaded — can create a named family, and at most YTK_MODEL_METRICS_MAX
of them; everything else (404 name floods, names past the budget)
lands in the shared `__overflow__` bucket. The accounting identity the
mesh drill checks (exact conservation): every per-model counter is
incremented at the SAME call site as its global twin, so for each
counter pair, sum over families == the global value, always.

`ServeApp` owns one instance and publishes it as the process default so
flight dumps (obs/recorder.py) attach the per-model block and
postmortems name the tenant.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Dict, List, Optional

from . import core
from .health import SLOBurnSentinel
from ..config import knobs

#: the shared bucket for every name past the family budget (and for 404
#: floods of never-registered names) — bounded cardinality's escape hatch
OVERFLOW = "__overflow__"

#: counter namespace; the fleet front's scrape filter keeps `serve.*`
COUNTER_PREFIX = "serve.model."

#: per-model latency ring capacity (the process-global ring is 4096; a
#: model's share of traffic is smaller, and the fleet union windows on
#: timestamps anyway, so stale depth buys nothing)
RING_N = 1024


def parse_slo_models(spec: Optional[str]) -> Dict[str, float]:
    """Parse YTK_SERVE_SLO_MODELS ("name:ms,name2:ms") into {name: ms}.

    Malformed fragments raise ValueError: a typo'd SLO override must fail
    serve startup loudly, not silently arm the wrong budget."""
    out: Dict[str, float] = {}
    if not spec:
        return out
    for frag in spec.split(","):
        frag = frag.strip()
        if not frag:
            continue
        name, sep, ms = frag.rpartition(":")
        name = name.strip()
        if not sep or not name:
            raise ValueError(
                f"YTK_SERVE_SLO_MODELS fragment {frag!r}: expected 'name:ms'"
            )
        try:
            val = float(ms)
        except ValueError:
            raise ValueError(
                f"YTK_SERVE_SLO_MODELS fragment {frag!r}: {ms!r} is not a number"
            ) from None
        if not val > 0:
            raise ValueError(
                f"YTK_SERVE_SLO_MODELS fragment {frag!r}: SLO must be > 0 ms"
            )
        out[name] = val
    return out


class _ModelLatencyRing:
    """Bounded (wall_ts, ms) ring, multi-writer safe. Pairs, not bare
    floats: the fleet front WINDOWS the union on sample timestamps so an
    idle model's stale samples can't dilute the fleet percentile."""

    __slots__ = ("_ring", "_lock")

    def __init__(self, maxlen: int = RING_N):
        self._ring = collections.deque(maxlen=maxlen)
        self._lock = threading.Lock()

    def record(self, ms: float) -> None:
        with self._lock:
            self._ring.append((time.time(), float(ms)))

    def raw(self) -> list:
        """[[wall_ts, ms], ...] — the fleet ring-union input shape."""
        with self._lock:
            return [[round(t, 3), round(v, 3)] for t, v in self._ring]

    def values(self) -> List[float]:
        with self._lock:
            return [v for _, v in self._ring]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


class ModelFamily:
    """One model's scoped instruments: latency ring + burn sentinel.
    Counters live in the process obs registry under its name prefix."""

    __slots__ = ("scope", "slo_ms", "ring", "sentinel")

    def __init__(
        self,
        scope: str,
        slo_ms: float,
        burn_window: Optional[int] = None,
        burn_budget: Optional[float] = None,
    ):
        self.scope = scope
        self.slo_ms = float(slo_ms or 0.0)
        self.ring = _ModelLatencyRing()
        # the sentinel's site carries the model name, so both the
        # `health.slo_burn.serve.model.<name>` counter and the fired
        # event name the tenant
        self.sentinel = (
            SLOBurnSentinel(
                COUNTER_PREFIX + scope, self.slo_ms,
                window=burn_window, budget=burn_budget,
            )
            if self.slo_ms > 0 else None
        )


class ModelMetrics:
    """The bounded per-model family map. Hot-path reads (`family()`) are
    a plain dict get — families are only ever *added*, under `_lock`, and
    published by dict assignment (atomic under the GIL); the overflow
    family exists from construction so reads never miss."""

    def __init__(
        self,
        slo_ms: Optional[float] = None,
        max_models: Optional[int] = None,
        slo_models: Optional[Dict[str, float]] = None,
        burn_window: Optional[int] = None,
        burn_budget: Optional[float] = None,
    ):
        self.max_models = max(1, int(
            max_models if max_models is not None
            else knobs.get_int("YTK_MODEL_METRICS_MAX")
        ))
        self.slo_ms = float(slo_ms or 0.0)
        self.slo_models = (
            dict(slo_models) if slo_models is not None
            else parse_slo_models(knobs.get_str("YTK_SERVE_SLO_MODELS"))
        )
        self._burn_window = burn_window
        self._burn_budget = burn_budget
        self._lock = threading.Lock()
        self._collapsed: set = set()
        # overflow keeps the GLOBAL default SLO: models collapsed past
        # the budget still get burn protection, just not by name
        self._families: Dict[str, ModelFamily] = {
            OVERFLOW: ModelFamily(
                OVERFLOW, self.slo_ms, burn_window, burn_budget
            ),
        }

    # -- family admission -------------------------------------------------

    def register(self, name: str) -> str:
        """Admit a registry-loaded model name as a scoped family
        (idempotent). Returns the scope it landed on: the name itself, or
        OVERFLOW once the family budget is spent. Only this method
        creates named families — a request for an unknown name can never
        grow the map (the 404-flood bound)."""
        if not name or not isinstance(name, str) or name == OVERFLOW:
            return OVERFLOW
        if name in self._families:
            return name
        with self._lock:
            if name in self._families:
                return name
            if len(self._families) - 1 >= self.max_models:  # -1: overflow
                if name not in self._collapsed:
                    self._collapsed.add(name)
                    core.inc(
                        COUNTER_PREFIX + OVERFLOW + ".names_collapsed"
                    )
                return OVERFLOW
            self._families[name] = ModelFamily(
                name, self.slo_models.get(name, self.slo_ms),
                self._burn_window, self._burn_budget,
            )
            return name

    def scope_name(self, name: Optional[str]) -> str:
        """The family scope a name's signals land on (no creation)."""
        if name and isinstance(name, str) and name in self._families:
            return name
        return OVERFLOW

    def family(self, name: Optional[str]) -> ModelFamily:
        fam = (
            self._families.get(name)
            if name and isinstance(name, str) else None
        )
        return fam if fam is not None else self._families[OVERFLOW]

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    # -- recording (the serve hot path) -----------------------------------

    def record_request(self, name: Optional[str], rows: int,
                       ms: float) -> None:
        """One completed request (cache-hit or scored): mirrors the
        global `serve.requests`/`serve.request_rows` increments, feeds
        the model's latency ring and burn sentinel. Called at the SAME
        sites as the global counters — the conservation identity."""
        fam = self.family(name)
        pre = COUNTER_PREFIX + fam.scope
        core.inc(pre + ".requests")
        core.inc(pre + ".request_rows", float(rows))
        fam.ring.record(ms)
        if fam.sentinel is not None:
            fam.sentinel.observe(ms, model=fam.scope)

    def record_violation(self, name: Optional[str], status: int) -> None:
        """A shed 429 / deadline 504 burned the model's SLO budget
        without being scored. Counters for these land at the batcher's
        own shed/expiry sites; this only feeds the sentinel."""
        fam = self.family(name)
        if fam.sentinel is not None:
            fam.sentinel.observe(
                violated=True, model=fam.scope, status=int(status)
            )

    def record_not_found(self, name: Optional[str]) -> None:
        """404 on an unknown model name — lands in __overflow__ (only
        `register()` creates families), so a name-flood moves one
        counter, not the family map."""
        fam = self.family(name)
        core.inc(COUNTER_PREFIX + fam.scope + ".not_found")

    # -- export -----------------------------------------------------------

    def snapshot(self, raw: bool = False,
                 counters: Optional[dict] = None) -> dict:
        """The `/metrics?models=1` block (and the flight-dump block):
        per-family counters, latency percentiles (+ the raw ring when
        `raw` — the fleet union input), and sentinel state. `counters`
        accepts a pre-taken registry snapshot so one payload takes the
        registry lock once."""
        if counters is None:
            counters = (
                core.snapshot()["counters"] if core.enabled() else {}
            )
        # one percentile implementation serves the process ring, the
        # fleet union, and the per-model rings — lazy import: obs must
        # not import serve at module load
        from ..serve.fleet.front import latency_percentiles

        with self._lock:
            fams = [self._families[s] for s in sorted(self._families)]
        models = {}
        for fam in fams:
            pre = COUNTER_PREFIX + fam.scope + "."
            latency = latency_percentiles(fam.ring.values())
            if raw:
                latency["raw_ms"] = fam.ring.raw()
            block = {
                "counters": {
                    k[len(pre):]: round(v, 3)
                    for k, v in counters.items() if k.startswith(pre)
                },
                "latency": latency,
            }
            if fam.sentinel is not None:
                block["slo"] = {
                    "slo_ms": fam.sentinel.slo_ms,
                    "window": fam.sentinel.window,
                    "budget": fam.sentinel.budget,
                    "windows_fired": fam.sentinel.windows_fired,
                }
            models[fam.scope] = block
        return {"max_models": self.max_models, "models": models}


# -- process default (flight-dump attachment) ------------------------------

_default: Optional[ModelMetrics] = None


def set_default(mm: Optional[ModelMetrics]) -> None:
    """Publish the serving process's ModelMetrics so flight dumps
    (obs/recorder.py) attach the per-model block. Last writer wins —
    one ServeApp per process is the deployment shape."""
    global _default
    _default = mm


def get_default() -> Optional[ModelMetrics]:
    return _default


def flight_block() -> Optional[dict]:
    """The per-model block a flight dump carries (None when no serving
    app published a default — training processes dump without it)."""
    mm = _default
    if mm is None:
        return None
    return mm.snapshot()
