"""Run-health sentinels + memory telemetry (the JAX package's
``obs/health.py``).

The obs core records evidence; this module *interprets* it at the few
places the host already syncs with the device — so a burning SLO or a
drifting input raises a flag (or, in strict mode, a `HealthError` carrying
a flight-dump path) instead of passing unseen.

Sentinels (all fire `health.*` counters + an `obs.event`, and log):

  SLOBurnSentinel(site, slo_ms)  serving SLO burn-rate: windowed request
                                 violation rate over the error budget
                                 fires `health.slo_burn`
                                 (YTK_SLO_BURN_{WINDOW,BUDGET})
  DriftSentinel(site)            serving input drift: consecutive
                                 quality-evaluator ticks with per-feature
                                 PSI/KS over threshold fire `health.drift`
                                 (YTK_HEALTH_DRIFT_{PSI,KS,WINDOWS,
                                 MIN_ROWS}; obs/quality.py feeds it)
  CalibrationSentinel(site)      mean predicted score vs the training
                                 sidecar's score distribution fires
                                 `health.calibration`
                                 (YTK_HEALTH_CALIBRATION_TOL)

Telemetry:

  record_memory(phase)           per-phase peak device memory
                                 (torch.cuda.max_memory_allocated and
                                 memory_stats() on a CUDA device; host RSS
                                 always) as `mem.*` gauges

The JAX package's compile watchers (install_trace_counters and
RetraceSentinel, over jax.monitoring) come with the profiler, and its
training sentinels (check_loss, ProgressGuard, check_ingest, check_tree and
YTK_HEALTH_INGEST_TOL) with the trainers that call them (ROADMAP.md 1.12).

Knobs:
  YTK_HEALTH=0            opt out of every sentinel (checks become one
                          attribute load + return — tier-1 contract)
  YTK_HEALTH_STRICT=1     escalate sentinel hits to HealthError (message
                          names the flight dump; read per-hit so tests and
                          operators can flip it at runtime)

Counters fire only while obs collection is enabled (`inc` is a no-op
otherwise); detection itself — and strict escalation — work either way,
so an un-instrumented production run still dies loudly instead of
silently.
"""

from __future__ import annotations

import logging
import math
import os
import threading
from typing import Optional

from . import core, recorder
from ..config import knobs

log = logging.getLogger("ytklearn_tpu_torch.obs.health")

class HealthError(RuntimeError):
    """A sentinel hit under YTK_HEALTH_STRICT=1. `dump_path` names the
    flight dump written at escalation time ("" when dumping failed)."""

    def __init__(self, message: str, dump_path: str = ""):
        super().__init__(message)
        self.dump_path = dump_path


class _HealthState:
    __slots__ = ("on", "strict")

    def __init__(self):
        self.on = knobs.get_bool("YTK_HEALTH")
        self.strict: Optional[bool] = None  # None -> read env per hit


_state = _HealthState()


def enabled() -> bool:
    return _state.on


def configure_health(
    on: Optional[bool] = None,
    strict: Optional[bool] = None,
) -> None:
    """Runtime override of the YTK_HEALTH* env knobs (tests; operators)."""
    if on is not None:
        _state.on = bool(on)
    if strict is not None:
        _state.strict = bool(strict)


def _strict() -> bool:
    if _state.strict is not None:
        return _state.strict
    return knobs.get_bool("YTK_HEALTH_STRICT")


def _fire(kind: str, site: str, msg: str, escalate: bool = True, **args) -> None:
    """Record one sentinel hit: `health.<kind>` counters + an instant obs
    event + a warning log line; under strict (and `escalate`) dump the
    flight ring and raise HealthError naming the dump."""
    core.inc(f"health.{kind}")
    core.inc(f"health.{kind}.{site}")
    core.event(f"health.{kind}", site=site, **args)
    log.warning("[health.%s] %s: %s", kind, site, msg)
    if escalate and _strict():
        path = recorder.dump(reason=f"health.{kind}:{site}")
        raise HealthError(
            f"health.{kind} at {site}: {msg} (flight dump: {path or 'unavailable'})",
            dump_path=path,
        )


class SLOBurnSentinel:
    """SLO burn-rate alarm for the serving layer (Clipper's SLO-first
    argument applied to the sentinel discipline): observe() every
    request's client-visible latency (or an explicit violation — a shed
    429 / deadline 504 burned budget without ever being scored), and once
    per full window of `window` requests judge the violation rate against
    the error `budget`. Crossing it fires `health.slo_burn` (counter +
    flight-ring event naming the rate, window, and SLO; strict mode
    escalates to HealthError like any other sentinel), then the window
    re-arms so a sustained burn fires once per window, not per request.

    Thread-safe: handler threads observe concurrently; the counters are
    advanced under a tiny lock and the fire happens OUTSIDE it (the
    strict path writes a flight dump — IO under a request-path lock would
    be a real stall).
    """

    __slots__ = ("site", "slo_ms", "window", "budget", "_viol", "_n",
                 "_lock", "windows_fired")

    def __init__(
        self,
        site: str,
        slo_ms: float,
        window: Optional[int] = None,
        budget: Optional[float] = None,
    ):
        self.site = site
        self.slo_ms = float(slo_ms)
        # no `or`-fallbacks here: the knobs carry declared defaults, and
        # an explicit 0 budget (zero-tolerance) must survive as 0
        self.window = max(1, int(
            window if window is not None
            else knobs.get_int("YTK_SLO_BURN_WINDOW")
        ))
        self.budget = float(
            budget if budget is not None
            else knobs.get_float("YTK_SLO_BURN_BUDGET")
        )
        self._viol = 0
        self._n = 0
        self._lock = threading.Lock()
        self.windows_fired = 0

    def observe(
        self, latency_ms: Optional[float] = None, violated: Optional[bool] = None,
        **args,
    ) -> bool:
        """Feed one request. True = budget intact (or health off)."""
        if not _state.on:
            return True
        if violated is None:
            violated = latency_ms is not None and latency_ms > self.slo_ms
        fire_rate = None
        with self._lock:
            self._n += 1
            if violated:
                self._viol += 1
            if self._n >= self.window:
                rate = self._viol / self._n
                if rate > self.budget:
                    fire_rate = rate
                    # counted under the lock (a lockless += would lose
                    # updates); only the _fire — which may write a flight
                    # dump — stays outside
                    self.windows_fired += 1
                self._n = 0
                self._viol = 0
        if fire_rate is None:
            return True
        _fire(
            "slo_burn",
            self.site,
            f"SLO burn: {100 * fire_rate:.1f}% of the last {self.window} "
            f"requests violated the {self.slo_ms:g} ms SLO "
            f"(budget {100 * self.budget:.1f}%)",
            rate=round(fire_rate, 4),
            window=self.window,
            budget=self.budget,
            slo_ms=self.slo_ms,
            **args,
        )
        return False


class DriftSentinel:
    """Input-drift alarm for the serving quality plane (obs/quality.py):
    fed once per evaluator tick with the worst per-feature PSI and KS of
    a served model versus its training sidecar. `windows` CONSECUTIVE
    over-threshold ticks fire `health.drift` (counter + flight-ring
    event naming the model and the offending features; strict mode
    escalates like every sentinel), then the streak re-arms so a
    sustained drift fires once per `windows` ticks, not per tick. Ticks
    with fewer than `min_rows` sampled rows are never judged — a
    two-request warmup is not a distribution.

    Fed from ONE thread (the quality evaluator; metrics scrapes use
    feed_sentinels=False), so the streak counter needs no lock.
    """

    __slots__ = ("site", "psi_threshold", "ks_threshold", "windows",
                 "min_rows", "_over", "fired")

    def __init__(
        self,
        site: str,
        psi_threshold: Optional[float] = None,
        ks_threshold: Optional[float] = None,
        windows: Optional[int] = None,
        min_rows: Optional[int] = None,
    ):
        self.site = site
        self.psi_threshold = float(
            psi_threshold if psi_threshold is not None
            else knobs.get_float("YTK_HEALTH_DRIFT_PSI")
        )
        self.ks_threshold = float(
            ks_threshold if ks_threshold is not None
            else knobs.get_float("YTK_HEALTH_DRIFT_KS")
        )
        self.windows = max(1, int(
            windows if windows is not None
            else knobs.get_int("YTK_HEALTH_DRIFT_WINDOWS")
        ))
        self.min_rows = int(
            min_rows if min_rows is not None
            else knobs.get_int("YTK_HEALTH_DRIFT_MIN_ROWS")
        )
        self._over = 0
        self.fired = 0

    def observe(
        self,
        psi: Optional[float],
        ks: Optional[float],
        rows: int,
        **args,
    ) -> bool:
        """Feed one evaluator tick. True = no drift alarm (or health off
        / not enough rows yet)."""
        if not _state.on:
            return True
        if rows < self.min_rows:
            return True
        over = (psi is not None and psi > self.psi_threshold) or (
            ks is not None and ks > self.ks_threshold
        )
        if not over:
            self._over = 0
            return True
        self._over += 1
        if self._over < self.windows:
            return True
        self._over = 0  # re-arm
        self.fired += 1
        psi_txt = f"{psi:.3f}" if psi is not None else "n/a"
        ks_txt = f"{ks:.3f}" if ks is not None else "n/a"
        _fire(
            "drift",
            self.site,
            f"input drift: PSI {psi_txt} (threshold "
            f"{self.psi_threshold:g}) / KS {ks_txt} (threshold "
            f"{self.ks_threshold:g}) over {rows} sampled rows",
            psi=round(psi, 4) if psi is not None else None,
            ks=round(ks, 4) if ks is not None else None,
            rows=rows,
            **args,
        )
        return False


class CalibrationSentinel:
    """Calibration-drift alarm: the mean predicted score/probability of
    serving traffic versus the training sidecar's score distribution
    (the McMahan calibration check, label-free). `windows` consecutive
    evaluator ticks with |mean_pred - baseline_mean| above
    `YTK_HEALTH_CALIBRATION_TOL` fire `health.calibration`, then
    re-arm. Same single-feeder-thread contract as DriftSentinel."""

    __slots__ = ("site", "tol", "windows", "min_rows", "_over", "fired")

    def __init__(
        self,
        site: str,
        tol: Optional[float] = None,
        windows: Optional[int] = None,
        min_rows: Optional[int] = None,
    ):
        self.site = site
        self.tol = float(
            tol if tol is not None
            else knobs.get_float("YTK_HEALTH_CALIBRATION_TOL")
        )
        self.windows = max(1, int(
            windows if windows is not None
            else knobs.get_int("YTK_HEALTH_DRIFT_WINDOWS")
        ))
        self.min_rows = int(
            min_rows if min_rows is not None
            else knobs.get_int("YTK_HEALTH_DRIFT_MIN_ROWS")
        )
        self._over = 0
        self.fired = 0

    def observe(self, delta: Optional[float], rows: int, **args) -> bool:
        """Feed one evaluator tick with the absolute mean-prediction
        delta. True = calibration intact (or health off / warming up)."""
        if not _state.on:
            return True
        if delta is None or rows < self.min_rows:
            return True
        if delta <= self.tol:
            self._over = 0
            return True
        self._over += 1
        if self._over < self.windows:
            return True
        self._over = 0  # re-arm
        self.fired += 1
        _fire(
            "calibration",
            self.site,
            f"calibration drift: mean prediction off the training "
            f"baseline by {delta:.4f} (tolerance {self.tol:g}) over "
            f"{rows} sampled rows",
            delta=round(delta, 6),
            rows=rows,
            **args,
        )
        return False


def root_health_counters(counters) -> dict:
    """The ROOT `health.<kind>` counters (the per-site
    `health.<kind>.<site>` breakdown would double-count every hit). THE
    definition of "a sentinel fired" — bench.py, the regression gate's
    old-artifact fallback, and the continual promotion gate all consume
    it and must agree, or one gate compares skewed numbers."""
    return {
        k: v
        for k, v in counters.items()
        if k.startswith("health.") and k.count(".") == 1
    }


def total_sentinel_hits(counters) -> int:
    """Sum of the root sentinel counters (see root_health_counters)."""
    return int(sum(root_health_counters(counters).values()))


# ---------------------------------------------------------------------------
# Telemetry: memory watermarks + recompilation counters
# ---------------------------------------------------------------------------


def _host_rss_peak_bytes() -> Optional[float]:
    try:
        import resource

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        # linux reports KiB, macOS bytes
        return float(rss * 1024 if os.uname().sysname == "Linux" else rss)
    # memory telemetry is best-effort: platforms without the resource
    # module just skip the gauge
    except Exception:  # noqa: BLE001
        return None


def _cuda_memory() -> Optional[dict]:
    """Peak and in-use bytes of the current CUDA device (the caching
    allocator's view), or None without one."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        stats = torch.cuda.memory_stats()
        return {
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(),
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
        }
    # a broken CUDA runtime falls back to host RSS below
    except Exception:  # noqa: BLE001
        return None


def record_memory(phase: str) -> None:
    """Publish `mem.<phase>.*` gauges: the CUDA device's peak/in-use bytes
    when there is one, host peak RSS always. One device query + two gauge
    writes — call at phase boundaries, never per row/round."""
    if not core.enabled():
        return
    stats = _cuda_memory()
    if stats:
        peak = stats.get("peak_bytes_in_use")
        in_use = stats.get("bytes_in_use")
        if peak is not None:
            core.gauge(f"mem.{phase}.device_peak_bytes", float(peak))
            prev = core.REGISTRY.gauges.get("mem.device_peak_bytes", 0.0)
            core.gauge("mem.device_peak_bytes", max(prev, float(peak)))
        if in_use is not None:
            core.gauge(f"mem.{phase}.device_bytes_in_use", float(in_use))
    rss = _host_rss_peak_bytes()
    if rss is not None:
        core.gauge(f"mem.{phase}.host_rss_peak_bytes", rss)
        core.gauge("mem.host_rss_peak_bytes", rss)

