"""Rate-limited structured progress logging — the replacement for bare
`print(..., file=sys.stderr)` progress lines.

A Heartbeat logs through the standard logging stack at most once per
`every_s` seconds (the first beat always fires), and mirrors each emitted
beat into the obs registry as an instant event + a beat counter when obs
is enabled. Call `.beat(...)` as often as you like from a loop; the cost
of a suppressed beat is one time.time() call.

Derived rates: for every numeric field, an emitted beat also reports the
rate since the PREVIOUS emitted beat (`rows=512000` grows a
`rows_per_s=17066.7`), so a 30 s ingest heartbeat reads as throughput,
not as a cumulative count you must difference by hand. Rates are computed
between fired beats only (suppressed beats don't reset the window), skip
non-monotone fields (a counter that went down is re-baselined, not
reported as a negative rate), and never appear on the first beat.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional

from . import core
from .recorder import thread_guard
from ..config import knobs

log = logging.getLogger("ytklearn_tpu_torch.obs")


class Heartbeat:
    __slots__ = ("name", "every_s", "_last", "_log", "_prev", "_prev_t")

    def __init__(
        self,
        name: str,
        every_s: float = 30.0,
        logger: Optional[logging.Logger] = None,
    ):
        self.name = name
        self.every_s = float(every_s)
        self._last = 0.0  # epoch 0 -> the first beat always fires
        self._log = logger or log
        self._prev: Dict[str, float] = {}  # numeric fields at last fired beat
        self._prev_t = 0.0

    def _rates(self, now: float, fields: dict) -> Dict[str, float]:
        dt = now - self._prev_t
        rates: Dict[str, float] = {}
        if self._prev and dt > 0:
            for k, v in fields.items():
                prev = self._prev.get(k)
                if (
                    prev is not None
                    and isinstance(v, (int, float))
                    and not isinstance(v, bool)
                    and v >= prev
                ):
                    rates[f"{k}_per_s"] = round((v - prev) / dt, 1)
        return rates

    def beat(self, msg: str = "", force: bool = False, **fields) -> bool:
        """Emit one progress line (+ obs event) unless rate-limited.
        Returns True when the beat fired."""
        now = time.time()
        if not force and (now - self._last) < self.every_s:
            return False
        self._last = now
        rates = self._rates(now, fields)
        text = msg
        shown = {**fields, **rates}
        if shown:
            kv = " ".join(f"{k}={v}" for k, v in shown.items())
            text = f"{text} {kv}".strip()
        self._log.info("[%s] %s", self.name, text)
        if core.enabled():
            core.REGISTRY.inc(f"heartbeat.{self.name}", 1.0)
            core.event(f"heartbeat.{self.name}", msg=text, **rates)
        # re-baseline on every fired beat (rates are beat-to-beat)
        self._prev = {
            k: float(v)
            for k, v in fields.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        }
        self._prev_t = now
        return True


def heartbeat(name: str, every_s: float = 30.0, logger=None) -> Heartbeat:
    return Heartbeat(name, every_s=every_s, logger=logger)


# ---------------------------------------------------------------------------
# Metrics-history sampler: the obs heartbeat thread
# ---------------------------------------------------------------------------

#: the singleton sampler thread + its stop event; guarded by _sampler_lock
#: (start is called from ServeApp/FleetFront start paths concurrently)
_sampler: Optional[threading.Thread] = None
_sampler_stop: Optional[threading.Event] = None
_sampler_lock = threading.Lock()


@thread_guard
def _sampler_loop(stop: threading.Event, interval_s: float) -> None:
    while not stop.wait(interval_s):
        if core.enabled():
            core.REGISTRY.sample_history()


def start_history_sampler(
    interval_s: Optional[float] = None, ring_n: Optional[int] = None
) -> bool:
    """Arm the metrics history plane: per-metric (ts, value) rings on the
    registry plus one process-wide daemon thread sampling them every
    `interval_s` (YTK_OBS_HISTORY_S). Idempotent — the serving layer calls
    this at every start(). Returns True when the plane is armed, False
    when YTK_OBS_HISTORY_N=0 disables it."""
    global _sampler, _sampler_stop
    n = ring_n if ring_n is not None else knobs.get_int("YTK_OBS_HISTORY_N")
    if not n or n <= 0:
        return False
    every = (interval_s if interval_s is not None
             else knobs.get_float("YTK_OBS_HISTORY_S")) or 1.0
    core.REGISTRY.enable_history(n)
    core.REGISTRY.sample_history()  # t=0 sample: history is never empty
    with _sampler_lock:
        if _sampler is not None and _sampler.is_alive():
            return True
        stop = threading.Event()
        t = threading.Thread(
            target=_sampler_loop, args=(stop, float(every)),
            name="ytk-obs-history", daemon=True,
        )
        _sampler, _sampler_stop = t, stop
        t.start()
    return True


def stop_history_sampler(disable: bool = True) -> None:
    """Stop the sampler thread (joined) and, by default, drop the history
    rings — test isolation; production processes just exit."""
    global _sampler, _sampler_stop
    with _sampler_lock:
        t, stop = _sampler, _sampler_stop
        _sampler, _sampler_stop = None, None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=10.0)
    if disable:
        core.REGISTRY.disable_history()
