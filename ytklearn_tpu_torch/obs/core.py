"""Tracing + metrics core — one process-wide registry for every layer
(the JAX package's ``obs/core.py``, on its own).

Three primitives every layer shares:

  spans     nested wall-clock intervals (`with span("tree.grow", tree=t):`)
            with optional device-settled timing (`settle=` waits for the
            work queued on a torch tensor's device before the end
            timestamp is taken)
  counters  monotonically accumulated floats (`inc("ingest.rows", n)`)
  gauges    last-write-wins floats (`gauge("gbdt.partition", 1)`)

Everything lands in one `Registry`; the exporters (obs/export.py) turn it
into a JSONL event stream and a Chrome-trace/Perfetto JSON file.

Disabled-path contract (the < 1% tier-1 overhead budget): with obs off,
`span()` is one module-global attribute load plus a cached no-op context
manager, and `inc()`/`gauge()`/`event()` are one attribute load + return.
No locks, no allocation beyond the kwargs dict at the call site.

Env knobs (read once at import; `configure()` overrides at runtime):
  YTK_TRACE=path        enable + write a Chrome-trace JSON at process exit
  YTK_TRACE_JSONL=path  enable + write the JSONL event stream at exit
  YTK_OBS=1             enable collection without any export
  YTK_OBS=0             force-disable (wins over the path knobs)

The JAX package's YTK_OBS_JAX (XLA trace annotations around spans) has no
counterpart here: setting it raises NotImplementedError.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time
from typing import Dict, List, Optional

from ..config import knobs

# process-level clock origin: span timestamps are seconds since import on
# the monotonic clock (Chrome trace wants relative µs; JSONL carries the
# wall origin in its meta line so events can be re-anchored)
_T0 = time.perf_counter()
WALL_T0 = time.time()


def _now() -> float:
    return time.perf_counter() - _T0


class Registry:
    """Process-wide store for counters, gauges, and finished span events.

    Span *stacks* are thread-local (nesting is a per-thread property);
    counters/gauges/events are shared under one lock — contention is nil
    because the hot paths touch the registry a handful of times per
    tree/iteration, never per row.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self.counters: Dict[str, float] = {}
        self.gauges: Dict[str, float] = {}
        self.events: List[dict] = []
        # flight-recorder ring (obs/recorder.py): a bounded deque the
        # recorder installs so the last N events survive for a postmortem
        # dump even though `events` may be huge. None when not installed.
        self.ring = None
        # metrics history plane: per-metric bounded (wall_ts, value) rings
        # fed by sample_history() (the heartbeat sampler thread) so every
        # counter/gauge has a recent time series, not just a point-in-time
        # value. None until enable_history(); bounded per metric by
        # YTK_OBS_HISTORY_N. /metrics?history=1 exports it.
        self.history = None
        self._history_n = 0
        self._tls = threading.local()

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def inc(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0.0) + value

    def gauge(self, name: str, value: float) -> None:
        with self._lock:
            self.gauges[name] = float(value)

    def add_event(self, ev: dict) -> None:
        with self._lock:
            self.events.append(ev)
            if self.ring is not None:
                self.ring.append(ev)

    def snapshot(self) -> dict:
        """Point-in-time copy of counters + gauges (the bench/report
        surface; events are export-only)."""
        with self._lock:
            return {
                "counters": dict(self.counters),
                "gauges": dict(self.gauges),
            }

    def reset(self) -> None:
        with self._lock:
            self.counters.clear()
            self.gauges.clear()
            self.events.clear()
            if self.ring is not None:
                self.ring.clear()
            if self.history is not None:
                self.history.clear()

    # -- metrics history plane -------------------------------------------

    def enable_history(self, n: int) -> None:
        """Arm per-metric time-series rings of length `n` (idempotent at
        the same capacity; re-arming at a new capacity starts fresh)."""
        with self._lock:
            if self.history is None or self._history_n != n:
                self.history = {}
                self._history_n = max(1, int(n))

    def disable_history(self) -> None:
        with self._lock:
            self.history = None
            self._history_n = 0

    def sample_history(self, now: Optional[float] = None) -> None:
        """Append one (wall_ts, value) sample per live counter/gauge. One
        lock hold, dict-scan cost — called at the history interval (1 s
        default), never per request/row."""
        if self.history is None:
            return
        if now is None:
            now = time.time()
        ts = round(now, 3)
        with self._lock:
            hist = self.history
            if hist is None:  # disabled between check and lock
                return
            n = self._history_n
            for name, value in self.counters.items():
                ring = hist.get(name)
                if ring is None:
                    ring = hist[name] = collections.deque(maxlen=n)
                ring.append((ts, value))
            for name, value in self.gauges.items():
                ring = hist.get(name)
                if ring is None:
                    ring = hist[name] = collections.deque(maxlen=n)
                ring.append((ts, value))

    def history_snapshot(self) -> Optional[dict]:
        """{"series": {name: [[wall_ts, value], ...]}} or None when the
        history plane is off."""
        with self._lock:
            if self.history is None:
                return None
            return {
                "ring_n": self._history_n,
                "series": {
                    name: [[t, v] for t, v in ring]
                    for name, ring in sorted(self.history.items())
                },
            }


REGISTRY = Registry()

#: process identity attached to every obs event + flight dump (serve fleet:
#: a replica worker stamps its replica_id here at startup, so a fleet
#: postmortem names the sick replica instead of "some pid"). Empty = solo
#: process, nothing is attached. Written once at process start, read-only
#: after — no lock needed.
IDENTITY: Dict[str, object] = {}


def set_identity(**kw) -> None:
    """Stamp process identity (e.g. replica_id=3) onto every subsequent
    obs event and flight dump. Values must be JSON-serializable."""
    IDENTITY.update({k: v for k, v in kw.items() if v is not None})


class _State:
    __slots__ = ("enabled", "trace_path", "jsonl_path")

    def __init__(self):
        self.enabled = False
        self.trace_path: Optional[str] = None
        self.jsonl_path: Optional[str] = None


_state = _State()
_UNSET = object()


def enabled() -> bool:
    return _state.enabled


class _NoopSpan:
    """Cached do-nothing context manager — the whole disabled span path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **kw):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """An open span; records one complete ("X") event on exit.

    `settle` (a torch tensor, a list/tuple/dict of them, or a zero-arg
    callable returning one) is waited for before the end timestamp: the
    work queued on each CUDA tensor's device is synchronised — opt-in
    device-settled timing for spans that enqueue async device work.
    """

    __slots__ = ("name", "args", "t0", "_settle")

    def __init__(self, name: str, args: dict, settle=None):
        self.name = name
        self.args = args
        self._settle = settle

    def add(self, **kw) -> "Span":
        self.args.update(kw)
        return self

    def __enter__(self) -> "Span":
        REGISTRY._stack().append(self.name)
        self.t0 = _now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._settle is not None:
            try:
                target = self._settle() if callable(self._settle) else self._settle
                settle(target)
            # settle targets may be freed by exit time; timing must never
            # kill the run
            except Exception:  # noqa: BLE001
                pass
        t1 = _now()
        stack = REGISTRY._stack()
        if stack:
            stack.pop()
        ev = {
            "name": self.name,
            "ph": "X",
            "ts": self.t0,
            "dur": t1 - self.t0,
            "tid": threading.get_ident(),
            "depth": len(stack),
        }
        if self.args:
            ev["args"] = self.args
        if exc_type is not None:
            ev.setdefault("args", {})["error"] = exc_type.__name__
        REGISTRY.add_event(ev)
        return False


def span(name: str, settle=None, **args):
    """`with span("tree.grow", tree=t): ...` — no-op when obs is disabled.

    `settle`: a torch tensor (or a callable producing one) whose device
    is synchronised before the end timestamp (device-settled duration)."""
    if not _state.enabled:
        return NOOP_SPAN
    return Span(name, args, settle)


def inc(name: str, value: float = 1.0) -> None:
    if not _state.enabled:
        return
    REGISTRY.inc(name, value)


def gauge(name: str, value: float) -> None:
    if not _state.enabled:
        return
    REGISTRY.gauge(name, value)


def event(name: str, **args) -> None:
    """Instant event (Chrome-trace "i" phase) — a point-in-time marker."""
    if not _state.enabled:
        return
    ev = {
        "name": name,
        "ph": "i",
        "ts": _now(),
        "tid": threading.get_ident(),
        "depth": len(REGISTRY._stack()),
    }
    if IDENTITY:
        args = {**IDENTITY, **args} if args else dict(IDENTITY)
    if args:
        ev["args"] = args
    REGISTRY.add_event(ev)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()


# ---------------------------------------------------------------------------
# Device settling for span(settle=...)
# ---------------------------------------------------------------------------


def _cuda_devices(x, out: set) -> None:
    """Collect the CUDA devices of every tensor in `x` and of the tensors
    in its nested lists, tuples and dicts."""
    dev = getattr(x, "device", None)
    if dev is not None and getattr(dev, "type", None) == "cuda":
        out.add(dev)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)


def settle(x) -> None:
    """Wait for the work queued on the devices of `x` (a tensor or a
    container of them); CPU tensors are already settled. The counterpart
    of the JAX package's block_until_ready."""
    devs: set = set()
    _cuda_devices(x, devs)
    if devs:
        import torch

        for d in devs:
            torch.cuda.synchronize(d)


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------

_atexit_registered = False


def _ensure_atexit() -> None:
    global _atexit_registered
    if _atexit_registered:
        return
    import atexit

    atexit.register(flush)
    _atexit_registered = True


def flush() -> None:
    """Write the configured exports now (also runs at process exit)."""
    from .export import export_chrome_trace, export_jsonl

    if _state.trace_path:
        export_chrome_trace(_state.trace_path, REGISTRY)
    if _state.jsonl_path:
        export_jsonl(_state.jsonl_path, REGISTRY)


def configure(
    enabled: Optional[bool] = None,
    trace_path=_UNSET,
    jsonl_path=_UNSET,
) -> None:
    """Runtime configuration (the CLI's --trace-out lands here).

    Setting a non-empty export path implies enabled=True unless `enabled`
    is explicitly passed as False in the same call."""
    if trace_path is not _UNSET:
        _state.trace_path = trace_path or None
        if trace_path and enabled is None:
            enabled = True
    if jsonl_path is not _UNSET:
        _state.jsonl_path = jsonl_path or None
        if jsonl_path and enabled is None:
            enabled = True
    if enabled is not None:
        _state.enabled = bool(enabled)
    if _state.trace_path or _state.jsonl_path:
        _ensure_atexit()


def refuse_unported() -> None:
    """The obs knobs of the JAX package that have no counterpart here
    raise, like the port's other refusals."""
    if knobs.get_bool("YTK_OBS_JAX"):
        raise NotImplementedError(
            "YTK_OBS_JAX (XLA trace annotations around obs spans) has no "
            "counterpart in the PyTorch port; unset it")


def _configure_from_env() -> None:
    refuse_unported()
    flag = knobs.get_raw("YTK_OBS")
    if flag == "0":  # force-off wins over everything
        return
    trace = knobs.get_str("YTK_TRACE")
    jsonl = knobs.get_str("YTK_TRACE_JSONL")
    if trace or jsonl or flag == "1":
        configure(enabled=True, trace_path=trace, jsonl_path=jsonl)


_configure_from_env()
