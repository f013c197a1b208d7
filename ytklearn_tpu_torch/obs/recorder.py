"""Flight recorder (the JAX package's ``obs/recorder.py``): a bounded ring
of the last N obs events plus a crash dump, so an abnormal exit leaves a
self-contained postmortem instead of a bare stack trace.

`install()` puts a `collections.deque(maxlen=N)` ring on the registry
(every span/event lands in it as it is recorded), then hooks the three
abnormal-exit paths:

  sys.excepthook   uncaught exception -> dump, then chain to the previous
                   hook (the traceback still prints)
  SIGTERM          dump, restore the previous handler, re-raise the signal
                   (exit status is still the signal's)
  SIGINT           dump, then hand back to the previous disposition — a
                   Ctrl-C postmortem gets the same flight dump a SIGTERM
                   does (the python default still raises KeyboardInterrupt
                   afterwards, so interactive semantics are unchanged)
  atexit           dump only when an abnormal condition was flagged earlier
                   (a clean exit writes nothing)

`dump()` writes `flight_<ts>_<pid>.json` to `YTK_FLIGHT_DIR` (default
`flight_dumps/`, created on demand — gitignored so a crash dump can
never end up committed).
The file is a valid Chrome-trace/Perfetto document — `traceEvents` holds
the ring as complete "X"/"i" events plus counter samples, so
https://ui.perfetto.dev opens it directly — with one extra `flight` block
(reason, raw ring, registry snapshot, config fingerprint, torch/CUDA/card
and process info).

Knobs:
  YTK_FLIGHT_N=4096              ring capacity (events)
  YTK_FLIGHT_DIR=flight_dumps    dump directory (gitignored default)
  YTK_FLIGHT=0        disable auto_install() (trainers call it; explicit
                      install() still works)

Disabled-path contract: with obs collection off, spans/events never reach
the registry, so the ring stays empty and `auto_install()` returns None
after one enabled() check — the same attribute-load-only budget as the
rest of the obs surface.
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import signal
import sys
import threading
import time
from collections import deque
from typing import Optional

from . import core
from ..config import knobs

log = logging.getLogger("ytklearn_tpu_torch.obs")

FLIGHT_SCHEMA_VERSION = 1
DEFAULT_RING_N = 4096


class _RecState:
    __slots__ = (
        "installed",
        "dir",
        "prev_excepthook",
        "prev_sigterm",
        "prev_sigint",
        "abnormal",
        "last_dump_path",
        "config_fingerprint",
        "dump_seq",
    )

    def __init__(self):
        self.installed = False
        self.dir: Optional[str] = None
        self.prev_excepthook = None
        self.prev_sigterm = None
        self.prev_sigint = None
        self.abnormal = False
        self.last_dump_path: Optional[str] = None
        self.config_fingerprint: Optional[dict] = None
        self.dump_seq = 0


_state = _RecState()
_install_lock = threading.Lock()


def installed() -> bool:
    return _state.installed


def last_dump_path() -> Optional[str]:
    return _state.last_dump_path


def thread_guard(fn):
    """Decorator for thread entry points: a worker must not die silently.

    An exception escaping a ``Thread(target=...)`` entry evaporates into
    threading's default excepthook — no obs event, nothing in the flight
    ring, and the first symptom is a subsystem that quietly stopped. The guard logs the exception, drops
    a ``thread.died`` event into the ring (so a later flight dump names
    the dead worker), and re-raises — semantics are otherwise unchanged.
    """
    import functools

    @functools.wraps(fn)
    def _guarded(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:
            log.exception(
                "thread entry %s died: %s: %s",
                getattr(fn, "__qualname__", fn), type(e).__name__, e,
            )
            core.event(
                "thread.died",
                entry=getattr(fn, "__qualname__", str(fn)),
                error=type(e).__name__,
            )
            raise
    return _guarded


def set_config_fingerprint(obj) -> None:
    """Record a compact fingerprint of the run config for the dump —
    a stable hash plus a short head of the repr (enough to tell two runs
    apart without serializing a whole params tree)."""
    import hashlib

    try:
        text = repr(obj)
    # a broken user repr must not kill training; the fingerprint degrades
    # to the type name
    except Exception:  # noqa: BLE001
        text = f"<unrepresentable {type(obj).__name__}>"
    _state.config_fingerprint = {
        "type": type(obj).__name__,
        "sha1": hashlib.sha1(text.encode("utf-8", "replace")).hexdigest(),
        "head": text[:400],
    }


def _flight_dir() -> str:
    return _state.dir or knobs.get_str("YTK_FLIGHT_DIR") or os.getcwd()


def _runtime_info() -> dict:
    import platform

    info = {
        "pid": os.getpid(),
        "argv": sys.argv,
        "python": sys.version.split()[0],
        "platform": platform.platform(),
    }
    if core.IDENTITY:
        # fleet postmortems must name the replica, not just a pid
        info["identity"] = dict(core.IDENTITY)
    # torch/device facts are best-effort: the dump must succeed even when
    # the crash IS a broken CUDA runtime
    try:
        import torch

        info["torch"] = torch.__version__
        info["cuda"] = torch.version.cuda
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["device_count"] = n
        info["device_kind"] = torch.cuda.get_device_name(0) if n else None
    except Exception as e:  # noqa: BLE001
        info["torch_error"] = f"{type(e).__name__}: {e}"[:200]
    return info


def dump(reason: str = "manual", exc: Optional[BaseException] = None) -> str:
    """Write the flight dump now; returns the path. Always writes a fresh
    file (timestamp + pid + sequence keyed), never raises — a failing dump
    logs and returns "" rather than masking the original crash."""
    try:
        return _dump(reason, exc)
    except Exception as e:  # noqa: BLE001 — the recorder must never be the crash
        log.error("flight dump failed: %s: %s", type(e).__name__, e)
        return ""


def _dump(reason: str, exc: Optional[BaseException]) -> str:
    from .export import chrome_trace_events

    # timed acquire, not `with`: the SIGTERM handler runs on the main
    # thread between bytecodes, so the signal can land while THIS thread
    # already holds the (non-reentrant) registry lock inside add_event —
    # a blocking acquire would deadlock a dying process. On timeout, copy
    # without the lock: GIL-atomic enough for a best-effort postmortem.
    locked = core.REGISTRY._lock.acquire(timeout=1.0)
    try:
        ring = list(core.REGISTRY.ring) if core.REGISTRY.ring is not None else []
        counters = dict(core.REGISTRY.counters)
        gauges = dict(core.REGISTRY.gauges)
    finally:
        if locked:
            core.REGISTRY._lock.release()

    # a throwaway registry holding only the ring -> reuse the exporter so
    # the dump is Perfetto-loadable without duplicating the conversion
    ring_reg = core.Registry()
    ring_reg.events = ring
    ring_reg.counters = counters
    trace_events = chrome_trace_events(ring_reg)

    flight = {
        "schema_version": FLIGHT_SCHEMA_VERSION,
        "reason": reason,
        "wall_time": time.time(),
        "wall_t0": core.WALL_T0,
        "ring": ring,
        "ring_capacity": (
            core.REGISTRY.ring.maxlen if core.REGISTRY.ring is not None else 0
        ),
        "snapshot": {"counters": counters, "gauges": gauges},
        "config_fingerprint": _state.config_fingerprint,
        "runtime": _runtime_info(),
    }
    if exc is not None:
        flight["exception"] = f"{type(exc).__name__}: {exc}"[:1000]
    try:
        from . import trace as _trace

        if _trace.enabled():
            # a serving postmortem carries its tail exemplars: the slow /
            # shed / 504'd request traces that were in the ring when the
            # process died (obs/trace.py; empty list when none were kept)
            flight["traces"] = _trace.exemplars()
    # the flight dump must land even when the trace plane is the broken part
    except Exception:  # noqa: BLE001
        pass
    try:
        from . import model_metrics as _model_metrics

        mm = _model_metrics.flight_block()
        if mm is not None:
            # a serving postmortem names the tenant: per-model counters,
            # latency percentiles, and burn-sentinel state (None — and
            # absent — outside a serving process)
            flight["model_metrics"] = mm
    # the flight dump must land even when the per-model plane is broken
    except Exception:  # noqa: BLE001
        pass

    _state.dump_seq += 1
    ts = time.strftime("%Y%m%d-%H%M%S")
    name = f"flight_{ts}_{os.getpid()}_{_state.dump_seq}.json"
    out_dir = _flight_dir()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, name)
    doc = {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "ytklearn_tpu_torch.obs.recorder"},
        "flight": flight,
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, default=str)
    os.replace(tmp, path)
    _state.last_dump_path = path
    log.warning("flight dump (%s) written to %s", reason, path)
    return path


def load_flight(path: str) -> dict:
    """Parse a flight dump back into its `flight` block (+ traceEvents)."""
    with open(path) as f:
        doc = json.load(f)
    out = dict(doc.get("flight") or {})
    out["traceEvents"] = doc.get("traceEvents") or []
    return out


def _excepthook(exc_type, exc, tb):
    _state.abnormal = True
    dump("excepthook", exc)
    prev = _state.prev_excepthook or sys.__excepthook__
    prev(exc_type, exc, tb)


def _sigterm_handler(signum, frame):
    _state.abnormal = True
    dump("sigterm")
    # restore the EXACT previous disposition (SIG_IGN included — a wrapper
    # that ignored SIGTERM must keep ignoring it after our dump), then
    # re-raise so the exit status is still the signal's
    prev = _state.prev_sigterm
    signal.signal(
        signal.SIGTERM, prev if prev is not None else signal.SIG_DFL
    )
    os.kill(os.getpid(), signal.SIGTERM)


def _sigint_handler(signum, frame):
    _state.abnormal = True
    dump("sigint")
    prev = _state.prev_sigint
    if callable(prev):
        # the python default (default_int_handler) raises KeyboardInterrupt
        # from here — exactly the old Ctrl-C semantics, now with a dump
        signal.signal(signal.SIGINT, prev)
        prev(signum, frame)
        return
    signal.signal(
        signal.SIGINT, prev if prev is not None else signal.SIG_DFL
    )
    os.kill(os.getpid(), signal.SIGINT)


def _atexit_handler():
    if _state.abnormal and _state.last_dump_path is None:
        dump("atexit")


def install(ring_n: Optional[int] = None, flight_dir: Optional[str] = None) -> None:
    """Install the ring + abnormal-exit hooks (idempotent)."""
    with _install_lock:
        n = ring_n or knobs.get_int("YTK_FLIGHT_N")
        if flight_dir:
            _state.dir = flight_dir
        with core.REGISTRY._lock:
            if core.REGISTRY.ring is None or core.REGISTRY.ring.maxlen != n:
                core.REGISTRY.ring = deque(core.REGISTRY.events[-n:], maxlen=n)
        if _state.installed:
            return
        _state.prev_excepthook = sys.excepthook
        sys.excepthook = _excepthook
        try:
            _state.prev_sigterm = signal.signal(signal.SIGTERM, _sigterm_handler)
            _state.prev_sigint = signal.signal(signal.SIGINT, _sigint_handler)
        except ValueError:
            _state.prev_sigterm = None  # non-main thread: excepthook/atexit only
            _state.prev_sigint = None
        atexit.register(_atexit_handler)
        _state.installed = True


def auto_install() -> None:
    """Trainer entry hook: install when obs is collecting (YTK_FLIGHT=0
    opts out). With obs disabled this is one enabled() check and a return —
    the no-op contract call sites rely on."""
    if not core.enabled():
        return
    if not knobs.get_bool("YTK_FLIGHT"):
        return
    install()


def uninstall() -> None:
    """Remove hooks + ring (test isolation; atexit stays registered but
    becomes a no-op once the abnormal flag is cleared)."""
    with _install_lock:
        if _state.installed:
            sys.excepthook = _state.prev_excepthook or sys.__excepthook__
            if _state.prev_sigterm is not None:
                try:
                    signal.signal(signal.SIGTERM, _state.prev_sigterm)
                except ValueError:
                    pass
            if _state.prev_sigint is not None:
                try:
                    signal.signal(signal.SIGINT, _state.prev_sigint)
                except ValueError:
                    pass
            _state.installed = False
        with core.REGISTRY._lock:
            core.REGISTRY.ring = None
    # the crash-path flags are LOCKLESS state by design: signal handlers
    # and the excepthook write them and a handler must never take a lock
    # (the interrupted thread may hold it — instant deadlock);
    # single-reference stores are atomic under the GIL.
    _state.abnormal = False
    _state.last_dump_path = None
    _state.config_fingerprint = None
