"""ytkprof — device-time, build-cost, and memory-watermark profiling (the
JAX package's ``obs/profiler.py``, over torch.profiler and torch.cuda).

The span substrate answers *what ran and for how long on the host*; this
plane answers the three questions it could not:

  where does **device** time go?   phase accounting + an opt-in
      `torch.profiler.profile(activities=[CPU, CUDA])` capture per phase,
      exported as a Chrome trace and parsed into device-time buckets per
      named span and a top-k kernel table. While the plane is on, every
      obs span opens a `torch.profiler.record_function` of its name, and
      every launch of a hand-written kernel one named `kernel.<name>`
      (`hist`, `hist_gather`, `route`, `heap_walk`, ...: the names of
      chip_smoke.py's kernels line), so the table names the port's
      kernels with their launch counts. On the card the device time is the
      trace's `kernel`, `gpu_memcpy` and `gpu_memset` events; on the CPU
      the top-level `cpu_op` events stand in for kernels.

  why did a steady-state **rebuild** fire?   a build ledger records every
      build the process pays: an nvcc build of a kernel library
      (cuda_build.py::KernelLibrary), a g++ build of a host library
      (io/native.py: the text parser, the serving library), a load of a
      library already built (a cache hit: kind "load", not "build"), and
      the first launch in the process of a kernel *instantiation* (the
      kernel plus its plan kind or template arguments: kind
      "instantiate"; it pays the lazy module load). The port is eager
      PyTorch: its kernels take their shapes as arguments, so a new shape
      is not a compile, and work that a later round or a padded batch
      repeats at a new size is never counted. Instrumented call sites
      label builds through `LEDGER.program(...)`; the RetraceSentinel
      asks the ledger for entries since it armed, so `health.retrace`
      names the culprit program and kernel.

  what allocated the memory?   a background watermark sampler feeds the
      CUDA caching allocator's bytes in use and peak
      (`torch.cuda.memory_allocated` / `max_memory_allocated`) and host
      RSS into bounded history rings and attributes peak watermarks to
      the enclosing profiler phase. The CUDA peak is process-wide, so
      every phase boundary reads it, credits it to the phase that was
      current, and resets it (`torch.cuda.reset_peak_memory_stats`):
      a later phase never inherits an earlier one's peak. The phase
      peaks ride flight dumps, so an OOM postmortem names the phase.

Disabled-path contract (the JAX package's): with `YTK_PROF` unset/`0`,
`phase()` is one module-global attribute load plus the obs core's span
(the cached NOOP_SPAN when obs is off too), and `LEDGER.program()`
returns one cached no-op — zero new per-call work.

Knobs: YTK_PROF (`1` = on, a path = on + capture dir), YTK_PROF_TOPK,
YTK_PROF_MEM_S, YTK_PROF_LEDGER_N. The CLI's `--profile [DIR]` lands on
`configure_profiler()`.
"""

from __future__ import annotations

import collections
import gzip
import json
import logging
import os
import re
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ..config import knobs
from . import core
from .recorder import thread_guard

log = logging.getLogger("ytklearn_tpu_torch.obs.profiler")

_UNSET = object()

SCHEMA = "ytkprof"

# signature strings are capped so a pathological argument tree cannot
# bloat events, ledger entries, or flight dumps
_SIG_MAX_LEAVES = 256
_DIFF_MAX_LINES = 16

#: the record_function prefix of a hand-written kernel's launch
KERNEL_PREFIX = "kernel."


class _ProfState:
    __slots__ = ("on", "capture_dir", "topk", "mem_interval")

    def __init__(self):
        self.on = False
        self.capture_dir: Optional[str] = None
        self.topk = 10
        self.mem_interval = 0.5


_state = _ProfState()


def enabled() -> bool:
    return _state.on


def capture_dir() -> Optional[str]:
    return _state.capture_dir


# ---------------------------------------------------------------------------
# Phase accounting
# ---------------------------------------------------------------------------


class _NoopPhase:
    """Cached do-nothing context manager — the whole disabled path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP_PHASE = _NoopPhase()

#: per-process phase stack shared across threads *for reading* by the mem
#: sampler (which must attribute a sample to "the phase the trainer is in
#: right now"); writes happen under _acc_lock. Entries are phase names.
_phase_stack: List[str] = []

_acc_lock = threading.Lock()
#: name -> {"wall_s": float, "count": int, "depth": int(min seen)}
_phases: "collections.OrderedDict[str, dict]" = collections.OrderedDict()
#: (phase_name, capture_subdir) for every completed torch.profiler capture
_captures: List[Tuple[str, str]] = []
#: only one torch.profiler may be live per process
_capture_active = threading.Lock()


def current_phase() -> Optional[str]:
    """Innermost open profiler phase (None outside any phase). Lock-free
    read of the shared stack — worst case the sampler sees a phase one
    tick stale, which is fine for watermark attribution."""
    st = _phase_stack
    return st[-1] if st else None


class Capture:
    """One live `torch.profiler.profile` over the CPU, and the CUDA device
    when there is one, holding the process's one profiler slot until
    stop() exports its Chrome trace into `out_dir`."""

    __slots__ = ("_prof", "out_dir")

    def __init__(self, prof, out_dir: str):
        self._prof = prof
        self.out_dir = out_dir

    def stop(self) -> Optional[str]:
        """Stop after the device's queued work, export `trace.json` and
        free the slot: the trace's path, or None (counted as
        `prof.capture.failed`) when the runtime tore down mid-capture."""
        try:
            core.settle_all()
            self._prof.__exit__(None, None, None)
            os.makedirs(self.out_dir, exist_ok=True)
            path = os.path.join(self.out_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            return path
        except Exception as e:  # noqa: BLE001 — a capture never stops a run
            log.warning("prof capture stop failed: %s", e)
            core.inc("prof.capture.failed")
            return None
        finally:
            _capture_active.release()


def start_capture(out_dir: str, what: str) -> Optional[Capture]:
    """A started Capture into `out_dir`, or None: when another capture
    holds the profiler (counted as `prof.capture.skipped`, as a second
    concurrent request or a YTK_PROFILE_DIR trace already running is) or
    the profiler fails to start (`prof.capture.failed`); never raises out
    of the caller's work."""
    if not _capture_active.acquire(blocking=False):
        core.inc("prof.capture.skipped")
        return None
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        return Capture(prof, out_dir)
    except Exception as e:  # noqa: BLE001 — a capture never stops a run
        log.warning("prof capture start failed for %s: %s", what, e)
        core.inc("prof.capture.failed")
        _capture_active.release()
        return None


class _Phase:
    __slots__ = ("name", "_span", "_capture", "_cap", "_t0")

    def __init__(self, name: str, settle, capture: bool, args: dict):
        self.name = name
        self._span = core.span(name, settle=settle, **args)
        self._capture = capture
        self._cap: Optional[Capture] = None

    def __enter__(self) -> "_Phase":
        # the capture's start is the phase's cost too: torch.profiler's
        # first start initialises its tracer
        self._t0 = time.perf_counter()
        # the peak so far belongs to the phase that was current until now
        MEM.boundary()
        with _acc_lock:
            _phase_stack.append(self.name)
        # the capture opens *before* the span: the span's record_function
        # must fall inside the profiled window to be the capture's
        # top-level bucket
        if self._capture and _state.capture_dir:
            self._cap = start_capture(
                os.path.join(_state.capture_dir, "%s_%d" % (
                    self.name.replace("/", "_"), os.getpid())), self.name)
        self._span.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        # Span.__exit__ runs the settle before its end timestamp; exiting
        # the span *before* taking our own end time means the accountant
        # records the settled duration too
        self._span.__exit__(exc_type, exc, tb)
        if self._cap is not None and self._cap.stop() is not None:
            with _acc_lock:
                _captures.append((self.name, self._cap.out_dir))
        # the capture's export is the phase's cost too (as the JAX
        # package's stop_trace is): coverage stays a full decomposition
        dt = time.perf_counter() - self._t0
        MEM.boundary()  # this phase's peak, while it is still current
        with _acc_lock:
            if _phase_stack:
                _phase_stack.pop()
            depth = len(_phase_stack)
            rec = _phases.get(self.name)
            if rec is None:
                _phases[self.name] = {"wall_s": dt, "count": 1, "depth": depth}
            else:
                rec["wall_s"] += dt
                rec["count"] += 1
                if depth < rec["depth"]:
                    rec["depth"] = depth
        return False


def phase(name: str, settle=None, capture: bool = False, **args):
    """`with profiler.phase("gbdt.train", capture=True): ...`

    Opens an obs span (which opens its record_function while the plane is
    on), pushes the phase for watermark attribution, optionally wraps the
    body in a torch.profiler capture, and records settled wall time into
    the phase accountant.

    With the plane off this *is* `core.span(...)`: with obs off too the
    whole call is the same cached NOOP_SPAN."""
    if not _state.on:
        return core.span(name, settle=settle, **args)
    return _Phase(name, settle, capture, args)


def phases_snapshot() -> Dict[str, dict]:
    """{name: {wall_s, count, depth}} in first-seen order."""
    with _acc_lock:
        return {k: dict(v) for k, v in _phases.items()}


def coverage(wall_s: float) -> float:
    """Fraction of `wall_s` decomposed by top-level (depth-0) phases."""
    if wall_s <= 0:
        return 0.0
    with _acc_lock:
        top = sum(v["wall_s"] for v in _phases.values() if v["depth"] == 0)
    return min(1.0, top / wall_s)


# ---------------------------------------------------------------------------
# Abstract signatures (the retrace culprit vocabulary)
# ---------------------------------------------------------------------------


def _dtype_name(dtype) -> str:
    """numpy's dtype names for torch dtypes too (`torch.float32` ->
    `float32`), so both packages write the same signatures."""
    name = getattr(dtype, "name", None)
    if name:
        return name
    s = str(dtype)
    return s[6:] if s.startswith("torch.") else s


def _leaf_abstract(x) -> str:
    shape = getattr(x, "shape", None)
    dtype = getattr(x, "dtype", None)
    if shape is not None and dtype is not None:
        try:
            return "%s[%s]" % (_dtype_name(dtype),
                               ",".join(str(int(d)) for d in shape))
        except Exception:  # noqa: BLE001 — odd dtypes fall back below
            pass
    return type(x).__name__


def _is_leaf(x) -> bool:
    return not isinstance(x, (list, tuple, dict)) or hasattr(x, "shape")


def _flatten(x, path: str, out: List[Tuple[str, Any]]) -> None:
    """Leaves of nested lists, tuples, dicts and dataclass-like objects
    with their key paths, in the JAX package's `keystr` spelling: `[0]`
    for a sequence index, `['w']` for a dict key, `.w` for a field (dict
    keys sorted, as jax.tree_util sorts them). None is an empty node."""
    if x is None:
        return
    if isinstance(x, dict):
        for k in sorted(x):
            _flatten(x[k], "%s[%r]" % (path, k), out)
    elif isinstance(x, (list, tuple)) and not hasattr(x, "shape"):
        fields = getattr(x, "_fields", None)
        for i, v in enumerate(x):
            _flatten(v, "%s.%s" % (path, fields[i]) if fields
                     else "%s[%d]" % (path, i), out)
    elif hasattr(x, "__dataclass_fields__"):
        for k in x.__dataclass_fields__:
            _flatten(getattr(x, k), "%s.%s" % (path, k), out)
    else:
        out.append((path, x))


def abstract_signature(*trees) -> List[List[str]]:
    """Flatten argument trees into `[path, "float32[4,8]"]` pairs — a
    JSON-friendly abstract signature of a call's tensors, arrays and
    scalars. Capped at _SIG_MAX_LEAVES leaves (a trailing marker records
    the overflow)."""
    out: List[List[str]] = []
    for i, tree in enumerate(trees):
        leaves: List[Tuple[str, Any]] = []
        _flatten(tree, "", leaves)
        for path, leaf in leaves:
            if len(out) >= _SIG_MAX_LEAVES:
                return out + [["...", "+more leaves"]]
            out.append(["args[%d]%s" % (i, path), _leaf_abstract(leaf)])
    return out


def signature_diff(old, new) -> List[str]:
    """Human-readable lines naming what changed between two signatures
    (`args[0][1]: float32[4,8] -> float32[5,8]`; added/removed leaves
    included)."""
    if old is None or new is None:
        return []
    o = {p: a for p, a in old}
    n = {p: a for p, a in new}
    lines: List[str] = []
    for p, a in new:
        if p not in o:
            lines.append("%s: added %s" % (p, a))
        elif o[p] != a:
            lines.append("%s: %s -> %s" % (p, o[p], a))
        if len(lines) >= _DIFF_MAX_LINES:
            lines.append("...")
            return lines
    for p, a in old:
        if p not in n:
            lines.append("%s: removed %s" % (p, a))
            if len(lines) >= _DIFF_MAX_LINES:
                lines.append("...")
                return lines
    return lines


# ---------------------------------------------------------------------------
# Build ledger
# ---------------------------------------------------------------------------


class CompileLedger:
    """Every build the process pays, named (the JAX package's compile
    ledger). The build sites (cuda_build.py, io/native.py, the shared
    launch counter) report each build, load and first instantiation
    through `obs.health.note_compile`, which carries no call-site identity,
    so instrumented call sites push a label (and a lazy signature thunk)
    onto a thread-local stack via `program()`; `on_compile` attributes the
    build to the innermost label, computes the signature diff against that
    program's previous entry, and appends a bounded ledger entry with its
    kind ("build", "load" or "instantiate") and what was built (`kernel`).
    Unlabelled builds land as `<unlabeled>` — still counted, still timed.
    `compiles` counts every entry (the JAX package's key), `loads` the
    loads among them; the retrace sentinel reads builds and
    instantiations only (obs/health.py)."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._tls = threading.local()
        self.entries: "collections.deque[dict]" = collections.deque(maxlen=maxlen)
        self._last_sig: Dict[str, Any] = {}
        self._by_program: Dict[str, dict] = {}
        self.seq = 0

    # -- labelling ----------------------------------------------------------

    class _ProgramCtx:
        __slots__ = ("_ledger", "_frame")

        def __init__(self, ledger, frame):
            self._ledger = ledger
            self._frame = frame

        def __enter__(self):
            st = getattr(self._ledger._tls, "labels", None)
            if st is None:
                st = self._ledger._tls.labels = []
            st.append(self._frame)
            return self

        def __exit__(self, *exc):
            st = getattr(self._ledger._tls, "labels", None)
            if st:
                st.pop()
            return False

    def program(self, name: str, sig=None, sig_fn=None):
        """`with LEDGER.program("gbdt.round", sig_fn=lambda: ...):` — any
        build inside the body is attributed to `name`. `sig_fn` is only
        called if a build actually lands. Cached no-op when off."""
        if not _state.on:
            return NOOP_PHASE
        return CompileLedger._ProgramCtx(self, (name, sig, sig_fn))

    def _current_label(self):
        st = getattr(self._tls, "labels", None)
        return st[-1] if st else None

    # -- the watcher's entry point ------------------------------------------

    def on_compile(self, duration_s: float, kind: str = "build",
                   kernel: Optional[str] = None) -> None:
        if not _state.on:
            return
        frame = self._current_label()
        if frame is None:
            name, sig = "<unlabeled>", None
        else:
            name, sig, sig_fn = frame
            if sig is None and sig_fn is not None:
                try:
                    sig = sig_fn()
                except Exception:  # noqa: BLE001 — freed args: no signature
                    sig = None
        ms = duration_s * 1000.0
        with self._lock:
            self.seq += 1
            prev = self._last_sig.get(name)
            changed = signature_diff(prev, sig) if sig is not None else []
            if sig is not None:
                self._last_sig[name] = sig
            entry = {
                "seq": self.seq,
                "ts": round(time.time(), 3),
                "program": name,
                "ms": round(ms, 3),
                "kind": kind,
            }
            if kernel is not None:
                entry["kernel"] = kernel
            if sig is not None:
                entry["sig"] = sig
            if changed:
                entry["changed"] = changed
            self.entries.append(entry)
            agg = self._by_program.setdefault(
                name, {"compiles": 0, "ms": 0.0, "loads": 0})
            agg["compiles"] += 1
            agg["ms"] += ms
            agg["loads"] += kind == "load"
        core.inc("compile.ledger.compiles")
        core.inc("compile.ledger.ms", ms)
        if changed:
            core.event("compile.ledger.retrace", program=name, ms=round(ms, 1),
                       changed=changed)

    # -- queries ------------------------------------------------------------

    def mark(self) -> int:
        """Current sequence number — pair with entries_since() to ask
        "what was built after this point" (the RetraceSentinel
        handshake)."""
        with self._lock:
            return self.seq

    def entries_since(self, seq: int, limit: int = 8) -> List[dict]:
        with self._lock:
            out = [dict(e) for e in self.entries if e["seq"] > seq]
        return out[-limit:]

    def snapshot(self, limit: int = 32) -> dict:
        with self._lock:
            tail = [dict(e) for e in list(self.entries)[-limit:]]
            progs = self._by_program.values()
            out = {
                "compiles": sum(v["compiles"] for v in progs),
                "total_ms": round(sum(v["ms"] for v in progs), 3),
                "by_program": {
                    k: _with_loads(
                        {"compiles": v["compiles"], "ms": round(v["ms"], 3)},
                        v["loads"])
                    for k, v in sorted(self._by_program.items())
                },
                "entries": tail,
            }
            return _with_loads(out, sum(v["loads"] for v in progs))

    def reset(self) -> None:
        with self._lock:
            self.entries.clear()
            self._last_sig.clear()
            self._by_program.clear()
            self.seq = 0


def _with_loads(d: dict, loads: int) -> dict:
    """`d` with its count of loads, when there are any (the JAX package's
    ledger has no loads: the keys stay its keys without them)."""
    if loads:
        d["loads"] = loads
    return d


LEDGER = CompileLedger(maxlen=knobs.get_int("YTK_PROF_LEDGER_N") or 512)


# ---------------------------------------------------------------------------
# Memory watermark sampler
# ---------------------------------------------------------------------------


def _cuda_ready() -> bool:
    """A CUDA context already exists in this process (never creates one)."""
    try:
        import torch

        return torch.cuda.is_available() and torch.cuda.is_initialized()
    except Exception:  # noqa: BLE001 — a broken runtime: host RSS only
        return False


def _device_mem_stats() -> Tuple[Optional[float], Optional[float]]:
    """(bytes in use, peak bytes since the last phase boundary) of the
    current CUDA device's caching allocator, or (None, None) without a
    CUDA context."""
    if not _cuda_ready():
        return None, None
    try:
        import torch

        return (float(torch.cuda.memory_allocated()),
                float(torch.cuda.max_memory_allocated()))
    except Exception:  # noqa: BLE001 — memory stats are best-effort
        return None, None


def _host_rss_bytes() -> Optional[float]:
    """Current RSS from /proc (linux); falls back to ru_maxrss (a peak,
    but monotone — still a usable watermark signal)."""
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) * 1024.0
    except Exception:  # noqa: BLE001 — /proc is linux-only
        pass
    try:
        import resource
        import sys

        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        return float(rss) * (1.0 if sys.platform == "darwin" else 1024.0)
    except Exception:  # noqa: BLE001 — no host watermark
        return None


class MemWatermarkSampler:
    """Background thread sampling device bytes-in-use + host RSS into
    bounded (wall_ts, value) rings, attributing running peaks to the
    enclosing profiler phase. Mirrors the heartbeat sampler lifecycle
    (daemon thread, Event stop, joined in stop())."""

    SERIES = ("mem.device_bytes_in_use", "mem.device_peak_bytes",
              "mem.host_rss_bytes")

    def __init__(self):
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._ring_n = 0
        self.rings: Dict[str, "collections.deque"] = {}
        #: phase -> {"device_peak_bytes": x, "host_rss_peak_bytes": y}
        self.phase_peaks: Dict[str, dict] = {}
        #: the largest CUDA peak any boundary or tick has seen: the
        #: process-wide peak the phase resets would otherwise hide
        self.peak_seen = 0.0

    def _attribute(self, ph: str, in_use, peak, rss) -> None:
        # under self._lock
        pk = self.phase_peaks.setdefault(ph, {})
        if peak is not None or in_use is not None:
            dv = peak if peak is not None else in_use
            self.peak_seen = max(self.peak_seen, dv)
            if dv > pk.get("device_peak_bytes", -1.0):
                pk["device_peak_bytes"] = dv
        if rss is not None and rss > pk.get("host_rss_peak_bytes", -1.0):
            pk["host_rss_peak_bytes"] = rss

    def sample_once(self, now: Optional[float] = None) -> None:
        """One tick (also the deterministic unit tests' entry point):
        read stats *outside* the lock, then append + attribute under it."""
        in_use, peak = _device_mem_stats()
        rss = _host_rss_bytes()
        ph = current_phase() or "<none>"
        ts = round(now if now is not None else time.time(), 3)
        with self._lock:
            if self._ring_n <= 0:
                return
            for name, val in (
                ("mem.device_bytes_in_use", in_use),
                ("mem.device_peak_bytes", peak),
                ("mem.host_rss_bytes", rss),
            ):
                if val is None:
                    continue
                ring = self.rings.get(name)
                if ring is None:
                    ring = self.rings[name] = collections.deque(
                        maxlen=self._ring_n
                    )
                ring.append((ts, val))
            self._attribute(ph, in_use, peak, rss)
        if in_use is not None:
            core.gauge("mem.sampled.device_bytes_in_use", in_use)
        if rss is not None:
            core.gauge("mem.sampled.host_rss_bytes", rss)

    def boundary(self) -> None:
        """A phase boundary: credit the CUDA peak since the last boundary
        to the current phase, then reset the peak, so each phase's peak is
        its own. No-op without a CUDA context."""
        if not _cuda_ready():
            return
        in_use, peak = _device_mem_stats()
        if peak is None:
            return
        with self._lock:
            self._attribute(current_phase() or "<none>", in_use, peak, None)
        try:
            import torch

            torch.cuda.reset_peak_memory_stats()
        except Exception:  # noqa: BLE001 — stats are best-effort
            pass

    @thread_guard
    def _run(self, stop: threading.Event, interval: float) -> None:
        while not stop.is_set():
            self.sample_once()
            stop.wait(interval)

    def start(self, interval: Optional[float] = None,
              ring_n: Optional[int] = None) -> bool:
        if interval is None:
            interval = _state.mem_interval
        if ring_n is None:
            ring_n = knobs.get_int("YTK_OBS_HISTORY_N") or 256
        if ring_n > 0:
            with self._lock:
                if self._ring_n != ring_n:
                    self.rings = {}
                    self._ring_n = int(ring_n)
        if interval <= 0 or ring_n <= 0:
            return False
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return False
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._run,
                args=(self._stop, float(interval)),
                name="ytk-prof-mem",
                daemon=True,
            )
            self._thread.start()
        return True

    def stop(self) -> None:
        with self._lock:
            t, ev = self._thread, self._stop
            self._thread = None
            self._stop = None
        if ev is not None:
            ev.set()
        if t is not None:
            t.join(timeout=2.0)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "ring_n": self._ring_n,
                "series": {
                    name: [[t, v] for t, v in ring]
                    for name, ring in sorted(self.rings.items())
                },
                "phase_peaks": {k: dict(v) for k, v in self.phase_peaks.items()},
            }

    def reset(self, ring_n: Optional[int] = None) -> None:
        with self._lock:
            self.rings = {}
            self.phase_peaks = {}
            if ring_n is not None:
                self._ring_n = int(ring_n)


MEM = MemWatermarkSampler()


# ---------------------------------------------------------------------------
# Trace-capture parser (the Chrome trace torch.profiler exports)
# ---------------------------------------------------------------------------


def _load_trace_doc(path: str) -> Optional[dict]:
    try:
        if path.endswith(".gz"):
            with gzip.open(path, "rt") as fh:
                return json.load(fh)
        with open(path) as fh:
            return json.load(fh)
    except Exception as e:  # noqa: BLE001 — partial captures are skipped
        log.debug("trace parse failed for %s: %s", path, e)
        return None


#: obs span names are lowercase dotted identifiers ("gbdt.train",
#: "serve.score"); torch's own annotations ("ProfilerStep#1", "## ... ##")
#: are not spans
_ANN_NAME = re.compile(r"^[a-z][a-z0-9_.\-]*$")
#: the device's own work in torch's chrome export
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _innermost(intervals, t: float):
    """The shortest (lo, hi, name, key) interval holding t (intervals
    sorted by length), or None."""
    for iv in intervals:
        if iv[0] <= t < iv[1]:
            return iv
    return None


def _top_level(events: List[dict]) -> List[dict]:
    """The events of `events` that no other event of the same thread
    contains (torch's cpu_ops nest: aten::add inside aten::add_ ...)."""
    out: List[dict] = []
    by_thread: Dict[Tuple[Any, Any], List[dict]] = {}
    for ev in events:
        by_thread.setdefault((ev.get("pid"), ev.get("tid")), []).append(ev)
    for evs in by_thread.values():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        end = None
        for ev in evs:
            if end is None or ev["ts"] >= end:
                out.append(ev)
                end = ev["ts"] + ev["dur"]
    return out


def _union_ms(events: List[dict]) -> float:
    """Length of the union of the events' [ts, ts + dur) in ms."""
    total, end = 0.0, None
    for lo, hi in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if end is None or lo > end:
            total += hi - lo
            end = hi
        elif hi > end:
            total += hi - end
            end = hi
    return total / 1000.0


def _intervals(anns: List[Tuple[Any, dict]]):
    """(kernel launches, spans): (lo, hi, name, key) sorted by length."""
    out: Tuple[list, list] = ([], [])
    for key, ev in anns:
        kernel = ev["name"].startswith(KERNEL_PREFIX)
        out[0 if kernel else 1].append(
            (ev["ts"], ev["ts"] + ev["dur"], ev["name"], key))
    for lst in out:
        lst.sort(key=lambda iv: iv[1] - iv[0])
    return out


def parse_trace_json(path: str) -> Optional[dict]:
    """Bucket one torch.profiler Chrome trace into per-span device time
    and a kernel aggregate.

    Layout (torch's chrome export; ts and dur in µs):
      * `user_annotation` events are the host side of record_function
        ranges: the obs spans (and `kernel.<name>` launches) on their
        threads; `gpu_user_annotation` events are the same ranges on the
        device's timeline, from the first to the last device event
        launched inside them;
      * on the card, `kernel`, `gpu_memcpy` and `gpu_memset` events are
        device time, each with the `correlation` id of the runtime call
        that launched it (`cuda_runtime`/`cuda_driver` events); on the CPU
        there are none, and the top-level `cpu_op` events stand in for
        kernels.

    A device event is placed by its launching call's time among the host
    annotations of that call's thread, else (no such call in the trace)
    by its midpoint among the device timeline's annotations; a cpu_op by
    its midpoint among its thread's annotations. Its time goes to the
    innermost span annotation there, and its row in the kernel table is
    the innermost `kernel.<name>` annotation's (one count a launch), else
    its own name (torch's kernels, copies, host ops).

    Returns {"annotations": {name: ms}, "span_device_ms": {name: ms},
    "kernels": {name: {"ms", "count"}}, "device": bool, "device_busy_ms",
    "window_ms"} or None if unreadable."""
    doc = _load_trace_doc(path)
    if doc is None:
        return None
    events = doc.get("traceEvents", doc if isinstance(doc, list) else [])
    host_ann: Dict[Tuple[Any, Any], List[Tuple[Any, dict]]] = {}
    dev_ann: List[Tuple[Any, dict]] = []
    dev_events: List[dict] = []
    cpu_ops: List[dict] = []
    launch_at: Dict[Any, Tuple[Tuple[Any, Any], float]] = {}
    annotations: Dict[str, float] = {}
    window = 0.0
    for i, ev in enumerate(events):
        if ev.get("ph") != "X" or "dur" not in ev or "ts" not in ev:
            continue
        cat = ev.get("cat", "")
        name = ev.get("name", "")
        thread = (ev.get("pid"), ev.get("tid"))
        if cat in _DEVICE_CATS:
            dev_events.append(ev)
        elif cat == "cpu_op":
            cpu_ops.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch_at[corr] = (thread, ev["ts"])
        elif cat == "user_annotation" and _ANN_NAME.match(name):
            host_ann.setdefault(thread, []).append((("h", i), ev))
            window = max(window, ev["dur"] / 1000.0)
            if not name.startswith(KERNEL_PREFIX):
                annotations[name] = annotations.get(name, 0.0) + ev["dur"] / 1000.0
        elif cat == "gpu_user_annotation" and _ANN_NAME.match(name):
            dev_ann.append((("d", i), ev))
    device = bool(dev_events)
    host_iv = {t: _intervals(a) for t, a in host_ann.items()}
    dev_iv = _intervals(dev_ann)
    none_iv: Tuple[list, list] = ([], [])
    work = dev_events if device else _top_level(cpu_ops)
    span_device: Dict[str, float] = {}
    kernels: Dict[str, dict] = {}
    seen_launch: set = set()
    for ev in work:
        ms = ev["dur"] / 1000.0
        t = ev["ts"] + ev["dur"] / 2.0
        corr = (ev.get("args") or {}).get("correlation") if device else None
        if corr is not None and corr in launch_at:
            thread, t = launch_at[corr]
            ivs = host_iv.get(thread, none_iv)
        elif device:
            ivs = dev_iv
        else:
            ivs = host_iv.get((ev.get("pid"), ev.get("tid")), none_iv)
        hit = _innermost(ivs[0], t)
        kname = hit[2][len(KERNEL_PREFIX):] if hit else ev.get("name", "?")
        k = kernels.setdefault(kname, {"ms": 0.0, "count": 0})
        k["ms"] += ms
        if hit is None or hit[3] not in seen_launch:
            k["count"] += 1
            if hit is not None:
                seen_launch.add(hit[3])
        sp = _innermost(ivs[1], t)
        if sp is not None:
            span_device[sp[2]] = span_device.get(sp[2], 0.0) + ms
    return {
        "annotations": {k: round(v, 3) for k, v in annotations.items()},
        "span_device_ms": {k: round(v, 3) for k, v in span_device.items()},
        "kernels": {
            k: {"ms": round(v["ms"], 3), "count": v["count"]}
            for k, v in kernels.items()
        },
        "device": device,
        "device_busy_ms": round(_union_ms(work), 3),
        "window_ms": round(window, 3),
    }


def parse_capture_dir(root: str) -> Optional[dict]:
    """Find + parse the newest `*.json(.gz)` Chrome trace under a capture
    dir."""
    newest, newest_m = None, -1.0
    for dirpath, _dirs, files in os.walk(root):
        for fn in files:
            if fn.endswith(".json") or fn.endswith(".json.gz"):
                p = os.path.join(dirpath, fn)
                m = os.path.getmtime(p)
                if m > newest_m:
                    newest, newest_m = p, m
    return parse_trace_json(newest) if newest else None


def parse_captures(topk: Optional[int] = None) -> dict:
    """Merge every completed phase capture into span device-time buckets
    and one top-k kernel table; `windows` keeps each capture's own
    window and device busy time (its busy share)."""
    if topk is None:
        topk = _state.topk
    with _acc_lock:
        captures = list(_captures)
    span_device: Dict[str, float] = {}
    kernels: Dict[str, dict] = {}
    windows: List[dict] = []
    parsed = 0
    for phase_name, cap_dir in captures:
        res = parse_capture_dir(cap_dir)
        if res is None:
            continue
        parsed += 1
        windows.append({"phase": phase_name, "device": res["device"],
                        "window_ms": res["window_ms"],
                        "device_busy_ms": res["device_busy_ms"]})
        for k, v in res["span_device_ms"].items():
            span_device[k] = round(span_device.get(k, 0.0) + v, 3)
        for k, v in res["kernels"].items():
            agg = kernels.setdefault(k, {"ms": 0.0, "count": 0})
            agg["ms"] = round(agg["ms"] + v["ms"], 3)
            agg["count"] += v["count"]
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["ms"])[: max(0, topk)]
    total_ms = sum(v["ms"] for v in kernels.values())
    return {
        "captures": len(captures),
        "parsed": parsed,
        "span_device_ms": span_device,
        "device_total_ms": round(total_ms, 3),
        "top_kernels": [
            {
                "name": k,
                "ms": v["ms"],
                "count": v["count"],
                "share": round(v["ms"] / total_ms, 4) if total_ms else 0.0,
            }
            for k, v in top
        ],
        "windows": windows,
    }


# ---------------------------------------------------------------------------
# Report / flight-dump surface
# ---------------------------------------------------------------------------


def report(wall_s: Optional[float] = None, topk: Optional[int] = None) -> dict:
    """The `ytkprof` schema: everything the plane knows, JSON-ready."""
    rep = {
        "schema": SCHEMA,
        "schema_version": 1,
        "enabled": _state.on,
        "phases": phases_snapshot(),
        "compile": LEDGER.snapshot(),
        "mem": MEM.snapshot(),
        "kernels": parse_captures(topk=topk),
    }
    if wall_s is not None:
        rep["wall_s"] = round(wall_s, 4)
        rep["phase_coverage"] = round(coverage(wall_s), 4)
    return rep


def format_report(rep: dict) -> str:
    """Render a ytkprof report for terminals (prof_drill and chip_smoke.py
    share this — one timing presentation, one plane)."""
    lines: List[str] = []
    phases = rep.get("phases") or {}
    if phases:
        lines.append("phase                          wall_s   calls")
        for name, p in phases.items():
            pad = "  " * p.get("depth", 0)
            lines.append(
                "%-30s %7.3f  %6d" % (pad + name, p["wall_s"], p["count"])
            )
    if rep.get("wall_s") is not None:
        lines.append(
            "wall %.3fs  coverage %.1f%%"
            % (rep["wall_s"], 100.0 * rep.get("phase_coverage", 0.0))
        )
    comp = rep.get("compile") or {}
    if comp.get("compiles"):
        lines.append(
            "compiles %d (loads %d)  total %.1f ms"
            % (comp["compiles"], comp.get("loads", 0),
               comp.get("total_ms", 0.0))
        )
        for name, v in (comp.get("by_program") or {}).items():
            lines.append(
                "  %-28s %3d compile(s)  %8.1f ms  (%d load(s))"
                % (name, v["compiles"], v["ms"], v.get("loads", 0))
            )
        for e in comp.get("entries") or []:
            lines.append(
                "    %-11s %-34s %8.1f ms  %s"
                % (e.get("kind", "build"), (e.get("kernel") or "")[:34],
                   e["ms"], e["program"])
            )
    kern = rep.get("kernels") or {}
    if kern.get("top_kernels"):
        lines.append(
            "top kernels (device total %.1f ms over %d capture(s)):"
            % (kern.get("device_total_ms", 0.0), kern.get("parsed", 0))
        )
        for k in kern["top_kernels"]:
            lines.append(
                "  %-40s %8.2f ms  x%-5d %5.1f%%"
                % (k["name"][:40], k["ms"], k["count"], 100.0 * k["share"])
            )
    for w in kern.get("windows") or []:
        if w.get("window_ms"):
            lines.append(
                "capture %s: %s busy %.1f of %.1f ms (%.1f%%)"
                % (w["phase"], "device" if w.get("device") else "host ops",
                   w["device_busy_ms"], w["window_ms"],
                   100.0 * w["device_busy_ms"] / w["window_ms"])
            )
    peaks = (rep.get("mem") or {}).get("phase_peaks") or {}
    if peaks:
        lines.append("memory peaks by phase:")
        for ph, v in peaks.items():
            bits = []
            if "device_peak_bytes" in v:
                bits.append("device %.1f MiB" % (v["device_peak_bytes"] / 2**20))
            if "host_rss_peak_bytes" in v:
                bits.append("rss %.1f MiB" % (v["host_rss_peak_bytes"] / 2**20))
            lines.append("  %-28s %s" % (ph, "  ".join(bits)))
    return "\n".join(lines)


def flight_block() -> Optional[dict]:
    """Compact prof block for flight dumps (phase wall table, ledger
    tail, phase-attributed memory peaks) — None when the plane is off so
    dumps stay byte-identical for non-profiled runs."""
    if not _state.on:
        return None
    mem = MEM.snapshot()
    return {
        "phases": phases_snapshot(),
        "compile": LEDGER.snapshot(limit=16),
        "mem_phase_peaks": mem.get("phase_peaks", {}),
    }


# ---------------------------------------------------------------------------
# Configuration
# ---------------------------------------------------------------------------


def _activate() -> None:
    """Arm everything the plane rides on: obs collection (spans), the
    spans' record_function annotations (so captures carry span names),
    the health build counters, and the watermark sampler."""
    from . import health

    core.configure(enabled=True, torch_annotations=True)
    health.install_trace_counters()
    MEM.start()


def configure_profiler(
    on: Optional[bool] = None,
    capture_dir=_UNSET,
    topk: Optional[int] = None,
    mem_interval: Optional[float] = None,
) -> None:
    """Runtime configuration (the CLI's --profile lands here). Setting a
    capture dir implies on=True unless `on=False` is passed explicitly.
    Turning the plane off stops the sampler and the spans' annotations."""
    if capture_dir is not _UNSET:
        _state.capture_dir = capture_dir or None
        if capture_dir and on is None:
            on = True
    if topk is not None:
        _state.topk = int(topk)
    if mem_interval is not None:
        _state.mem_interval = float(mem_interval)
    if on is not None:
        was = _state.on
        _state.on = bool(on)
        if _state.on and not was:
            _activate()
        elif was and not _state.on:
            MEM.stop()
            core.configure(torch_annotations=False)


def reset_profiler() -> None:
    """Clear accumulated state (tests; the sampler thread keeps running
    if armed — stop it via configure_profiler(on=False))."""
    with _acc_lock:
        _phases.clear()
        del _captures[:]
        del _phase_stack[:]
    LEDGER.reset()
    MEM.reset()


def _configure_from_env() -> None:
    raw = knobs.get_raw("YTK_PROF")
    topk = knobs.get_int("YTK_PROF_TOPK")
    mem_s = knobs.get_float("YTK_PROF_MEM_S")
    if topk is not None:
        _state.topk = topk
    if mem_s is not None:
        _state.mem_interval = mem_s
    if raw is None or raw == "" or raw == "0":
        return
    if raw == "1":
        configure_profiler(on=True)
    else:
        configure_profiler(on=True, capture_dir=raw)


_configure_from_env()
