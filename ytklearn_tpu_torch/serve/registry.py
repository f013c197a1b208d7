"""Multi-model registry with fingerprint-watch hot reload (the JAX
package's ``serve/registry.py``).

A trainer can dump a new model text over the served path and the registry
picks it up without dropping traffic:

  1. a watcher thread polls the model files' fingerprint (size+mtime of
     every file under model.data_path and its sidecars) every
     YTK_SERVE_WATCH_S seconds (default 5; 0 disables),
  2. on change it builds a NEW predictor + CompiledScorer on the
     registry's device and warms the whole shape ladder off to the side
     (the watcher thread launches the kernels of every rung on its own
     current CUDA stream) — traffic keeps hitting the old scorer, whose
     tables the new build never touches,
  3. then swaps the entry reference atomically (one dict assignment under
     the registry lock) and records a `serve.reload` obs event.

A request therefore always sees exactly one model version: whichever entry
reference its batch resolved. Trainer dumps are atomic (write tmp +
os.replace, io/fs.py atomic_open) so the watcher can never observe a
half-written file; in-flight `*.tmp-*` names are excluded from the
fingerprint, and a multi-file dump caught mid-promotion is caught at the
set level too — the fingerprint is re-taken after the warm load and a
mismatch defers the swap (`serve.reload_deferred`) until the file set
settles. A dump that fails to parse keeps the old entry serving and
fires `serve.reload_failed`.

A promotion over the served path is picked up like any other dump.
`pin(name)` freezes a model
at its current in-memory version (the watcher skips it);
`rollback(name)` swaps back to the previously served entry and pins, so
a bad promotion is undone in one call without touching disk.
"""

from __future__ import annotations

import hashlib
import logging
import os
import threading
import time
from typing import Dict, Optional

from ..config import knobs
from ..device import resolve_device
from ..io.fs import is_tmp_path
from ..obs import event as obs_event, gauge as obs_gauge, inc as obs_inc
from ..obs.recorder import thread_guard
from ..predict import create_predictor
from ..resilience import chaos_point, retry_call
from .scorer import CompiledScorer

log = logging.getLogger(__name__)


class NoPreviousVersion(KeyError):
    """rollback() on a loaded model that has never been reloaded: the
    model exists but there is no previous entry to return to — a state
    error (HTTP 409), not an unknown name (404)."""


def _sidecar_paths(predictor) -> list:
    """Every file the loaded model was parsed from (data_path tree +
    transform-stat / field-dict / tree-info sidecars where configured),
    plus the continual trainer's version sidecar so a re-promotion with
    identical weights still fingerprints as a change."""
    p = predictor.params
    paths = [
        p.model.data_path,
        p.model.data_path + ".version.json",
        # bin-edge sidecar for serve-side binned scoring: an edges-only
        # change must re-lower the scorer too (gbdt/binning.py)
        p.model.data_path + ".bins.json",
        # model-quality sketch sidecar (obs/quality.py): a fresh drift
        # baseline must reload with the model it was trained with
        p.model.data_path + ".sketch.json",
    ]
    feature = getattr(p, "feature", None)
    if feature is not None and feature.transform.switch_on:
        paths.append(p.model.data_path + "_feature_transform_stat")
    field_dict = getattr(p.model, "field_dict_path", "")
    if field_dict:
        paths.append(field_dict)
    return paths


def model_fingerprint(predictor) -> str:
    """Stable digest of (path, size, mtime_ns) for every model file; ""
    when nothing exists (then any appearance is a change)."""
    h = hashlib.sha1()
    found = False
    for root in _sidecar_paths(predictor):
        try:
            files = predictor.fs.recur_get_paths([root])
        except FileNotFoundError:
            continue
        for f in sorted(files):
            if is_tmp_path(f):
                continue  # in-flight atomic write; settles by next poll
            try:
                st = os.stat(f)
                h.update(f"{f}:{st.st_size}:{st.st_mtime_ns};".encode())
            except OSError:
                # remote fs: fall back to the path list itself
                h.update(f"{f};".encode())
            found = True
    return h.hexdigest() if found else ""


class _Entry:
    __slots__ = ("name", "model_name", "config", "predictor", "scorer",
                 "fingerprint", "version", "loaded_at")

    def __init__(self, name, model_name, config, predictor, scorer,
                 fingerprint, version):
        self.name = name
        self.model_name = model_name
        self.config = config
        self.predictor = predictor
        self.scorer = scorer
        self.fingerprint = fingerprint
        self.version = version
        self.loaded_at = time.time()


class ModelRegistry:
    """name -> warmed (predictor, scorer) entries; atomic hot swap."""

    def __init__(self, ladder=None, watch_interval_s: Optional[float] = None,
                 device=None):
        self.ladder = ladder
        self.device = resolve_device(device)
        if watch_interval_s is None:
            watch_interval_s = knobs.get_float("YTK_SERVE_WATCH_S")
        self.watch_interval_s = watch_interval_s
        self._entries: Dict[str, _Entry] = {}
        self._prev: Dict[str, _Entry] = {}  # last swapped-out entry per name
        self._pinned: set = set()  # names the watcher must not reload
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._watcher: Optional[threading.Thread] = None

    # -- loading ----------------------------------------------------------

    def load(self, name: str, model_name: str, config) -> _Entry:
        """Load + warm a model under `name`; replaces any existing entry
        (warm-before-swap, same as a reload)."""
        entry = self._build(name, model_name, config, version=1)
        with self._lock:
            prev = self._entries.get(name)
            if prev is not None:
                entry.version = prev.version + 1
                self._prev[name] = prev  # rollback target
            self._entries[name] = entry
        obs_gauge("serve.models", len(self._entries))
        log.info(
            "serve: loaded model %r (%s) v%d, ladder=%s, rung=%s",
            name, model_name, entry.version, entry.scorer.ladder,
            entry.scorer.rung_info(),
        )
        return entry

    def _build(self, name, model_name, config, version) -> _Entry:
        # `serve.load` retry/chaos site: a transient read fault off the
        # model store used to strand the reload until the next poll tick
        # (or fail the initial load outright) — now it costs a backoff.
        # Fatal faults (parse errors, missing files) still propagate to
        # maybe_reload's keep-serving handler on the first throw.
        def _once():
            chaos_point("serve.load")
            predictor = create_predictor(model_name, config)
            scorer = CompiledScorer(predictor, ladder=self.ladder,
                                    warmup=True, device=self.device)
            return predictor, scorer

        predictor, scorer = retry_call(_once, site="serve.load")
        return _Entry(
            name, model_name, config, predictor, scorer,
            model_fingerprint(predictor), version,
        )

    def get(self, name: str) -> _Entry:
        with self._lock:
            entry = self._entries.get(name)
        if entry is None:
            raise KeyError(f"no model named {name!r} is loaded")
        return entry

    def names(self) -> list:
        with self._lock:
            return sorted(self._entries)

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    # -- version pinning / rollback ---------------------------------------

    def pinned(self, name: str) -> bool:
        with self._lock:
            return name in self._pinned

    def pin(self, name: str) -> None:
        """Freeze `name` at its current in-memory version: the watcher (and
        explicit maybe_reload calls) skip it until unpin()."""
        self.get(name)  # KeyError for unknown names
        with self._lock:
            self._pinned.add(name)
        obs_event("serve.pin", model=name)
        log.info("serve: pinned %r (hot reload disabled)", name)

    def unpin(self, name: str) -> None:
        self.get(name)  # KeyError for unknown names (a typo must not 200)
        with self._lock:
            self._pinned.discard(name)
        obs_event("serve.unpin", model=name)
        log.info("serve: unpinned %r (hot reload re-enabled)", name)

    def rollback(self, name: str) -> _Entry:
        """Swap `name` back to the previously served entry (the one the
        last load/reload replaced) and PIN it, so the watcher doesn't
        immediately re-promote the bad on-disk model. The undo button for
        a bad continual promotion; raises KeyError for an unknown name
        and NoPreviousVersion for a known model with nothing to return
        to (the server maps them to 404 vs 409)."""
        with self._lock:
            entry = self._entries.get(name)
            prev = self._prev.get(name)
            if entry is None:
                raise KeyError(f"no model named {name!r} is loaded")
            if prev is None:
                raise NoPreviousVersion(
                    f"model {name!r} has no previous version to roll back to"
                )
            self._entries[name] = prev
            self._prev[name] = entry  # rollback is itself undoable
            self._pinned.add(name)
        obs_inc("serve.rollback")
        obs_event(
            "serve.rollback", model=name,
            from_version=entry.version, to_version=prev.version,
        )
        log.warning(
            "serve: rolled back %r v%d -> v%d and pinned (unpin to resume "
            "hot reload)", name, entry.version, prev.version,
        )
        return prev

    # -- hot reload -------------------------------------------------------

    def maybe_reload(self, name: str) -> bool:
        """Reload `name` if its files changed. Warm first, swap after —
        traffic never sees a cold or half-swapped scorer. True = swapped.
        Pinned names never reload (version-pinning hook)."""
        entry = self.get(name)
        if self.pinned(name):
            return False
        fp = model_fingerprint(entry.predictor)
        if fp == entry.fingerprint:
            return False
        t0 = time.perf_counter()
        try:
            fresh = self._build(
                name, entry.model_name, entry.config, entry.version + 1
            )
            # stamp the PRE-read fingerprint, not a post-read one: if the
            # dump was still being written while _build parsed it, the
            # settled files fingerprint differently than `fp` and the next
            # poll reloads again — a post-read stamp would freeze a torn
            # model in place forever
            fresh.fingerprint = fp
        except Exception as e:  # noqa: BLE001 — keep serving the old model
            obs_inc("serve.reload_failed")
            obs_event("serve.reload_failed", model=name, error=type(e).__name__)
            log.warning("serve: reload of %r failed, keeping v%d: %s",
                        name, entry.version, e)
            return False
        if model_fingerprint(fresh.predictor) != fp:
            # the file SET changed while _build was parsing it (a multi-file
            # promotion caught mid-move): individual files are whole (atomic
            # replaces) but the loaded predictor may blend versions — don't
            # serve it; the next poll reloads once the set settles
            obs_inc("serve.reload_deferred")
            log.info(
                "serve: reload of %r deferred — model files changed during "
                "the warm load; keeping v%d until the set settles",
                name, entry.version,
            )
            return False
        with self._lock:
            if name in self._pinned:
                # pinned (or rolled back, which pins) DURING the warm load:
                # the operator's freeze wins over the in-flight build
                obs_inc("serve.reload_deferred")
                log.info(
                    "serve: reload of %r discarded — pinned during the "
                    "warm load; keeping v%d",
                    name, self._entries[name].version,
                )
                return False
            self._prev[name] = self._entries[name]  # rollback target
            self._entries[name] = fresh  # the atomic swap
        obs_inc("serve.reload")
        obs_event(
            "serve.reload",
            model=name,
            version=fresh.version,
            warm_ms=round((time.perf_counter() - t0) * 1e3, 1),
        )
        log.info("serve: hot-reloaded %r -> v%d (warmed in %.0f ms)",
                 name, fresh.version, (time.perf_counter() - t0) * 1e3)
        return True

    def start_watching(self) -> None:
        """Poll fingerprints every watch_interval_s (0/negative disables)."""
        if self.watch_interval_s <= 0 or self._watcher is not None:
            return
        self._watcher = threading.Thread(
            target=self._watch_loop, name="ytk-serve-watch", daemon=True
        )
        self._watcher.start()

    @thread_guard
    def _watch_loop(self) -> None:
        while not self._stop.wait(self.watch_interval_s):
            for name in self.names():
                try:
                    self.maybe_reload(name)
                except Exception:  # noqa: BLE001 — the watcher must survive
                    log.exception("serve: watch reload of %r crashed", name)

    def close(self) -> None:
        """Stop the watcher, then drop every entry, releasing the scorers'
        device tensors."""
        self._stop.set()
        if self._watcher is not None:
            self._watcher.join(timeout=5.0)
            self._watcher = None
        with self._lock:
            self._entries.clear()
            self._prev.clear()
