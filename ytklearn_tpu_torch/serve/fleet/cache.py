"""Bounded LRU prediction cache (Clipper; the JAX package's
``serve/fleet/cache.py``).

Online traffic is heavy-tailed: a small set of hot feature rows (the
popular item, the returning user) accounts for a large share of requests.
Clipper (NSDI'17 §4.1) puts a prediction cache in front of the batching
queue so those rows cost a dict lookup instead of a scorer pass. Rules:

  key        (model fingerprint + version, exact feature-row tuple) — the
             row itself is the key, not a hash of it, so a collision can
             never serve another row's prediction
  values     the (score, prediction) the SCORED path produced, stored
             per row — a hit is bit-identical to a cold request by
             construction
  bound      `YTK_SERVE_CACHE_ROWS` rows, LRU eviction
             (`serve.cache.evict` counts)
  invalidation  free: the fingerprint/version in the key changes when the
             registry hot-swaps an entry, so every stale row simply stops
             matching and ages out of the LRU — no flush, no lock sweep,
             no coordination with the reload path
  writes     only from scored batches, keyed by the entry that ACTUALLY
             scored them (the batch meta), never by the entry that was
             current at submit time — a hot reload between submit and
             score must not poison the cache with mislabeled rows

Counters: `serve.cache.hit` / `serve.cache.miss` / `serve.cache.evict`
(+ `serve.cache.rows` gauge) land in `/metrics`.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ...config import knobs
from ...obs import gauge as obs_gauge, inc as obs_inc


def row_key(row: Dict[str, float]) -> tuple:
    """A feature-dict row as a canonical hashable key (sorted items —
    insertion order must not split identical rows into distinct keys)."""
    return tuple(sorted(row.items()))


class PredictionCache:
    """LRU of (model key, row key) -> (score, prediction) scalars/rows."""

    def __init__(self, max_rows: Optional[int] = None):
        if max_rows is None:
            max_rows = knobs.get_int("YTK_SERVE_CACHE_ROWS")
        self.max_rows = max(0, int(max_rows))
        self._lru: OrderedDict = OrderedDict()
        # mesh-obs per-model occupancy: which family scope stored each
        # key (maintained with _lru under the same lock), and the live
        # row count per scope — `/metrics?models=1` reports who actually
        # owns the shared cache budget
        self._key_scope: dict = {}
        self._scope_rows: Dict[str, int] = {}
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return self.max_rows > 0

    @staticmethod
    def model_key(entry) -> tuple:
        """The invalidation half of the cache key: fingerprint + version
        of a registry entry. A hot reload (new fingerprint, bumped
        version) or a rollback (older version) changes it, so stale rows
        never match again."""
        return (entry.fingerprint, entry.version)

    def lookup(
        self, model_key: tuple, rows: Sequence[Dict[str, float]],
        scope: Optional[str] = None,
    ) -> Optional[list]:
        """All-or-nothing: the per-row (score, pred) list when EVERY row
        hits, else None (partial hits still ride the scored path, so a
        response is always one model version end to end). Both counters
        are in ROWS — hit rows bypassed the scorer, miss rows rode the
        scored path — so hit/(hit+miss) is a true row hit rate even for
        multi-row requests. `scope` (a mesh-obs family name) mirrors each
        counter per model at the same site as its global twin."""
        if not self.enabled:
            return None
        out = []
        with self._lock:
            for row in rows:
                k = (model_key, row_key(row))
                hit = self._lru.get(k)
                if hit is None:
                    obs_inc("serve.cache.miss", len(rows))
                    if scope is not None:
                        obs_inc(
                            f"serve.model.{scope}.cache.miss", len(rows)
                        )
                    return None
                self._lru.move_to_end(k)
                out.append(hit)
        obs_inc("serve.cache.hit", len(rows))
        if scope is not None:
            obs_inc(f"serve.model.{scope}.cache.hit", len(rows))
        return out

    def store(
        self, model_key: tuple, rows: Sequence[Dict[str, float]], scores,
        preds, scope: Optional[str] = None,
    ) -> None:
        """Insert scored rows (score_i, pred_i from the batch arrays).
        `scope` attributes the stored rows to a mesh-obs family for the
        per-model occupancy view; eviction re-credits the evicted key's
        own scope, not the storer's."""
        if not self.enabled:
            return
        with self._lock:
            for i, row in enumerate(rows):
                k = (model_key, row_key(row))
                s, p = scores[i], preds[i]
                # multi-output models: scores[i] on a (B, K) array is a
                # VIEW whose .base pins the whole batch array — a
                # "bounded" cache of views can hold gigabytes. Scalars
                # (1-D indexing) are already copies.
                if isinstance(s, np.ndarray):
                    s = np.array(s, copy=True)
                if isinstance(p, np.ndarray):
                    p = np.array(p, copy=True)
                fresh = k not in self._lru
                self._lru[k] = (s, p)
                self._lru.move_to_end(k)  # re-stored keys keep recency
                if scope is not None:
                    old = self._key_scope.get(k)
                    if fresh or old != scope:
                        if old is not None and not fresh:
                            self._scope_rows[old] = (
                                self._scope_rows.get(old, 1) - 1
                            )
                        self._key_scope[k] = scope
                        self._scope_rows[scope] = (
                            self._scope_rows.get(scope, 0) + 1
                        )
            evicted = 0
            while len(self._lru) > self.max_rows:
                k, _ = self._lru.popitem(last=False)
                old = self._key_scope.pop(k, None)
                if old is not None:
                    left = self._scope_rows.get(old, 1) - 1
                    if left > 0:
                        self._scope_rows[old] = left
                    else:
                        self._scope_rows.pop(old, None)
                evicted += 1
            n = len(self._lru)
        if evicted:
            obs_inc("serve.cache.evict", evicted)
        obs_gauge("serve.cache.rows", n)

    def scope_rows(self) -> Dict[str, int]:
        """Live cached-row count per mesh-obs family scope (rows stored
        without a scope are not attributed)."""
        with self._lock:
            return {s: n for s, n in sorted(self._scope_rows.items()) if n > 0}

    def __len__(self) -> int:
        with self._lock:
            return len(self._lru)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._key_scope.clear()
            self._scope_rows.clear()
        obs_gauge("serve.cache.rows", 0)


def maybe_cache(max_rows: Optional[int] = None) -> Optional[PredictionCache]:
    """A PredictionCache when the rows knob (or explicit arg) is > 0."""
    cache = PredictionCache(max_rows)
    return cache if cache.enabled else None
