"""Multi-model registry: name -> warmed (predictor, scorer) entries.

load() builds the predictor and its CompiledScorer, warms every ladder rung
on the registry's device (the rung follows the YTK_SERVE_* knobs), then
swaps the entry in under the lock (a second load of a name bumps its
version). Fingerprint-watch hot reload, pin and rollback come with the
rest of serving (ROADMAP.md).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict

from ..device import resolve_device
from ..predict import create_predictor
from .scorer import CompiledScorer

log = logging.getLogger(__name__)


class _Entry:
    __slots__ = ("name", "predictor", "scorer", "version")

    def __init__(self, name, predictor, scorer, version):
        self.name = name
        self.predictor = predictor
        self.scorer = scorer
        self.version = version


class ModelRegistry:
    """name -> warmed (predictor, scorer) entries; atomic swap on load."""

    def __init__(self, ladder=None, device=None):
        self.ladder = ladder
        self.device = resolve_device(device)
        self._entries: Dict[str, _Entry] = {}
        self._lock = threading.Lock()

    def load(self, name: str, model_name: str, config) -> _Entry:
        """Load + warm a model under `name`; replaces any existing entry
        (warm before the swap)."""
        predictor = create_predictor(model_name, config)
        scorer = CompiledScorer(
            predictor, ladder=self.ladder, warmup=True, device=self.device
        )
        entry = _Entry(name, predictor, scorer, version=1)
        with self._lock:
            prev = self._entries.get(name)
            if prev is not None:
                entry.version = prev.version + 1
            self._entries[name] = entry
        log.info(
            "serve: loaded model %r (%s) v%d, ladder=%s, rung=%s",
            name, model_name, entry.version, scorer.ladder, scorer.rung_info(),
        )
        return entry

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

    def close(self) -> None:
        """Drop every entry, releasing the scorers' device tensors."""
        with self._lock:
            self._entries.clear()
