"""ytklearn_tpu_torch.serve.fleet — the serving layers of the JAX package's
``serve/fleet/`` that a single serving process runs:

  AIMDController    searches the largest batch size meeting the p99 SLO
                    (additive increase / multiplicative backoff), always
                    snapped to the scorer's shape ladder
  PredictionCache   bounded LRU keyed on (model fingerprint, feature
                    row); hits bypass the batcher queue and are
                    bit-identical to the scored path; hot reload
                    invalidates by key
  latency_percentiles / window_ring_ms
                    the latency-ring helpers of the fleet front

The multi-process fleet (front, replica workers, autoscaler, `cli serve
--replicas*`) is not ported yet (ROADMAP.md 1.6).
"""

from __future__ import annotations

from .aimd import AIMDController, maybe_controller  # noqa: F401
from .cache import PredictionCache, maybe_cache, row_key  # noqa: F401
from .front import latency_percentiles, window_ring_ms  # noqa: F401

__all__ = [
    "AIMDController",
    "PredictionCache",
    "latency_percentiles",
    "maybe_cache",
    "maybe_controller",
    "row_key",
    "window_ring_ms",
]
