"""ytklearn_tpu_torch.serve.fleet — the multi-process serving fleet (the JAX
package's ``serve/fleet/``).

The single-process server is one process: one GIL, one CUDA context, one
latency ring. This package turns it into a fleet, with the two Clipper
layers a single server runs (AIMD adaptive batching, bounded prediction
cache):

  FleetFront        shared-nothing front process: spawns N replica
                    workers (each the port's `cli serve` in its own
                    process, on its own `--device`), balances on
                    least-queued-rows, coalesces client requests into
                    per-replica batched forwards, reroutes around and
                    restarts crashed/wedged replicas, fans /admin/* out
                    fleet-wide, and aggregates /metrics with a replica
                    latency-ring union (fleet p99 is real) and the
                    replicas' merged drift sketches
  AIMDController    searches the largest batch size meeting the p99 SLO
                    (additive increase / multiplicative backoff), always
                    snapped to the scorer's shape ladder
  PredictionCache   bounded LRU keyed on (model fingerprint, feature
                    row); hits bypass the batcher queue and are
                    bit-identical to the scored path; hot reload
                    invalidates by key
  AutoscalePolicy / FleetAutoscaler
                    load-driven replica-count elasticity: a control
                    thread watches windowed load signals (backlog, shed
                    rate, p99 vs SLO, slo-burn) and grows or reaps slots
                    within `--replicas-min/--replicas-max` with
                    hysteresis + per-direction cooldowns; scale-down is
                    drain-based (fence, complete/reroute, SIGTERM)

CLI: `python -m ytklearn_tpu_torch.cli serve <conf> <model> --replicas N
      [--replicas-min A --replicas-max B] [--device cpu]` (cli.py).
"""

from __future__ import annotations

from .aimd import AIMDController, maybe_controller  # noqa: F401
from .autoscaler import (  # noqa: F401
    AutoscalePolicy,
    FleetAutoscaler,
    ScaleSignals,
    maybe_autoscaler,
)
from .cache import PredictionCache, maybe_cache, row_key  # noqa: F401
from .front import (  # noqa: F401
    FleetFront,
    extract_raw_rows,
    latency_percentiles,
    merge_model_metrics,
    window_ring_ms,
)
from .worker import (  # noqa: F401
    ReplicaHandle,
    WorkerStartupError,
    default_replica_count,
    http_json,
    serve_worker_argv,
    spawn_replica,
    stop_replica,
)

__all__ = [
    "AIMDController",
    "AutoscalePolicy",
    "FleetAutoscaler",
    "FleetFront",
    "PredictionCache",
    "ReplicaHandle",
    "ScaleSignals",
    "WorkerStartupError",
    "default_replica_count",
    "extract_raw_rows",
    "http_json",
    "latency_percentiles",
    "maybe_autoscaler",
    "maybe_cache",
    "maybe_controller",
    "merge_model_metrics",
    "row_key",
    "serve_worker_argv",
    "spawn_replica",
    "stop_replica",
    "window_ring_ms",
]
