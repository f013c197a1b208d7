"""Online serving: batch scorer, micro-batcher with AIMD batch sizing,
registry with hot reload, pin and rollback, prediction cache, HTTP app,
and the multi-process fleet (the JAX package's ``serve/``).

  fleet/   FleetFront spawns N replica workers (one full `cli serve`
           stack each, on its own `--device`), balances on
           least-queued-rows, heals crashes, fans out admin, autoscales
           within a band and aggregates fleet metrics (ring-union p99,
           merged drift sketches)

CLI: `python -m ytklearn_tpu_torch.cli serve <conf> <model_name>
[--replicas N] [--device cpu]` (cli.py).
"""

from .batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ScoredRateWindow,
    ServeClosed,
    retry_after_s,
)
from .fleet import (
    AIMDController,
    AutoscalePolicy,
    FleetAutoscaler,
    FleetFront,
    PredictionCache,
    default_replica_count,
    maybe_cache,
    maybe_controller,
    serve_worker_argv,
)
from .registry import ModelRegistry, NoPreviousVersion, model_fingerprint
from .scorer import DEFAULT_LADDER, CompiledScorer, parse_ladder, resolve_mode
from .server import ServeApp

__all__ = [
    "AIMDController",
    "AutoscalePolicy",
    "BatchPolicy",
    "CompiledScorer",
    "DEFAULT_LADDER",
    "DeadlineExceeded",
    "FleetAutoscaler",
    "FleetFront",
    "MicroBatcher",
    "ModelRegistry",
    "NoPreviousVersion",
    "OverloadError",
    "PredictionCache",
    "ScoredRateWindow",
    "ServeApp",
    "ServeClosed",
    "default_replica_count",
    "maybe_cache",
    "maybe_controller",
    "model_fingerprint",
    "parse_ladder",
    "resolve_mode",
    "retry_after_s",
    "serve_worker_argv",
]
