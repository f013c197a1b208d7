"""Online serving: batch scorer, micro-batcher with AIMD batch sizing,
registry with hot reload, pin and rollback, prediction cache, HTTP app
(the JAX package's ``serve/`` without the multi-process fleet)."""

from .batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ScoredRateWindow,
    ServeClosed,
    retry_after_s,
)
from .fleet import AIMDController, PredictionCache, maybe_cache, maybe_controller
from .registry import ModelRegistry, NoPreviousVersion, model_fingerprint
from .scorer import DEFAULT_LADDER, CompiledScorer, parse_ladder, resolve_mode
from .server import ServeApp

__all__ = [
    "AIMDController",
    "BatchPolicy",
    "CompiledScorer",
    "DEFAULT_LADDER",
    "DeadlineExceeded",
    "MicroBatcher",
    "ModelRegistry",
    "NoPreviousVersion",
    "OverloadError",
    "PredictionCache",
    "ScoredRateWindow",
    "ServeApp",
    "ServeClosed",
    "maybe_cache",
    "maybe_controller",
    "model_fingerprint",
    "parse_ladder",
    "resolve_mode",
    "retry_after_s",
]
