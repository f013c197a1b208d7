"""Online GBDT serving: compiled scorer, micro-batcher, registry, HTTP app."""

from .batcher import (
    BatchPolicy,
    DeadlineExceeded,
    MicroBatcher,
    OverloadError,
    ServeClosed,
)
from .registry import ModelRegistry
from .scorer import DEFAULT_LADDER, CompiledScorer, parse_ladder, resolve_mode
from .server import ServeApp

__all__ = [
    "BatchPolicy",
    "CompiledScorer",
    "DEFAULT_LADDER",
    "DeadlineExceeded",
    "MicroBatcher",
    "ModelRegistry",
    "OverloadError",
    "ServeApp",
    "ServeClosed",
    "parse_ladder",
    "resolve_mode",
]
