"""Predictor side-stack (reference: predictor/OnlinePredictorFactory.java:32-80).

`create_predictor(model_name, config)` serves every family `cli train`
writes: the convex ones, the four GBST variants and "gbdt".
"""

from __future__ import annotations

from .base import OnlinePredictor, numpy_activation
from .continuous import (
    ContinuousPredictor,
    FFMPredictor,
    FMPredictor,
    LinearPredictor,
    MulticlassLinearPredictor,
)
from .trees import GBDTPredictor, GBSTPredictor

__all__ = [
    "OnlinePredictor",
    "ContinuousPredictor",
    "LinearPredictor",
    "MulticlassLinearPredictor",
    "FMPredictor",
    "FFMPredictor",
    "GBDTPredictor",
    "GBSTPredictor",
    "create_predictor",
    "numpy_activation",
]

_PREDICTORS = {
    "linear": LinearPredictor,
    "multiclass_linear": MulticlassLinearPredictor,
    "fm": FMPredictor,
    "ffm": FFMPredictor,
    "gbdt": GBDTPredictor,
}
_GBST = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")


def create_predictor(model_name: str, config, fs=None) -> OnlinePredictor:
    """name -> predictor. `config` is a HOCON path or a parsed config dict."""
    name = model_name.lower()
    if name in _PREDICTORS:
        return _PREDICTORS[name](config, fs)
    if name in _GBST:
        return GBSTPredictor(name, config, fs)
    raise ValueError(f"unknown model name {model_name!r}")
