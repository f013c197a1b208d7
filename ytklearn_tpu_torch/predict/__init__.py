"""Predictor side-stack (reference: predictor/OnlinePredictorFactory.java:32-80).

`create_predictor(model_name, config)` serves "gbdt"; every other family
raises NotImplementedError naming the ROADMAP.md item that ports it.
"""

from __future__ import annotations

from .base import OnlinePredictor, numpy_activation
from .trees import GBDTPredictor

__all__ = [
    "OnlinePredictor",
    "GBDTPredictor",
    "create_predictor",
    "numpy_activation",
]

_NOT_PORTED = {
    "linear": "Convex stack",
    "multiclass_linear": "Convex stack",
    "fm": "Convex stack",
    "ffm": "Convex stack",
    "gbmlr": "GBST",
    "gbsdt": "GBST",
    "gbhmlr": "GBST",
    "gbhsdt": "GBST",
}


def create_predictor(model_name: str, config, fs=None) -> OnlinePredictor:
    """name -> predictor. `config` is a HOCON path or a parsed config dict."""
    name = model_name.lower()
    if name == "gbdt":
        return GBDTPredictor(config, fs)
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{model_name!r} predictor is not ported yet "
            f"(ROADMAP.md, {_NOT_PORTED[name]})"
        )
    raise ValueError(f"unknown model name {model_name!r}")
