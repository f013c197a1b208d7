"""Online predictor base: a trained model's text files + the training config
are enough to serve `score/predict` on feature dicts (reference:
predictor/OnlinePredictor.java:120-182).

Per-sample scoring is host Python/numpy; `numpy_activation` is the host
mirror of `Loss.predict`, so a single request never touches the device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import hocon
from ..io.fs import LocalFileSystem, create_filesystem
from ..losses import IDENTITY_LOSSES


def _np_sigmoid(s):
    s = np.asarray(s, np.float64)
    t = np.exp(-np.abs(s))  # stable: never exponentiates a large positive
    return np.where(s >= 0.0, 1.0 / (1.0 + t), t / (1.0 + t))


def numpy_activation(loss):
    """Host-numpy mirror of `loss.predict` for every loss the port serves."""
    if loss.name == "sigmoid":
        return _np_sigmoid
    if loss.name in IDENTITY_LOSSES:
        return lambda s: s
    raise NotImplementedError(f"no activation for loss {loss.name!r}")


class OnlinePredictor:
    """Config-driven model server (reference: OnlinePredictor.java).

    Subclasses implement `score(features)` / `scores(features)`; features
    is a {name: value} dict."""

    n_outputs = 1

    def __init__(self, config, fs: Optional[LocalFileSystem] = None):
        if isinstance(config, str):
            config = hocon.load(config)
        self.config = config
        self.fs = fs or create_filesystem(str(config.get("fs_scheme", "local")))

    def score(self, features: Dict[str, float]) -> float:
        raise NotImplementedError

    def scores(self, features: Dict[str, float]) -> List[float]:
        return [self.score(features)]

    def predict(self, features: Dict[str, float]) -> float:
        return float(numpy_activation(self.loss)(self.score(features)))

    def predicts(self, features: Dict[str, float]) -> List[float]:
        return [self.predict(features)]

    def batch_scores(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        out = np.empty((len(rows), self.n_outputs), np.float64)
        for i, fmap in enumerate(rows):
            out[i] = self.scores(fmap)
        return out if self.n_outputs > 1 else out[:, 0]

    def batch_predicts(self, rows) -> np.ndarray:
        return np.asarray(numpy_activation(self.loss)(self.batch_scores(rows)))
