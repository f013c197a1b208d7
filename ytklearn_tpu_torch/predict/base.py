"""Online predictor base: a trained model's text files + the training config
are enough to serve `score/predict` on feature dicts (reference:
predictor/OnlinePredictor.java:120-182).

Per-sample scoring is host Python/numpy; `numpy_activation` is the host
mirror of `LossFunction.predict`, so a single request never touches the
device.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import hocon
from ..io.fs import LocalFileSystem, create_filesystem
from ..losses import _POISSON_MAX_EXP, IDENTITY_LOSSES


def _np_sigmoid(s):
    s = np.asarray(s, np.float64)
    t = np.exp(-np.abs(s))  # stable: never exponentiates a large positive
    return np.where(s >= 0.0, 1.0 / (1.0 + t), t / (1.0 + t))


def _np_softmax(s):
    s = np.asarray(s, np.float64)
    e = np.exp(s - np.max(s, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def numpy_activation(loss):
    """Host mirror of `loss.predict` on float64 scores: numpy for every
    loss but hsoftmax, whose heap walk runs the torch function on a CPU
    tensor."""
    if loss.name == "sigmoid":
        return _np_sigmoid
    if loss.name in IDENTITY_LOSSES:
        return lambda s: s
    if loss.name == "poisson":
        return lambda s: np.exp(np.minimum(np.asarray(s, np.float64),
                                           _POISSON_MAX_EXP))
    if loss.name == "softmax":
        return _np_softmax
    return lambda s: loss.predict(
        torch.as_tensor(np.asarray(s, np.float64))).numpy()


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

    def _activation(self, s):
        return numpy_activation(self.loss)(s)

    def predict(self, features: Dict[str, float]) -> float:
        return float(self._activation(self.score(features)))

    def predicts(self, features: Dict[str, float]) -> List[float]:
        return [self.predict(features)]

    def batch_scores(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        out = np.empty((len(rows), self.n_outputs), np.float64)
        for i, fmap in enumerate(rows):
            out[i] = self.scores(fmap)
        return out if self.n_outputs > 1 else out[:, 0]

    def batch_predicts(self, rows) -> np.ndarray:
        return np.asarray(self._activation(self.batch_scores(rows)))
