"""Losses as torch functions: serving activations and GBDT training math.

The counterpart of ``ytklearn_tpu/losses.py``. Every loss predicts
(`predict(score)`: sigmoid for `sigmoid`, the raw score for the losses
below); the two losses the GBDT device trainer is ported for also give

    loss(score, label)        objective per sample
    pred2score(pred)          inverse of predict
    grad_hess(pred, label)    (g, h) w.r.t. the score from the prediction

for `sigmoid` (with `sigmoid_zmax`, losses.py:79-117) and `l2`
(:120-133). Training with any other loss raises NotImplementedError
naming its ROADMAP.md item.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: losses whose predict() is the identity (LossFunction.predict default)
IDENTITY_LOSSES = (
    "l2", "l1", "huber", "mape", "inv_mape", "smape",
    "hinge", "l2_hinge", "smooth_hinge", "exponential",
)
#: losses with training math in the port
TRAINABLE = ("sigmoid", "l2")
_NOT_PORTED = (
    "poisson", "softmax", "hsoftmax",
    "multiclass_hinge", "multiclass_l2_hinge", "multiclass_smooth_hinge",
)


class Loss:
    """A loss by name: its activation, and for sigmoid and l2 the training
    math."""

    def __init__(self, name: str, zmax: float = 0.0):
        self.name = name
        # sigmoid_zmax caps |g/h| in the GBDT fast path
        self.zmax = float(zmax)

    def _trainable(self, what: str) -> None:
        if self.name not in TRAINABLE:
            raise NotImplementedError(
                f"{what} for loss {self.name!r}: only sigmoid and l2 train "
                "in the port; the other GBDT losses come with ROADMAP.md "
                "1.5 (rest of the GBDT trainer)"
            )

    def predict(self, score: torch.Tensor) -> torch.Tensor:
        if self.name == "sigmoid":
            return torch.sigmoid(score)
        return score

    def loss(self, score: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        self._trainable("loss")
        if self.name == "sigmoid":
            # log(1 + exp(s)) - s*y, branch-free as jnp.logaddexp(0, s)
            return torch.logaddexp(torch.zeros_like(score), score) \
                - score * label
        d = label - score
        return 0.5 * d * d

    def pred2score(self, pred: float) -> float:
        """Inverse of predict for a host scalar (base predictions), in f64."""
        self._trainable("pred2score")
        if self.name == "sigmoid":
            return -math.log(1.0 / pred - 1.0)
        return float(pred)

    def grad_hess(self, pred: torch.Tensor, label: torch.Tensor):
        self._trainable("grad_hess")
        if self.name == "l2":
            return pred - label, torch.ones_like(pred)
        g = pred - label
        h = pred * (1.0 - pred)
        if self.zmax > 0.0:
            # cap the implied newton step z = -g/h at +-zmax by inflating h
            z = torch.where(h != 0.0, -g / h, torch.zeros_like(g))
            h = torch.where(z > self.zmax, -(g / self.zmax), h)
            h = torch.where(z < -self.zmax, g / self.zmax, h)
        return g, h


def create_loss(name: str, params: Optional[dict] = None) -> Loss:
    """name -> Loss, with the JAX package's aliases (`sigmoid_cross_entropy`,
    `huber@delta`). `params` carries `sigmoid_zmax` for training."""
    zmax = float((params or {}).get("sigmoid_zmax", 0.0))
    base = str(name).lower().partition("@")[0]
    if base in ("softmax_cross_entropy", "hsoftmax_cross_entropy"):
        base = base[: -len("_cross_entropy")]
    if base in ("sigmoid", "sigmoid_cross_entropy"):
        return Loss("sigmoid", zmax)
    if base in IDENTITY_LOSSES:
        return Loss(base)
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ROADMAP.md, rest of "
            "serving: poisson and the multiclass activations)"
        )
    raise ValueError(f"unsupported loss function: {name!r}")
