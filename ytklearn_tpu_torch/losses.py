"""Prediction activations of the losses GBDT serves, as torch functions.

The serving half of ``ytklearn_tpu/losses.py``: `predict(score)` for the
sigmoid loss (:93) and the losses whose prediction is the raw score. The
training-side math (loss, derivatives, grad_hess) and the multiclass
activations come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch

#: losses whose predict() is the identity (LossFunction.predict default)
IDENTITY_LOSSES = (
    "l2", "l1", "huber", "mape", "inv_mape", "smape",
    "hinge", "l2_hinge", "smooth_hinge", "exponential",
)
_NOT_PORTED = (
    "poisson", "softmax", "hsoftmax",
    "multiclass_hinge", "multiclass_l2_hinge", "multiclass_smooth_hinge",
)


class Loss:
    """A loss as serving sees it: its name and its activation."""

    def __init__(self, name: str):
        self.name = name

    def predict(self, score: torch.Tensor) -> torch.Tensor:
        if self.name == "sigmoid":
            return torch.sigmoid(score)
        return score


def create_loss(name: str, params: Optional[dict] = None) -> Loss:
    """name -> Loss, with the JAX package's aliases (`sigmoid_cross_entropy`,
    `huber@delta`). `params` (e.g. sigmoid_zmax) only shape training."""
    del params
    base = str(name).lower().partition("@")[0]
    if base in ("softmax_cross_entropy", "hsoftmax_cross_entropy"):
        base = base[: -len("_cross_entropy")]
    if base in ("sigmoid", "sigmoid_cross_entropy"):
        return Loss("sigmoid")
    if base in IDENTITY_LOSSES:
        return Loss(base)
    if base in _NOT_PORTED:
        raise NotImplementedError(
            f"loss {name!r} is not ported yet (ROADMAP.md, rest of "
            "serving: poisson and the multiclass activations)"
        )
    raise ValueError(f"unsupported loss function: {name!r}")
