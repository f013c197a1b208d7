"""The convex families of the port (``ytklearn_tpu/models/``)."""

from .base import ConvexModel, carry_weights, random_init
from .ffm import FFMModel, load_field_dict
from .fm import FMModel
from .linear import LinearModel
from .multiclass import MulticlassLinearModel

__all__ = ["ConvexModel", "carry_weights", "random_init", "LinearModel",
           "MulticlassLinearModel", "FMModel", "FFMModel", "load_field_dict"]
