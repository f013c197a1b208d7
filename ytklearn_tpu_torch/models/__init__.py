"""The convex and GBST families of the port (``ytklearn_tpu/models/``)."""

from .base import ConvexModel, carry_weights, random_init
from .ffm import FFMModel, load_field_dict
from .fm import FMModel
from .gbst import GBST_NAMES, GBSTModel, heap_leaf_probs
from .linear import LinearModel
from .multiclass import MulticlassLinearModel

__all__ = ["ConvexModel", "carry_weights", "random_init", "LinearModel",
           "MulticlassLinearModel", "FMModel", "FFMModel", "load_field_dict",
           "GBSTModel", "GBST_NAMES", "heap_leaf_probs"]
