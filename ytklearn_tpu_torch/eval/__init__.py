"""Evaluation metrics of the port (see ytklearn_tpu_torch/eval/metrics.py)."""

from .metrics import EvalSet, auc, auc_from_histogram, auc_histogram, \
    pointwise, pointwise_finalize, pointwise_sums

__all__ = ["EvalSet", "auc", "auc_from_histogram", "auc_histogram",
           "pointwise", "pointwise_finalize", "pointwise_sums"]
