"""Evaluation metrics as torch functions (``ytklearn_tpu/eval/metrics.py``).

  bucketed AUC   predictions in [0, 1] map to `int(pred * slots)` clamped
                 to [0, slots-1]; pair counts use the trapezoid
                 `neg_i * (pos_above_i + 0.5 * pos_i)` (AucEvaluator.java)
                 multiclass (pred (n, K)) is micro-averaged over the
                 (sample, class) pairs
  rmse / mae / mape / smape
                 weighted pointwise means (pointwise_sums, then
                 pointwise_finalize); zero-weight rows are masked before
                 weighting
  confusion_matrix[@threshold]
                 the (K, K) weighted count matrix (rows the true class);
                 EvalSet reports its accuracy
  logloss        weighted mean of -(y log p + (1-y) log(1-p)); an addition
                 of the port (the JAX EvalSet has none; its bench reports
                 the sigmoid test loss under that name)

Sums run in the dtype of the weights, as in the reference.

Every metric is a local accumulator and a finalize step: the AUC slot
histogram, the pointwise (sum, weight sum) pair and the confusion counts.
`EvalSet.evaluate(..., mesh=)` psums each rank's accumulators
(parallel/collectives.py) before it finalizes, the reference's
allreduceArray (AucEvaluator.java:96); predictions are never gathered.
With integer weights the psummed AUC histogram is the one-rank histogram
while every slot sums below 2^24 (f32 integer sums are exact).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEFAULT_AUC_SLOTS = 100000  # reference: data/Constants.java:47


def auc_histogram(pred, y, weight, slots: int = DEFAULT_AUC_SLOTS):
    """(slots, 2) histogram: [:, 0] = positive weight, [:, 1] = negative."""
    idx = torch.clamp((pred * slots).to(torch.int32), 0, slots - 1).long()
    is_pos = (y == 1.0).to(weight.dtype)
    pos = torch.zeros(slots, dtype=weight.dtype, device=weight.device)
    neg = torch.zeros_like(pos)
    pos.index_add_(0, idx, weight * is_pos)
    neg.index_add_(0, idx, weight * (1.0 - is_pos))
    return torch.stack([pos, neg], dim=1)


def auc_from_histogram(hist) -> torch.Tensor:
    """Trapezoidal pair count over the slot histogram; 0.5 for data of one
    class (no pairs)."""
    pos, neg = hist[:, 0], hist[:, 1]
    total_pos = torch.sum(pos)
    pos_above = total_pos - torch.cumsum(pos, dim=0)
    pair_sum = torch.sum(neg * (pos_above + 0.5 * pos))
    denom = total_pos * torch.sum(neg)
    return torch.where(
        denom > 0, pair_sum / torch.where(denom > 0, denom,
                                          torch.ones_like(denom)),
        torch.full_like(denom, 0.5))


def auc(pred, y, weight=None, slots: int = DEFAULT_AUC_SLOTS
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weighted, unweighted) AUC; each (sample, class) pair of a (n, K)
    prediction scores the binary event y[:, k] == 1, with the sample's
    weight."""
    w = torch.ones(pred.shape[:1], dtype=pred.dtype, device=pred.device) \
        if weight is None else weight
    if pred.ndim == 2:
        K = pred.shape[1]
        pred, y = pred.reshape(-1), y.reshape(-1)
        w = torch.repeat_interleave(w, K)
    weighted = auc_from_histogram(auc_histogram(pred, y, w, slots))
    mask = (w != 0).to(pred.dtype)
    unweighted = auc_from_histogram(auc_histogram(pred, y, mask, slots))
    return weighted, unweighted


def _logloss_row(y, p):
    return -(y * torch.log(p) + (1.0 - y) * torch.log(1.0 - p))


_POINTWISE_ROWS: Dict[str, Callable] = {
    "rmse": lambda y, p: (y - p) * (y - p),
    "mae": lambda y, p: torch.abs(y - p),
    "mape": lambda y, p: torch.abs((y - p) / y),
    "smape": lambda y, p: torch.abs(y - p) / ((y + torch.abs(p)) / 2.0),
    "logloss": _logloss_row,
}


def pointwise_sums(pred, y, weight, kind: str) -> torch.Tensor:
    """The local (weighted sum, weight sum) pair. Zero-weight rows (mesh
    padding) are masked before the row metric is weighted: mape and smape
    divide by the label, and a padding row's y = 0 would make inf * 0 =
    NaN of the sum."""
    row = _POINTWISE_ROWS[kind](y, pred)
    row = torch.where(weight > 0, row, torch.zeros_like(row))
    return torch.stack([torch.sum(row * weight), torch.sum(weight)])


def pointwise_finalize(sums, kind: str) -> torch.Tensor:
    v = sums[0] / sums[1]
    return torch.sqrt(v) if kind == "rmse" else v


def pointwise(pred, y, weight=None, kind: str = "rmse") -> torch.Tensor:
    w = torch.ones_like(pred) if weight is None else weight
    return pointwise_finalize(pointwise_sums(pred, y, w, kind), kind)


def confusion_counts(pred, y, weight, K: int = 2, threshold: float = 0.5):
    """(K, K) weighted counts, rows the true class, columns the predicted:
    a binary pred in [0, 1] against `threshold`, a (n, K) pred by argmax
    against the one-hot y's."""
    if pred.ndim == 2:
        t = torch.argmax(y, dim=-1)
        p = torch.argmax(pred, dim=-1)
    else:
        t = y.to(torch.int64)
        p = (pred >= threshold).to(torch.int64)
    m = torch.zeros(K * K, dtype=weight.dtype, device=weight.device)
    m.index_add_(0, t * K + p, weight)
    return m.reshape(K, K)


def confusion_accuracy(m) -> torch.Tensor:
    return torch.sum(torch.diagonal(m)) / torch.sum(m)


def confusion_matrix(pred, y, weight=None, K: int = 2,
                     threshold: float = 0.5) -> Dict[str, torch.Tensor]:
    """The matrix, per-class precision and recall, and the accuracy
    (reference: ConfusionMatrixEvaluator)."""
    w = torch.ones(pred.shape[:1], dtype=pred.dtype, device=pred.device) \
        if weight is None else weight
    m = confusion_counts(pred, y, w, K, threshold)
    diag = torch.diagonal(m)
    col = torch.sum(m, dim=0)
    row = torch.sum(m, dim=1)
    one = torch.ones_like(col)
    return {
        "matrix": m,
        "precision": diag / torch.where(col == 0, one, col),
        "recall": diag / torch.where(row == 0, one, row),
        "accuracy": confusion_accuracy(m),
    }


def _parse_metric(name: str) -> Tuple[str, Optional[float]]:
    base, _, arg = name.strip().partition("@")
    return base.lower(), (float(arg) if arg else None)


def _auc_hist(pred, y, w, slots: int):
    """The local weighted AUC histogram; a (n, K) prediction's (sample,
    class) pairs each score y[:, k] == 1 with the sample's weight."""
    if pred.ndim == 2:
        K = pred.shape[1]
        pred, y = pred.reshape(-1), y.reshape(-1)
        w = torch.repeat_interleave(w, K)
    return auc_histogram(pred, y, w, slots)


def create_evaluator_fns(metric_names: Sequence[str], K: int = 2
                         ) -> Dict[str, Tuple[Callable, Callable]]:
    """metric name -> (local accumulator fn(pred, y, weight), finalize fn
    of the accumulator) (reference: eval/EvaluatorFactory.java:52-64)."""
    fns: Dict[str, Tuple[Callable, Callable]] = {}
    for name in metric_names:
        base, arg = _parse_metric(name)
        if base == "auc":
            slots = int(arg) if arg else DEFAULT_AUC_SLOTS
            fns[name] = (lambda p, y, w, s=slots: _auc_hist(p, y, w, s),
                         auc_from_histogram)
        elif base in _POINTWISE_ROWS:
            fns[name] = (lambda p, y, w, k=base: pointwise_sums(p, y, w, k),
                         lambda sums, k=base: pointwise_finalize(sums, k))
        elif base == "confusion_matrix":
            thr = arg if arg is not None else 0.5
            fns[name] = (lambda p, y, w, t=thr: confusion_counts(
                p, y, w, K, t), confusion_accuracy)
        else:
            raise ValueError(f"unknown evaluate_metric: {name!r}")
    return fns


def _psum_all(accs: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every accumulator summed over the ranks, one psum a dtype."""
    from ..parallel.collectives import psum

    out: List[Optional[torch.Tensor]] = [None] * len(accs)
    groups: Dict[torch.dtype, List[int]] = {}
    for i, a in enumerate(accs):
        groups.setdefault(a.dtype, []).append(i)
    for idx in groups.values():
        flat = psum(torch.cat([accs[i].reshape(-1) for i in idx]), mesh)
        off = 0
        for i in idx:
            n = accs[i].numel()
            out[i] = flat[off:off + n].reshape(accs[i].shape)
            off += n
    return out


class EvalSet:
    """Run the configured metrics on (pred, y, weight) tensors; K classes
    for the confusion matrix. With `mesh`, every rank passes its own rows
    and gets the metrics of all ranks' rows (the same numbers on every
    rank; each rank must call it at the same point: it is a collective)."""

    def __init__(self, metric_names: Sequence[str], K: int = 2):
        self.metric_names = list(metric_names)
        self.fns = create_evaluator_fns(metric_names, K)

    def evaluate(self, pred, y, weight=None, mesh=None) -> Dict[str, float]:
        w = (torch.ones(pred.shape[:1], dtype=torch.float32,
                        device=pred.device) if weight is None else weight)
        accs = [local(pred, y, w) for local, _ in self.fns.values()]
        if mesh is not None and accs:
            accs = _psum_all(accs, mesh)
        return {name: float(fin(acc)) for (name, (_, fin)), acc
                in zip(self.fns.items(), accs)}

    def format(self, results: Dict[str, float], prefix: str = "") -> str:
        """One `<prefix> <metric> = <value>` line a result."""
        return "\n".join(f"{prefix} {k} = {v}" for k, v in results.items())
