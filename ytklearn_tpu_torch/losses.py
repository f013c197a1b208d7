"""Losses as torch functions: activations and training math.

The counterpart of ``ytklearn_tpu/losses.py`` (reference loss/): every loss
is a set of elementwise torch functions over sample batches.

Scalar-score losses:
    loss(score, label)              objective per sample
    predict(score)                  score -> prediction
    pred2score(pred)                inverse of predict (a host float stays
                                    a host float, in f64)
    first_derivative(score, label)  dL/dscore
    second_derivative(score, label) d2L/dscore2
    grad_hess(pred, label)          (g, h) from the prediction (GBDT)

Multiclass losses (softmax, hsoftmax, multiclass_*hinge) work on the
trailing axis K: loss -> (...), predict and the derivatives -> (..., K)
(hsoftmax's scores are its K-1 internal gates). Labels of the binary
losses are in {0, 1}; the margin losses map them to +-1 as the reference
does.

The convex families train with every loss; the GBDT trainer trains with
`GBDT_TRAINABLE`: every scalar loss, and softmax with K > 1 trees a round.
The other multiclass losses cannot grow a GBDT (one tree a round on a
K-wide score): the JAX package's trainer fails on them with a shape
error, and the port refuses them with a ValueError.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

_POISSON_MAX_EXP = 30.0  # reference: loss/PoissonFunction.java MAX_EXP
_EXP_MAX_EXP = 8.0  # reference: loss/ExponentialFunction.java MAX_EXP

#: losses whose predict() is the identity (LossFunction.predict default or
#: the multiclass margins' identity)
IDENTITY_LOSSES = (
    "l2", "l1", "huber", "mape", "inv_mape", "smape",
    "hinge", "l2_hinge", "smooth_hinge", "exponential",
    "multiclass_hinge", "multiclass_l2_hinge", "multiclass_smooth_hinge",
)
#: losses the GBDT device trainer trains with
GBDT_TRAINABLE = (
    "sigmoid", "l2", "l1", "huber", "poisson", "mape", "inv_mape", "smape",
    "hinge", "l2_hinge", "smooth_hinge", "exponential", "softmax",
)


def _softplus(x):
    """log(1 + exp(x)), branch-free as jnp.logaddexp(0, x)."""
    return torch.logaddexp(torch.zeros_like(x), x)


def _where(cond, a, b, like):
    """jnp.where with python-scalar branches, in `like`'s dtype."""
    if not torch.is_tensor(a):
        a = torch.full_like(like, a)
    if not torch.is_tensor(b):
        b = torch.full_like(like, b)
    return torch.where(cond, a, b)


class LossFunction:
    """Base: a scalar-score loss."""

    name = "base"
    is_multiclass = False
    # reference: loss/LossFunctions.java:79 pureClassification
    pure_classification = False

    def loss(self, score, label):
        raise NotImplementedError

    def predict(self, score):
        return score

    def pred2score(self, pred):
        return pred

    def first_derivative(self, score, label):
        raise NotImplementedError

    def second_derivative(self, score, label):
        return torch.ones_like(score)

    def grad_hess(self, pred, label):
        """(g, h) with respect to the score, from the prediction."""
        score = self.pred2score(pred)
        return (self.first_derivative(score, label),
                self.second_derivative(score, label))

    def check_label(self, y) -> bool:
        """Whether every label of `y` is one this loss takes (any here)."""
        return True


class Sigmoid(LossFunction):
    """Logistic loss (reference: loss/SigmoidFunction.java)."""

    name = "sigmoid"
    pure_classification = True

    def __init__(self, zmax: float = 0.0):
        # sigmoid_zmax caps |g/h| in the GBDT fast path
        self.zmax = float(zmax)

    def loss(self, score, label):
        return _softplus(score) - score * label

    def predict(self, score):
        return torch.sigmoid(score)

    def pred2score(self, pred):
        if not torch.is_tensor(pred):
            return -math.log(1.0 / pred - 1.0)
        return -torch.log(1.0 / pred - 1.0)

    def first_derivative(self, score, label):
        return torch.sigmoid(score) - label

    def second_derivative(self, score, label):
        p = torch.sigmoid(score)
        return p * (1.0 - p)

    def grad_hess(self, pred, label):
        g = pred - label
        h = pred * (1.0 - pred)
        if self.zmax > 0.0:
            # cap the implied newton step z = -g/h at +-zmax by inflating h
            z = torch.where(h != 0.0, -g / h, torch.zeros_like(g))
            h = torch.where(z > self.zmax, -(g / self.zmax), h)
            h = torch.where(z < -self.zmax, g / self.zmax, h)
        return g, h

    def check_label(self, y) -> bool:
        return bool(torch.all((y >= 0.0) & (y <= 1.0)))


class L2(LossFunction):
    """Squared error (reference: loss/L2Function.java)."""

    name = "l2"

    def loss(self, score, label):
        d = label - score
        return 0.5 * d * d

    def pred2score(self, pred):
        return float(pred) if not torch.is_tensor(pred) else pred

    def first_derivative(self, score, label):
        return score - label

    def grad_hess(self, pred, label):
        return pred - label, torch.ones_like(pred)


class L1(LossFunction):
    """Absolute error; the second derivative reads 1 as in the reference,
    so L-BFGS curvature stays positive (loss/L1Function.java)."""

    name = "l1"

    def loss(self, score, label):
        return torch.abs(label - score)

    def first_derivative(self, score, label):
        return torch.sign(score - label)

    def grad_hess(self, pred, label):
        return torch.sign(pred - label), torch.ones_like(pred)


class Huber(LossFunction):
    """Huber loss with threshold delta (reference: loss/HuberFunction.java)."""

    name = "huber"

    def __init__(self, delta: float = 0.5):
        self.delta = float(delta)

    def loss(self, score, label):
        a = torch.abs(score - label)
        return torch.where(a <= self.delta, 0.5 * a * a,
                           self.delta * (a - 0.5 * self.delta))

    def first_derivative(self, score, label):
        a = score - label
        return torch.where(torch.abs(a) <= self.delta, a,
                           torch.sign(a) * self.delta)

    def second_derivative(self, score, label):
        return torch.zeros_like(score)


class Poisson(LossFunction):
    """Poisson regression, score = log(rate), with the log(y!) term
    (reference: loss/PoissonFunction.java)."""

    name = "poisson"

    def loss(self, score, label):
        s = torch.clamp(score, max=_POISSON_MAX_EXP)
        lbl = torch.clamp(label, min=0.0)
        return -label * score + torch.exp(s) + torch.lgamma(lbl + 1.0)

    def predict(self, score):
        return torch.exp(torch.clamp(score, max=_POISSON_MAX_EXP))

    def pred2score(self, pred):
        if not torch.is_tensor(pred):
            return math.log(pred)
        return torch.log(pred)

    def first_derivative(self, score, label):
        return torch.exp(torch.clamp(score, max=_POISSON_MAX_EXP)) - label

    def second_derivative(self, score, label):
        return torch.exp(torch.clamp(score, max=_POISSON_MAX_EXP))

    def grad_hess(self, pred, label):
        return pred - label, pred

    def check_label(self, y) -> bool:
        return bool(torch.all(y >= 0.0))


class MAPE(LossFunction):
    """reference: loss/MAPEFunction.java."""

    name = "mape"

    def loss(self, score, label):
        return torch.abs((label - score) / label)

    def first_derivative(self, score, label):
        return torch.sign(score - label) / label


class InvMAPE(LossFunction):
    """reference: loss/InvMAPEFunction.java."""

    name = "inv_mape"

    def loss(self, score, label):
        return torch.abs((label - score) / score)

    def first_derivative(self, score, label):
        return (torch.sign((score - label) / score) * label
                / (score * score))


class SMAPE(LossFunction):
    """reference: loss/SMAPEFunction.java."""

    name = "smape"

    def loss(self, score, label):
        return torch.abs(score - label) / ((label + torch.abs(score)) / 2.0)

    def first_derivative(self, score, label):
        deno = (label + torch.abs(score)) / 2.0
        return (torch.sign(score - label) * deno
                - 0.5 * torch.sign(score) * torch.abs(score - label)
                ) / (deno * deno)


class Hinge(LossFunction):
    """reference: loss/HingeFunction.java. Labels {0, 1} map to +-1."""

    name = "hinge"
    pure_classification = True

    def loss(self, score, label):
        return torch.clamp(1.0 - (2.0 * label - 1.0) * score, min=0.0)

    def first_derivative(self, score, label):
        ylab = 2.0 * label - 1.0
        return _where(ylab * score < 1.0, -ylab, 0.0, score)

    def second_derivative(self, score, label):
        return torch.zeros_like(score)


class L2Hinge(LossFunction):
    """reference: loss/L2HingeFunction.java."""

    name = "l2_hinge"
    pure_classification = True

    def loss(self, score, label):
        m = torch.clamp(1.0 - (2.0 * label - 1.0) * score, min=0.0)
        return 0.5 * m * m

    def first_derivative(self, score, label):
        ylab = 2.0 * label - 1.0
        z = ylab * score
        return _where(z <= 1.0, (z - 1.0) * ylab, 0.0, score)


class SmoothHinge(LossFunction):
    """reference: loss/SmoothHingeFunction.java."""

    name = "smooth_hinge"
    pure_classification = True

    def loss(self, score, label):
        z = (2.0 * label - 1.0) * score
        inner = _where(z < 1.0, 0.5 * (1.0 - z) * (1.0 - z), 0.0, z)
        return torch.where(z <= 0.0, 0.5 - z, inner)

    def first_derivative(self, score, label):
        ylab = 2.0 * label - 1.0
        z = ylab * score
        inner = _where(z < 1.0, -ylab * (1.0 - z), 0.0, z)
        return torch.where(z <= 0.0, -ylab, inner)

    def second_derivative(self, score, label):
        ylab = 2.0 * label - 1.0
        z = ylab * score
        return _where((z > 0.0) & (z < 1.0), ylab * ylab, 0.0, z)


class Exponential(LossFunction):
    """AdaBoost's exponential loss, exp clamped at 8
    (reference: loss/ExponentialFunction.java)."""

    name = "exponential"
    pure_classification = True

    def _e(self, score, label):
        ylab = 2.0 * label - 1.0
        return ylab, torch.exp(torch.clamp(-score * ylab, max=_EXP_MAX_EXP))

    def loss(self, score, label):
        return self._e(score, label)[1]

    def first_derivative(self, score, label):
        ylab, e = self._e(score, label)
        return -ylab * e

    def second_derivative(self, score, label):
        ylab, e = self._e(score, label)
        return ylab * ylab * e


# -- multiclass losses: the trailing axis is K ------------------------------


def _softmax(scores):
    """jax.nn.softmax's formula: exp(x - max) over its sum."""
    e = torch.exp(scores - torch.amax(scores, dim=-1, keepdim=True))
    return e / torch.sum(e, dim=-1, keepdim=True)


class MulticlassLoss(LossFunction):
    is_multiclass = True

    def check_label(self, y) -> bool:
        # one-hot rows must sum to ~1 (reference: SoftmaxFunction.checkLabel)
        return bool(torch.all(torch.abs(torch.sum(y, dim=-1) - 1.0) < 1e-3))


class Softmax(MulticlassLoss):
    """Softmax cross-entropy (reference: loss/SoftmaxFunction.java)."""

    name = "softmax"
    pure_classification = True

    def loss(self, scores, labels):
        shifted = scores - torch.amax(scores, dim=-1, keepdim=True)
        return (torch.log(torch.sum(torch.exp(shifted), dim=-1))
                - torch.sum(shifted * labels, dim=-1))

    def predict(self, scores):
        return _softmax(scores)

    def first_derivative(self, scores, labels):
        return _softmax(scores) - labels

    def second_derivative(self, scores, labels):
        p = _softmax(scores)
        return 2.0 * p * (1.0 - p)

    def grad_hess(self, pred, labels):
        # reference: SoftmaxFunction.getDerivativeFast, h = 2 p (1 - p)
        return pred - labels, 2.0 * (pred * (1.0 - pred))


class HSoftmax(MulticlassLoss):
    """Hierarchical softmax over a complete binary tree of K leaves with
    K-1 internal sigmoid gates in heap order (node 1 the root, node j's
    children 2j and 2j+1, leaves K..2K-1); K a power of two
    (reference: loss/HSoftmaxFunction.java)."""

    name = "hsoftmax"
    pure_classification = True

    def _mu(self, labels):
        """Subtree label mass mu[j] of heap nodes 1..2K-1, in a (..., 2K)
        buffer (slot 0 unused)."""
        K = labels.shape[-1]
        cols = [None] * (2 * K)
        cols[0] = torch.zeros_like(labels[..., 0])
        for i in range(K):
            cols[K + i] = labels[..., i]
        for j in range(K - 1, 0, -1):
            cols[j] = cols[2 * j] + cols[2 * j + 1]
        return torch.stack(cols, dim=-1)

    def _mus(self, labels):
        K = labels.shape[-1]
        mu = self._mu(labels)
        return mu[..., 1:K], mu[..., 2:2 * K:2]

    def loss(self, scores, labels):
        mu_parent, mu_left = self._mus(labels)
        return torch.sum(mu_parent * _softplus(scores) - mu_left * scores,
                         dim=-1)

    def predict(self, scores):
        K = scores.shape[-1] + 1
        g = torch.sigmoid(scores)  # P(left) at internal nodes 1..K-1
        level = torch.ones(scores.shape[:-1] + (1,), dtype=scores.dtype,
                           device=scores.device)
        for _ in range(int(math.log2(K))):
            n = level.shape[-1]
            gates = g[..., n - 1:2 * n - 1]
            level = torch.stack([level * gates, level * (1.0 - gates)],
                                dim=-1).reshape(scores.shape[:-1] + (2 * n,))
        return level

    def first_derivative(self, scores, labels):
        mu_parent, mu_left = self._mus(labels)
        return torch.sigmoid(scores) * mu_parent - mu_left

    def second_derivative(self, scores, labels):
        mu_parent, _ = self._mus(labels)
        g = torch.sigmoid(scores)
        return g * (1.0 - g) * mu_parent


class _MulticlassMarginLoss(MulticlassLoss):
    """The three multiclass hinge variants (reference:
    loss/MulticlassHingeFunction.java and friends): per-class margin terms
    against the target class; the target's gradient is -(sum of the
    others) + 1 unless the target is the last class, the reference's
    asymmetric convention."""

    def _margin_terms(self, diff):
        raise NotImplementedError

    def _margin_grad(self, diff):
        raise NotImplementedError

    def _extra(self) -> float:
        raise NotImplementedError

    def loss(self, scores, labels):
        st = torch.sum(scores * labels, dim=-1, keepdim=True)
        return (torch.sum(self._margin_terms(scores - st), dim=-1)
                - self._extra())

    def first_derivative(self, scores, labels):
        st = torch.sum(scores * labels, dim=-1, keepdim=True)
        d = self._margin_grad(scores - st)
        total = torch.sum(d, dim=-1, keepdim=True)
        target_is_last = labels[..., -1:] == 1.0
        fixed = torch.where(labels == 1.0, -total + 1.0, d)
        return torch.where(target_is_last, d, fixed)


class MulticlassHinge(_MulticlassMarginLoss):
    name = "multiclass_hinge"
    pure_classification = True

    def _margin_terms(self, diff):
        return torch.clamp(diff + 1.0, min=0.0)

    def _margin_grad(self, diff):
        return _where(diff + 1.0 > 0.0, 1.0, 0.0, diff)

    def _extra(self) -> float:
        return 1.0


class MulticlassL2Hinge(_MulticlassMarginLoss):
    name = "multiclass_l2_hinge"
    pure_classification = True

    def _margin_grad(self, diff):
        return torch.clamp(diff + 1.0, min=0.0)

    def loss(self, scores, labels):
        # the reference computes (sum m^2 - 1) * 0.5
        st = torch.sum(scores * labels, dim=-1, keepdim=True)
        m = torch.clamp(scores - st + 1.0, min=0.0)
        return 0.5 * (torch.sum(m * m, dim=-1) - 1.0)


class MulticlassSmoothHinge(_MulticlassMarginLoss):
    name = "multiclass_smooth_hinge"
    pure_classification = True

    def _margin_terms(self, diff):
        inner = _where(diff < -1.0, 0.0, 0.5 * (1.0 + diff) * (1.0 + diff),
                       diff)
        return torch.where(diff >= 0.0, diff + 0.5, inner)

    def _margin_grad(self, diff):
        inner = _where(diff < -1.0, 0.0, 1.0 + diff, diff)
        return _where(diff >= 0.0, 1.0, inner, diff)

    def _extra(self) -> float:
        return 0.5


# -- factory (reference: loss/LossFunctions.java:31-79) ---------------------

_SIMPLE = {
    "l2": L2, "l1": L1, "poisson": Poisson, "mape": MAPE,
    "inv_mape": InvMAPE, "smape": SMAPE, "hinge": Hinge,
    "l2_hinge": L2Hinge, "smooth_hinge": SmoothHinge,
    "exponential": Exponential, "softmax": Softmax, "hsoftmax": HSoftmax,
    "multiclass_hinge": MulticlassHinge,
    "multiclass_l2_hinge": MulticlassL2Hinge,
    "multiclass_smooth_hinge": MulticlassSmoothHinge,
}


_ALIASES = {"sigmoid_cross_entropy": "sigmoid",
            "softmax_cross_entropy": "softmax",
            "hsoftmax_cross_entropy": "hsoftmax"}


def create_loss(name: str, params: Optional[dict] = None) -> LossFunction:
    """name -> LossFunction, with the JAX package's aliases
    (`*_cross_entropy`, `huber@delta`, delta 0.5 by default). `params`
    carries `sigmoid_zmax` for GBDT training."""
    base, _, arg = str(name).lower().partition("@")
    base = _ALIASES.get(base, base)
    if base == "sigmoid":
        return Sigmoid(zmax=float((params or {}).get("sigmoid_zmax", 0.0)))
    if base == "huber":
        return Huber(delta=float(arg) if arg else 0.5)
    if base in _SIMPLE:
        return _SIMPLE[base]()
    raise ValueError(f"unsupported loss function: {name!r}")


def pure_classification(name: str) -> bool:
    """reference: loss/LossFunctions.java:79."""
    base = str(name).lower().partition("@")[0]
    if base.endswith("_cross_entropy"):
        base = base[: -len("_cross_entropy")]
    cls = Sigmoid if base == "sigmoid" else _SIMPLE.get(base)
    return cls is not None and cls.pure_classification
