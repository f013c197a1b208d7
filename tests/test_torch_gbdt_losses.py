"""The GBDT trainer's scalar losses in the port against the JAX package's
device trainer: huber, poisson, mape, inv_mape, smape, the three hinge
losses and exponential, on the CPU in int8, with the tolerances of
tests/test_torch_gbdt_objectives.py (whose helpers this file uses).

mape trains on 16384 training rows: the trainer pads rows to a multiple
of 16384, and the reference's mape gradient sign(s - y) / y is NaN on a
padding row (label 0, weight 0), which its histograms carry into every
leaf. The port zeroes the weighted gradients of weight-0 rows instead;
`test_mape_with_padding_rows_stays_finite` holds that.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from test_torch_gbdt_objectives import _assert_later_trees_grow_as_reference, \
    _assert_same_trees, _losses, _params, _train_pair


def _scalar_data(loss, n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6).astype(np.float32)
    signal = 1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) \
        + 0.8 * (X[:, 3] > 0.5)
    if loss in ("hinge", "l2_hinge", "smooth_hinge", "exponential"):
        y = (signal + 0.5 * rng.randn(n) > 0).astype(np.float32)
    elif loss == "poisson":
        y = rng.poisson(np.exp(0.4 * signal)).astype(np.float32)
    elif loss in ("mape", "inv_mape", "smape"):
        y = (3.0 + signal + 0.2 * rng.randn(n)).astype(np.float32)
        y = np.maximum(y, 0.5)
    else:
        y = (signal + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y, np.ones(n, np.float32)


#: (loss, exact gradients, training rows, extra params)
SCALAR = [
    ("huber", True, 6000, {}),
    ("poisson", False, 6000, {"min_child_hessian_sum": 5.0}),
    ("mape", True, 16384, {"uniform_base_prediction": 3.0}),
    ("inv_mape", True, 6000, {"uniform_base_prediction": 3.0}),
    ("smape", True, 6000, {"uniform_base_prediction": 3.0}),
    ("hinge", True, 6000, {"uniform_base_prediction": 0.0}),
    ("l2_hinge", True, 6000, {"uniform_base_prediction": 0.0}),
    ("smooth_hinge", True, 6000, {"uniform_base_prediction": 0.0}),
    ("exponential", False, 6000, {"uniform_base_prediction": 0.0}),
]


@pytest.mark.parametrize("loss,exact,n,extra", SCALAR,
                         ids=[c[0] for c in SCALAR])
def test_scalar_loss_trains_as_reference(tmp_path, loss, exact, n, extra):
    train, test = _scalar_data(loss, n, 3), _scalar_data(loss, 2000, 4)
    kw = dict(loss_function=loss, round_num=4, max_depth=4,
              min_child_hessian_sum=0.0, learning_rate=0.2)
    kw.update(extra)
    jres, pres, ptr = _train_pair(tmp_path, train, test, **kw)
    if exact:
        _assert_same_trees(pres, jres)
        rtol = 1e-5
    else:
        # round 0 already goes through exp (poisson's exp(log(0.5))), so
        # every tree is held through the reference's grow
        _assert_later_trees_grow_as_reference(ptr, 0)
        rtol = 1e-4
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(pres, key), _losses(jres, key),
                                   rtol=rtol)
    assert np.isfinite(_losses(pres, "train_loss")).all()
    assert sum(t.n_nodes() > 1 for t in pres.model.trees) >= 2


def test_mape_with_padding_rows_stays_finite(tmp_path):
    """6000 rows pad to 16384: the port trains finite trees where the
    reference's NaN gradients of the padding rows empty them."""
    train = _scalar_data("mape", 6000, 3)
    pp = _params(GBDTParams, ApproximateSpec, ModelParams,
                 str(tmp_path / "m"), {"max_cnt": 32}, loss_function="mape",
                 uniform_base_prediction=3.0, min_child_hessian_sum=0.0)
    res = GBDTTrainer(pp, device="cpu", hist_precision="int8").train(
        GBDTData(*train, 6000, [f"f{i}" for i in range(6)]))
    losses = _losses(res, "train_loss")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(t.n_nodes() > 1 for t in res.model.trees)


