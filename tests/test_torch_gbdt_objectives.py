"""Softmax (K trees a round) and l1 with the approximate LAD refine in the
port's GBDT trainer against the JAX package's device trainer, and the
multiclass losses neither trains; the shared helpers of
tests/test_torch_gbdt_{losses,resume}.py.

Both train the same seeded data on the CPU (`device="cpu"` for the port;
the JAX trainer takes its CPU path, `force_dense`), in int8 unless stated.

Tolerances. A loss whose gradients are exact IEEE arithmetic in both
packages (l1's sign, huber, mape, inv_mape, smape and the hinge losses)
trains the same trees: every tree's integer fields and split values are
compared exactly, its node values at rtol 1e-5 plus 1e-5 of the tree's
largest value and each round's losses at rtol 1e-5 (the reference's fused
program adds f32 in another order, and an inner node's value comes out of
a sibling subtraction, tests/test_torch_engine.py). Softmax, poisson and
exponential go through `exp`, which torch and XLA may round differently
in the last ulp, and an int8 gradient can then quantise one step apart:
softmax's round 0 (every class at the same score, exp(0)) is held
exactly, every later tree (every tree of poisson and exponential, whose
round 0 already takes exp) through the reference's `make_grow_tree` fed
the port's own gradients, masks and key (the integer fields exact), and
the losses at rtol 1e-4.

The LAD refine (`_lad_refine`) is held to the reference's
`_lad_refine_device` on the same tree, positions, labels, scores and
weights: exact at unit weights and, on the CPU, at fractional weights too
(the prefix sums run in XLA CPU's order, the CPU's index_add_ in row
order; on the card the weight histogram adds in atomic order, so there
only integer weights below 2^24 are exact).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt import engine as jengine
from ytklearn_tpu.gbdt import trainer as jtrainer
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import engine, prng
from ytklearn_tpu_torch.gbdt import trainer as ptrainer
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.predict.trees import GBDTPredictor

INT_FIELDS = ("feat", "feat_name", "left", "right", "slot", "sample_cnt",
              "default_left", "split")


class _Recording(GBDTTrainer):
    """Keeps, per tree, its weighted gradients, the round's masks, its GOSS
    key and its arrays."""

    def _round(self, rnd, dd, spec, st):
        gs, hs = self.loss.grad_hess(self.loss.predict(st[0]), dd.y)
        include, fmask = self._sample_masks(rnd, dd)
        out = super()._round(rnd, dd, spec, st)
        live = dd.weight > 0
        for grp in range(self.K):
            g = gs[:, grp] if self.K > 1 else gs
            h = hs[:, grp] if self.K > 1 else hs
            t = rnd * self.K + grp
            self.trees.append((
                torch.where(live, g * dd.weight, 0.0).numpy(),
                torch.where(live, h * dd.weight, 0.0).numpy(),
                include.numpy(), fmask.numpy(),
                self._goss_key(rnd, grp),
                {k: v[t].numpy() for k, v in out[2].items()}))
        return out


def _params(cls, spec_cls, model_cls, path, approx, **kw):
    base = dict(round_num=4, max_depth=3, max_leaf_cnt=16,
                learning_rate=0.3, l2=1.0, min_child_hessian_sum=1e-6,
                eval_metric=[], tree_grow_policy="loss")
    base.update(kw)
    return cls(approximate=[spec_cls(**approx)],
               model=model_cls(data_path=path, dump_freq=0), **base)


def _train_pair(tmp, train, test, precision="int8", approx=None, wave=4,
                efb=None, **kw):
    """The JAX trainer and the port's on the same (X, y, w) arrays."""
    approx = approx or {"max_cnt": 32}
    names = [f"f{i}" for i in range(train[0].shape[1])]

    def data(cls, d):
        X, y, w = d
        return cls(X, y, w, len(X), names)

    jp = _params(JParams, JSpec, JModelParams, str(tmp / "j.model"), approx,
                 **kw)
    pp = _params(GBDTParams, ApproximateSpec, ModelParams,
                 str(tmp / "p.model"), approx, **kw)
    jres = JTrainer(jp, engine="device", hist_precision=precision,
                    wave=wave, efb=efb).train(
        data(JData, train), data(JData, test) if test else None)
    ptr = _Recording(pp, hist_precision=precision, wave=wave, device="cpu",
                     efb=efb)
    ptr.trees = []
    pres = ptr.train(data(GBDTData, train),
                     data(GBDTData, test) if test else None)
    return jres, pres, ptr


def _losses(res, key):
    return np.asarray([r[key] for r in res.round_log])


def _assert_same_trees(pres, jres, trees=None):
    pt, jt = pres.model.trees, jres.model.trees
    assert len(pt) == len(jt)
    for i, (a, b) in enumerate(zip(pt, jt)):
        if trees is not None and i not in trees:
            continue
        for f in INT_FIELDS:
            assert getattr(a, f) == getattr(b, f), (i, f)
        # an inner node's value comes out of a sibling subtraction, whose
        # cancellation leaves an error of the tree's largest sums: rtol
        # 1e-5 plus 1e-5 of the tree's largest value, as
        # test_torch_engine._assert_same_tree holds grown trees
        scale = max(float(np.abs(b.leaf_value).max()), 1e-30)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=str(i))


def _assert_later_trees_grow_as_reference(ptr, first):
    """Every tree from index `first` on: the reference's grow on the
    port's gradients, masks and key grows the port's tree."""
    spec = ptr.grow_spec
    bins_t = jnp.asarray(ptr.dev_inputs.bins_t.numpy())
    jspec = jengine.GrowSpec(force_dense=True, **dataclasses.asdict(spec))
    grow = jax.jit(lambda *x, key: jengine.make_grow_tree(jspec)(*x,
                                                                 key=key))
    for t, (g, h, include, fmask, key, got) in enumerate(ptr.trees):
        if t < first:
            continue
        k = None if key is None else jnp.asarray(key.numpy().astype(
            np.uint32))
        with jax.enable_x64(False):
            jtr, *_ = grow(bins_t, jnp.asarray(include), jnp.asarray(g),
                           jnp.asarray(h), jnp.asarray(fmask), key=k)
        for f in ("feat", "slot", "slot_r", "left", "right", "cnt"):
            np.testing.assert_array_equal(got[f], np.asarray(getattr(jtr, f)),
                                          err_msg=f"tree {t} {f}")
        assert int(got["n_nodes"]) == int(jtr.n_nodes)


# -- softmax: K trees a round ------------------------------------------------


def _softmax_data(n, seed, K=3):
    """tests/test_gbdt.py::test_multiclass_softmax's data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    cls = np.argmax(np.stack([X[:, 0], X[:, 1], -(X[:, 0] + X[:, 1])],
                             axis=1), axis=1)
    return X, np.eye(K, dtype=np.float32)[cls], np.ones(n, np.float32)


@pytest.fixture(scope="module")
def softmax_run(tmp_path_factory):
    train, test = _softmax_data(1500, 1), _softmax_data(600, 2)
    return _train_pair(tmp_path_factory.mktemp("softmax"), train, test,
                       loss_function="softmax", class_num=3,
                       eval_metric=["confusion_matrix"]), train


def test_softmax_grows_k_trees_a_round(softmax_run):
    (jres, pres, ptr), (X, y, _) = softmax_run
    assert len(pres.model.trees) == len(jres.model.trees) == 4 * 3
    assert pres.model.num_tree_in_group == jres.model.num_tree_in_group == 3
    assert pres.model.base_prediction == jres.model.base_prediction
    _assert_same_trees(pres, jres, trees=range(3))  # round 0: all 3 groups
    _assert_later_trees_grow_as_reference(ptr, 3)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(pres, key), _losses(jres, key),
                                   rtol=1e-4)
    assert _losses(pres, "train_loss")[-1] < _losses(pres, "train_loss")[0]
    # the dumped model scores K columns, as training left them
    pred = GBDTPredictor({"model": {"data_path": ptr.params.model.data_path},
                          "optimization": {"loss_function": "softmax",
                                           "round_num": 100}})
    rows = [{f"f{j}": float(x[j]) for j in range(5)} for x in X[:300]]
    got = np.asarray([pred.scores(r) for r in rows])
    assert got.shape == (300, 3)
    final = ptr.final_scores[0][:300].numpy()
    np.testing.assert_allclose(got, final, rtol=1e-5, atol=1e-5)
    acc = float((np.argmax(got, axis=1) == np.argmax(y[:300], axis=1)).mean())
    assert acc > 0.85
    assert set(pres.train_metrics) == set(jres.train_metrics)


def test_softmax_trees_per_second_counts_trees(softmax_run):
    (_, _, ptr), _ = softmax_run
    log = ptr.sync_log
    assert len(log) >= 2 and ptr.time_stats["trees_per_sec_steady"] > 0
    r0, s0 = log[1] if len(log) >= 3 else log[0]
    r1, s1 = log[-1]
    assert ptr.time_stats["trees_per_sec_steady"] == pytest.approx(
        (r1 - r0) * 3 / max(s1 - s0, 1e-9))


def test_softmax_sample_dependent_base_and_goss(tmp_path):
    """Per-class base scores from the weighted label means, and GOSS with
    the rates: each group's tree draws its remainder with fold_in(kg,
    group), the round's row and feature masks drawn once."""
    train, test = _softmax_data(1500, 3), _softmax_data(500, 4)
    with jax.enable_x64(False):
        jres, pres, ptr = _train_pair(
            tmp_path, train, test, loss_function="softmax", class_num=3,
            sample_dependent_base_prediction=True,
            instance_sample_rate=0.8, feature_sample_rate=0.6)
    assert pres.model.base_prediction == jres.model.base_prediction
    _assert_same_trees(pres, jres, trees=range(3))
    _assert_later_trees_grow_as_reference(ptr, 3)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(pres, key), _losses(jres, key),
                                   rtol=1e-4)
    # the three trees of a round share its masks
    for rnd in range(4):
        masks = [ptr.trees[rnd * 3 + g][2:4] for g in range(3)]
        for m in masks[1:]:
            np.testing.assert_array_equal(m[0], masks[0][0])
            np.testing.assert_array_equal(m[1], masks[0][1])


def test_softmax_goss_keys_fold_in_the_group(tmp_path):
    train = _softmax_data(2000, 5)
    tr = _Recording(_params(GBDTParams, ApproximateSpec, ModelParams,
                            str(tmp_path / "m"), {"max_cnt": 32},
                            loss_function="softmax", class_num=3,
                            round_num=2),
                    hist_precision="int8", wave=4, device="cpu",
                    goss=(0.3, 0.2))
    tr.trees = []
    tr.train(GBDTData(*train, 2000, [f"f{i}" for i in range(5)]))
    keys = [t[4] for t in tr.trees]
    kg = prng.split(prng.fold_in(prng.PRNGKey(20170425), 1), 3)[2]
    for grp in range(3):
        assert torch.equal(keys[3 + grp], prng.fold_in(kg, grp))
    _assert_later_trees_grow_as_reference(tr, 0)


# -- l1: the approximate LAD refine -----------------------------------------


def _lad_case(n, seed, weights):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5).astype(np.float32)
    y = (X[:, 0] * 1.5 + np.abs(X[:, 1]) + 0.1 * rng.randn(n)).astype(
        np.float32)
    w = {"unit": np.ones(n, np.float32),
         "int": rng.randint(1, 4, n).astype(np.float32),
         "frac": (0.5 + rng.rand(n)).astype(np.float32)}[weights]
    return X, y, w


@pytest.mark.parametrize("n", [1500, 9000])  # the grid holds every row; not
@pytest.mark.parametrize("weights", ["unit", "int", "frac"])
def test_lad_refine_matches_reference(n, weights):
    """_lad_refine against _lad_refine_device on one grown tree, its
    positions, the labels, scores and weights, padding rows included."""
    X, y, w = _lad_case(n, 7, weights)
    n_pad = 16384
    rng = np.random.RandomState(1)
    bins = rng.randint(0, 16, size=(5, n_pad)).astype(np.uint8)
    bins[0, :n] = np.clip((X[:, 0] * 3 + 8).astype(int), 0, 15)
    yp = np.pad(y, (0, n_pad - n))
    wp = np.pad(w, (0, n_pad - n))
    real = np.arange(n_pad) < n
    scores = np.pad((0.3 * rng.randn(n)).astype(np.float32), (0, n_pad - n))
    g = np.sign(scores - yp).astype(np.float32) * wp
    spec = engine.GrowSpec(F=5, B=16, max_nodes=31, wave=4, policy="loss",
                           max_depth=4, max_leaves=16, lr=0.3, l1=0.0,
                           l2=1.0, min_h=1e-6, max_abs=0.0,
                           min_split_loss=0.0, min_split_samples=0.0,
                           hist_mode="int8", ladder=(8, 32), bm=128)
    tr, pos, _, _ = engine.grow(
        spec, torch.from_numpy(bins), torch.from_numpy(real),
        torch.from_numpy(g), torch.from_numpy(wp.copy()),
        torch.ones(5, dtype=torch.bool))
    got = ptrainer._lad_refine(tr, pos, torch.from_numpy(yp),
                               torch.from_numpy(scores), torch.from_numpy(wp),
                               torch.from_numpy(real), 0.3).numpy()
    jtr = jengine.TreeArrays(**{k: jnp.asarray(v.numpy())
                                for k, v in tr._asdict().items()})
    with jax.enable_x64(False):
        want = np.asarray(jtrainer._lad_refine_device(
            jtr, jnp.asarray(pos.numpy()), jnp.asarray(yp),
            jnp.asarray(scores), jnp.asarray(wp), jnp.asarray(real),
            0.3).leaf)
    np.testing.assert_array_equal(got, want)
    is_leaf = (tr.feat.numpy() == -1) & (np.arange(31) < int(tr.n_nodes))
    assert is_leaf.sum() >= 8
    assert not np.array_equal(got[is_leaf], tr.leaf.numpy()[is_leaf])


def test_lad_run_matches_reference(tmp_path):
    """tests/test_gbdt.py::test_lad_refine's run: l1's sign gradient is
    exact in both packages, so every tree and round loss agrees."""
    rng = np.random.RandomState(2)
    n = 1200
    X = rng.randn(n, 4).astype(np.float32)
    y = (2.0 * (X[:, 0] > 0) + (X[:, 1] > 0)).astype(np.float32)
    jres, pres, _ = _train_pair(
        tmp_path, (X, y, np.ones(n, np.float32)), None, loss_function="l1",
        round_num=6, learning_rate=0.5, eval_metric=["mae"],
        uniform_base_prediction=1.0)
    _assert_same_trees(pres, jres)
    np.testing.assert_allclose(_losses(pres, "train_loss"),
                               _losses(jres, "train_loss"), rtol=1e-5)
    assert pres.train_loss < 0.4
    assert abs(pres.train_metrics["mae"] - jres.train_metrics["mae"]) < 1e-5


def test_lad_weighted_run_matches_reference(tmp_path):
    """test_lad_refine_device_matches_precise's data: fractional weights,
    a test set, four rounds."""
    train, test = _lad_case(1500, 7, "frac"), _lad_case(400, 8, "frac")
    jres, pres, _ = _train_pair(tmp_path, train, test, loss_function="l1",
                                learning_rate=0.3,
                                uniform_base_prediction=1.0)
    _assert_same_trees(pres, jres)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(pres, key), _losses(jres, key),
                                   rtol=1e-5)


@pytest.mark.parametrize("loss,K", [("hsoftmax", 4), ("multiclass_hinge", 3),
                                    ("multiclass_smooth_hinge", 3),
                                    ("softmax", 1)])
def test_multiclass_losses_that_cannot_grow_a_gbdt_raise(tmp_path, loss, K):
    """One tree a round on a K-wide score: the reference fails on these at
    its first round (a shape error), the port refuses them up front."""
    kw = dict(loss_function=loss, class_num=K)
    if K > 1:
        train = _softmax_data(300, 1, K)
        jp = _params(JParams, JSpec, JModelParams, str(tmp_path / "j"),
                     {"max_cnt": 16}, **kw)
        with pytest.raises((ValueError, TypeError)):
            JTrainer(jp, engine="device", hist_precision="int8").train(
                JData(*train, 300, [f"f{i}" for i in range(5)]))
    pp = _params(GBDTParams, ApproximateSpec, ModelParams,
                 str(tmp_path / "p"), {"max_cnt": 16}, **kw)
    with pytest.raises(ValueError, match="cannot train a GBDT"):
        GBDTTrainer(pp, device="cpu", hist_precision="int8")


