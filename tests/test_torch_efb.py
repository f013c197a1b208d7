"""EFB (exclusive feature bundling) in the port against the JAX package.

The plan (`plan_bundles`, `build_bundle_plan`), the bundled bin matrix,
the range tables, `unbundle_split` and `unbundle_tree` are held exactly
against the reference's. `split_kernel(ranges=...)` is bit-equal to the
reference's on the same histograms, and `grow` with ranges (routing K5's
plain version with the members' `lo`/`hi`) grows the reference's trees,
positions and wave log exactly in int8 (f32 statistics at rtol 1e-5, as
tests/test_torch_engine.py holds them).

Bundled against unbundled training (conflict budget 0): int8 sums are
exact, so the tree structure, the counts and the split values are equal;
the range correction adds the member's default rows to the left side in
another f32 order than the unbundled column's prefix sum, so gains and
leaves agree to the last ulps (held at rtol 1e-5), as the reference's own
tests/test_goss_efb.py::test_efb_lossless_on_exclusive_block holds them.
"""

import contextlib
import dataclasses
import io
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ytklearn_tpu import cli as jcli
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt import binning as jbin
from ytklearn_tpu.gbdt import engine as jengine
from ytklearn_tpu.gbdt import trainer as jtrainer
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.tree import Tree as JTree
from ytklearn_tpu.gbdt.tree import unbundle_tree as junbundle_tree
from ytklearn_tpu_torch import cli
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.eval import EvalSet
from ytklearn_tpu_torch.gbdt import binning, engine, state
from ytklearn_tpu_torch.gbdt import trainer as ptrainer
from ytklearn_tpu_torch.gbdt.binning import BundlePlan, bundle_bin_matrix_t, \
    plan_bundles
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.gbdt.tree import Tree, unbundle_tree
from ytklearn_tpu_torch.predict import create_predictor
from test_torch_engine import _assert_same_tree, _jspec

TREE_INT = ("feat", "feat_name", "left", "right", "slot", "split",
            "sample_cnt", "default_left")


def _sparse_data(n=1600, F_dense=3, F_excl=5, seed=5, loss="sigmoid"):
    """F_dense gaussian columns and F_excl mutually exclusive non-negative
    sparse ones (one nonzero a row), with signal on both blocks."""
    rng = np.random.RandomState(seed)
    Xd = rng.randn(n, F_dense).astype(np.float32)
    grp = rng.randint(0, F_excl, n)
    Xs = np.zeros((n, F_excl), np.float32)
    Xs[np.arange(n), grp] = rng.rand(n).astype(np.float32) + 0.25
    X = np.concatenate([Xd, Xs], axis=1)
    logit = (X[:, 0] * X[:, 1] + 1.5 * X[:, F_dense]
             - 1.2 * X[:, F_dense + 2] + 0.8 * X[:, F_dense + 3])
    noise = 0.3 * rng.randn(n)
    y = (logit + noise > 0) if loss == "sigmoid" else logit + noise
    names = [f"f{i}" for i in range(F_dense + F_excl)]
    return X, y.astype(np.float32), names


def _data(X, y, names):
    return GBDTData(X=X, y=y, weight=np.ones(len(X), np.float32),
                    n_real=len(X), feature_names=names)


def _params(tmp_path, **over):
    kw = dict(round_num=3, max_depth=20, max_leaf_cnt=12,
              tree_grow_policy="loss", learning_rate=0.3,
              min_child_hessian_sum=1.0, loss_function="sigmoid",
              eval_metric=["auc"], approximate=[ApproximateSpec(max_cnt=32)],
              model=ModelParams(data_path=str(tmp_path / "m.model"),
                                dump_freq=0))
    kw.update(over)
    return GBDTParams(**kw)


def _same_plan(plan, jplan):
    assert plan.bundles == jplan.bundles
    np.testing.assert_array_equal(plan.col_fid, jplan.col_fid)
    assert plan.member_lo == jplan.member_lo
    assert plan.member_hi == jplan.member_hi
    assert (plan.n_cols, plan.summary()) == (jplan.n_cols, jplan.summary())


# -- the plan ------------------------------------------------------------------


def test_efb_plan_greedy_budget_and_width():
    cand = np.asarray([10, 11, 12, 13])
    conflicts = np.asarray([[50, 0, 0, 9], [0, 50, 0, 9], [0, 0, 50, 9],
                            [9, 9, 9, 50]], np.int64)
    counts = np.zeros((20,), np.int64)
    counts[[10, 11, 12, 13]] = 8  # 7 nonzero bins each
    plan = plan_bundles(cand, conflicts, counts, F=20, max_conflict=0,
                        max_width=32)
    assert plan.bundles == [[10, 11, 12]]  # 13 conflicts: stays out
    assert plan.bundle_width(0) == 1 + 3 * 7
    assert plan.n_cols == 20 - 3 + 1
    plan_w = plan_bundles(cand, conflicts, counts, F=20, max_conflict=0,
                          max_width=16)
    assert all(len(m) == 2 for m in plan_w.bundles[:1])
    plan_c = plan_bundles(cand, conflicts, counts, F=20, max_conflict=30,
                          max_width=64)
    assert plan_c.bundles == [[10, 11, 12, 13]]
    assert plan_bundles(cand, np.full((4, 4), 9, np.int64), counts, 20, 0,
                        64) is None
    for args in ((0, 32), (0, 16), (30, 64), (9, 23)):
        _same_plan(plan_bundles(cand, conflicts, counts, 20, *args),
                   jbin.plan_bundles(cand, conflicts, counts, 20, *args))


def _conflicting_block(n, seed):
    """Six dense columns and 24 sparse ones in three groups: a one-hot
    block, a nearly exclusive one with a few conflict rows, and wide
    columns (many bins) that the width cap has to split."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 30), np.float32)
    X[:, :6] = rng.randn(n, 6)
    grp = rng.randint(0, 10, n)
    X[np.arange(n), 6 + grp] = rng.rand(n) + 0.5
    grp2 = rng.randint(0, 8, n)
    X[np.arange(n), 16 + grp2] = np.round(rng.rand(n) * 4) + 1
    hit = rng.rand(n) < 0.02
    X[hit, 16 + (grp2[hit] + 1) % 8] = 2.0  # conflict rows
    sel = rng.rand(n) < 0.3
    X[sel, 24 + rng.randint(0, 6, sel.sum())] = rng.rand(sel.sum()) * 9
    return X


@pytest.mark.parametrize("budget,width,first_two", [
    (0, 64, [[6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [16, 18, 20, 22]]),
    (0, 16, [[6, 7, 8, 10, 11, 12, 14], [9, 13, 15]]),
    (200, 64, [[6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
               [16, 17, 18, 19, 20, 21, 22, 23]]),
    (40, 256, [[6, 7, 8, 9, 10, 11, 12, 13, 14, 15], [16, 17, 18, 21]])])
def test_build_bundle_plan_matches_jax(budget, width, first_two):
    """The greedy order, the exact conflict counts, the budget and the
    bundle cap: plans that differ across these settings, each equal to
    the reference's; the range tables and the bundled matrix too."""
    X = _conflicting_block(6000, 1)
    pp = GBDTParams(approximate=[ApproximateSpec(max_cnt=16)])
    X_t = torch.from_numpy(np.ascontiguousarray(X.T))
    bins = binning.build_bins_maybe_device(X_t, None, pp)
    plan = binning.build_bundle_plan(X_t, bins, budget, width)
    jplan = jbin.build_bundle_plan(np.ascontiguousarray(X.T), bins, budget,
                                   width)
    _same_plan(plan, jplan)
    assert plan.bundles[:2] == first_two
    B = 1 << (bins.max_bins - 1).bit_length()
    for a, b in zip(plan.range_tables(B), jplan.range_tables(B)):
        np.testing.assert_array_equal(a, b)
    raw = binning.bin_matrix_device(X_t, bins)
    got = bundle_bin_matrix_t(raw, plan)
    want = jbin.bundle_bin_matrix_t(raw.numpy(), jplan)
    assert got.dtype == raw.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    carried = state.bundle_plan_from_fields(dataclasses.asdict(jplan))
    _same_plan(carried, jplan)


def test_efb_unbundle_split_mapping():
    plan = BundlePlan(n_features=5, col_fid=np.asarray([0, 2], np.int32),
                      bundles=[[1, 3, 4]], member_lo=[[1, 4, 9]],
                      member_hi=[[3, 8, 12]])
    assert plan.n_cols == 3
    assert plan.unbundle_split(1, 2, 3) == (2, 2, 3)
    assert plan.unbundle_split(2, 5, 6) == (3, 2, 3)
    assert plan.unbundle_split(2, 3, 4) == (3, 0, 1)
    assert plan.unbundle_split(2, 0, 9) == (4, 0, 1)
    rlo, rhi = plan.range_tables(16)
    assert rlo[2, 4] == 4 and rhi[2, 4] == 8
    assert rlo[2, 12] == 9 and rhi[2, 12] == 12
    assert rlo[2, 0] == 0 and rhi[2, 0] == 15
    assert rlo[0, 7] == 0 and rhi[0, 7] == 15
    with pytest.raises(ValueError, match="no member range"):
        plan.member_of_slot(2, 13)
    # a tree over columns 0-2 unbundles as the reference's does
    fields = dict(feat=[2, 1, 2, -1, -1, -1, -1], slot=[3, 2, 5, 0, 0, 0, 0],
                  split=[4.0, 3.0, 6.0, 0.0, 0.0, 0.0, 0.0],
                  left=[1, 3, 5, -1, -1, -1, -1],
                  right=[2, 4, 6, -1, -1, -1, -1])
    t, jt = Tree(**fields), JTree(**{k: list(v) for k, v in fields.items()})
    unbundle_tree(t, plan)
    junbundle_tree(jt, plan)
    assert (t.feat, t.slot, t.split) == (jt.feat, jt.slot, jt.split)
    assert t.feat[:3] == [3, 2, 3]


def test_efb_bundle_matrix_encoding_and_conflict_winner():
    plan = BundlePlan(n_features=3, col_fid=np.asarray([0], np.int32),
                      bundles=[[1, 2]], member_lo=[[1, 4]],
                      member_hi=[[3, 6]])
    bins_t = torch.tensor([[5, 5, 5, 5], [0, 2, 0, 3], [0, 0, 1, 2]],
                          dtype=torch.uint8)
    out = bundle_bin_matrix_t(bins_t, plan)
    assert out.dtype == torch.uint8
    assert out[0].tolist() == bins_t[0].tolist()
    # row 3 is a conflict row: the higher-offset member (fid 2) wins
    assert out[1].tolist() == [0, 2, 4, 5]


# -- split_kernel and grow with ranges -----------------------------------------


def _bundle_hist(rng, N, F, B, plan):
    """Histograms whose last column is a bundle laid out by `plan`, with
    empty member bins, a member with no rows and f32 sums in mixed
    magnitudes."""
    q = rng.randint(-300, 300, size=(N, F, B, 3)).astype(np.float32)
    q[..., 1:] = np.abs(q[..., 1:]) + 1
    q[..., 2][rng.rand(N, F, B) < 0.3] = 0.0
    hi = plan.member_hi[0][-1]
    q[:, -1, hi + 1:] = 0.0  # the bundle's tail
    lo1, hi1 = plan.member_lo[0][1], plan.member_hi[0][1]
    q[0, -1, lo1:hi1 + 1] = 0.0  # a member with no rows in node 0
    return (q * np.asarray([0.0123, 0.00731, 1.0], np.float32)).astype(
        np.float32)


@pytest.mark.parametrize("N,F,B", [(1, 3, 16), (6, 4, 32), (4, 28, 256)])
def test_split_kernel_with_ranges_matches_jax_bitwise(N, F, B):
    rng = np.random.RandomState(N * F + B)
    widths = [3, 1, 5, 2] if B > 16 else [3, 1, 4]
    lo, hi, off = [], [], 1
    for w in widths:
        lo.append(off)
        hi.append(off + w - 1)
        off += w
    plan = BundlePlan(n_features=F - 1 + len(widths),
                      col_fid=np.arange(F - 1, dtype=np.int32),
                      bundles=[list(range(F - 1, F - 1 + len(widths)))],
                      member_lo=[lo], member_hi=[hi])
    hist = _bundle_hist(rng, N, F, B, plan)
    ranges = plan.range_tables(B)
    fmask = np.ones(F, bool)
    for cfg in ((0.0, 1.0, 1.0, 0.0), (0.5, 2.0, 3.0, 0.0),
                (0.2, 1.0, 1.0, 0.05)):
        want = jengine.split_kernel(jnp.asarray(hist), jnp.asarray(fmask),
                                    cfg, tuple(jnp.asarray(r)
                                               for r in ranges))
        got = engine.split_kernel(torch.from_numpy(hist),
                                  torch.from_numpy(fmask), cfg,
                                  tuple(torch.from_numpy(r) for r in ranges))
        for i, (w, o) in enumerate(zip(want, got)):
            if i == 0 and cfg[3] > 0:
                # the clamped gain's multiply-adds: XLA contracts them into
                # FMAs, so that gain is held at rtol 1e-6 (as without ranges)
                np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("mode", ["int8", "f32"])
def test_grow_with_ranges_matches_make_grow_tree(mode):
    """A bundled bin matrix through grow with the plan's range tables:
    the member ranges steer the split scan and route each split's rows
    with K5's lo/hi (the plain version here)."""
    X, y, names = _sparse_data(n=6000, F_dense=3, F_excl=12, seed=9,
                               loss="l2")
    pp = GBDTParams(approximate=[ApproximateSpec(max_cnt=16)])
    X_t = torch.from_numpy(np.ascontiguousarray(X.T))
    bins = binning.build_bins_maybe_device(X_t, None, pp)
    B = 32
    plan = binning.build_bundle_plan(X_t, bins, 0, B)
    assert plan is not None and plan.n_bundled_features == 12
    bt = bundle_bin_matrix_t(binning.bin_matrix_device(X_t, bins), plan)
    F = bt.shape[0]
    g = (0.3 - y).astype(np.float32)
    h = np.ones(len(y), np.float32)
    jspec = _jspec(F, B, hist_mode="int8" if mode == "int8" else "mxu",
                   use_bf16=False, min_h=1.0)
    ranges = plan.range_tables(B)
    jtr, jpos, _, jwlog = jax.jit(
        jengine.make_grow_tree(jspec, ranges=ranges))(
        jnp.asarray(bt.numpy()), jnp.ones(len(y), bool), jnp.asarray(g),
        jnp.asarray(h), jnp.ones((F,), bool))
    spec = state.grow_spec_from_fields(dataclasses.asdict(jspec))
    tr, pos, _, wlog = engine.grow(
        spec, bt.to(torch.uint8), torch.ones(len(y), dtype=torch.bool),
        torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool),
        ranges=tuple(torch.from_numpy(r) for r in ranges))
    got = state.tree_arrays_to_numpy(tr)
    want = {k: np.asarray(v) for k, v in jtr._asdict().items()}
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(wlog.numpy(), np.asarray(jwlog))
    # some split chose a bundle column, inside a member's range
    n_split = int(got["n_nodes"])
    bundled = [i for i in range(n_split) if got["feat"][i] == F - 1]
    assert bundled and all(got["slot_r"][i] >= 1 for i in bundled)


# -- training ------------------------------------------------------------------


def test_efb_noop_on_dense(tmp_path):
    """No exclusive columns: no plan, and EFB on is the EFB-off run, byte
    for byte."""
    rng = np.random.RandomState(5)
    X = rng.randn(1200, 6).astype(np.float32)
    y = (X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) > 0).astype(np.float32)
    data = _data(X, y, [str(i) for i in range(6)])
    texts = {}
    for efb in (True, False):
        (tmp_path / str(efb)).mkdir()
        tr = GBDTTrainer(_params(tmp_path / str(efb)), device="cpu", wave=4,
                         efb=efb)
        tr.train(train=data)
        assert tr._efb_plan is None
        texts[efb] = (tmp_path / str(efb) / "m.model").read_text()
    assert texts[True] == texts[False]


def _train(tmp_path, name, data, **kw):
    (tmp_path / name).mkdir()
    over = kw.pop("over", {})
    tr = GBDTTrainer(_params(tmp_path / name, **over), device="cpu", wave=4,
                     hist_precision="int8", **kw)
    return tr, tr.train(train=data)


@pytest.mark.parametrize("loss", ["sigmoid", "l2"])
def test_efb_lossless_on_exclusive_block(tmp_path, loss):
    X, y, names = _sparse_data(loss=loss)
    data = _data(X, y, names)
    over = {} if loss == "sigmoid" else {"loss_function": "l2",
                                         "eval_metric": ["rmse"]}
    t_on, r_on = _train(tmp_path, "on", data, efb=True, over=over)
    t_off, r_off = _train(tmp_path, "off", data, efb=False, over=over)
    plan = t_on._efb_plan
    # the width cap (B = 32) keeps one 7-bin member of five out
    assert plan is not None and plan.bundles == [[3, 5, 6, 7]]
    assert t_on.dev_inputs.F == plan.n_cols == 5
    for a, b in zip(r_on.model.trees, r_off.model.trees):
        for f in TREE_INT:
            assert getattr(a, f) == getattr(b, f), f
        # leaves near 0 are differences of large sums: an absolute floor
        # of 1e-5 of the largest |leaf|, as tests/test_torch_engine.py
        np.testing.assert_allclose(
            a.leaf_value, b.leaf_value, rtol=1e-5,
            atol=1e-5 * np.abs(b.leaf_value).max())
        assert all(n in names or n == "" for n in a.feat_name)
    assert r_on.train_loss == pytest.approx(r_off.train_loss, rel=1e-5)
    # the dump, in original features, scores the raw rows as training did
    pred = create_predictor("gbdt", {
        "model": {"data_path": str(tmp_path / "on" / "m.model")},
        "optimization": {"loss_function": loss, "round_num": 100}})
    rows = [{n: float(v) for n, v in zip(names, x)} for x in X]
    fin = t_on.final_scores[0][:len(X)].numpy()
    np.testing.assert_allclose(pred.batch_scores(rows), fin, rtol=1e-5,
                               atol=1e-5)
    if loss == "sigmoid":
        auc = EvalSet(["auc"]).evaluate(
            torch.sigmoid(torch.from_numpy(fin)), torch.from_numpy(y),
            torch.ones(len(y)))["auc"]
        assert auc == pytest.approx(r_off.train_metrics["auc"], abs=1e-6)


def test_efb_trainer_matches_jax(tmp_path):
    """int8 l2 training with EFB against the JAX trainer: the same plan,
    the trees' integer fields and split values exact, leaves at rtol
    1e-5, features dumped by their original names."""
    X, y, names = _sparse_data(n=4000, F_dense=3, F_excl=40, seed=2,
                               loss="l2")
    kw = dict(round_num=4, max_depth=20, max_leaf_cnt=12,
              tree_grow_policy="loss", learning_rate=0.3,
              min_child_hessian_sum=1.0, loss_function="l2",
              eval_metric=["rmse"])
    w = np.ones(len(X), np.float32)
    jt = jtrainer.GBDTTrainer(
        JParams(approximate=[JSpec(max_cnt=32)],
                model=JModelParams(data_path=str(tmp_path / "j"),
                                   dump_freq=0), **kw),
        engine="device", hist_precision="int8", wave=4, efb=True)
    jres = jt.train(JData(X, y, w, len(X), names))
    pt = GBDTTrainer(GBDTParams(approximate=[ApproximateSpec(max_cnt=32)],
                                model=ModelParams(
                                    data_path=str(tmp_path / "p"),
                                    dump_freq=0), **kw),
                     device="cpu", hist_precision="int8", wave=4, efb=True)
    pres = pt.train(GBDTData(X, y, w, len(X), names))
    _same_plan(pt._efb_plan, jt._efb_plan)
    assert len(pt._efb_plan.bundles) == 2
    for a, b in zip(pres.model.trees, jres.model.trees):
        for f in TREE_INT:
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5)
    assert {n for t in pres.model.trees for n in t.feat_name} - {""} <= \
        set(names)


def test_goss_plus_efb_combined(tmp_path):
    """Bundled columns and sampled rows still learn the planted signal and
    dump in original features."""
    X, y, names = _sparse_data(n=1600)
    t, res = _train(tmp_path, "ge", _data(X, y, names), efb=True,
                    goss=(0.4, 0.25))
    assert t._efb_plan is not None
    k_a = int(np.ceil(0.4 * 1600))
    assert res.model.trees[0].sample_cnt[0] == \
        k_a + int(np.ceil(0.25 * (1600 - k_a)))
    assert res.train_metrics["auc"] > 0.8
    assert all(name.startswith("f") for name in res.model.feature_importance())


# -- cli train -----------------------------------------------------------------


def _write_sparse_text(path, rng, n, n_dense=3, n_onehot=24):
    lines = []
    for _ in range(n):
        xd = rng.randn(n_dense)
        k = rng.randint(n_onehot)
        v = rng.rand() + 0.25
        y = xd[0] * xd[1] + (1.5 * v if k < 8 else -v) + 0.3 * rng.randn()
        feats = [f"d{j}:{float(np.float32(xd[j]))!r}" for j in range(n_dense)]
        feats.append(f"s{k}:{float(np.float32(v))!r}")
        lines.append(f"1###{float(y)!r}###{','.join(feats)}")
    path.write_text("\n".join(lines) + "\n")


def test_cli_train_int8_l2_sparse_matches_jax_cli(tmp_path):
    """Both CLIs (int8 histograms, l2, `value@0` fill) on text with a
    one-hot block: the port bundles it as the JAX CLI does, and the model
    texts have the same trees (structure, counts, split values, default
    directions, original feature names) with leaves at rtol 1e-5; the
    sidecars are byte-identical."""
    rng = np.random.RandomState(17)
    _write_sparse_text(tmp_path / "train.txt", rng, 6000)
    _write_sparse_text(tmp_path / "test.txt", rng, 1500)

    def args(who):
        return ["gbdt", "experiment/higgs/local_gbdt.conf",
                "--set", f"data.train.data_path={tmp_path / 'train.txt'}",
                "--set", f"data.test.data_path={tmp_path / 'test.txt'}",
                "--set", "data.max_feature_dim=27",
                "--set", f"model.data_path={tmp_path / who / 'gbdt.model'}",
                "--set", f"model.feature_importance_path={tmp_path / who}/i",
                "--set", "optimization.round_num=3",
                "--set", "optimization.max_leaf_cnt=15",
                "--set", "optimization.loss_function=l2",
                "--set", 'optimization.eval_metric=["rmse"]',
                "--set", "feature.approximate=" + json.dumps([{
                    "cols": "default", "type": "sample_by_quantile",
                    "max_cnt": 32, "use_sample_weight": False,
                    "alpha": 0.5}])]

    plans = {}

    def int8(base, who):
        class Int8(base):
            def __init__(self, *a, **k):
                k["hist_precision"] = "int8"
                super().__init__(*a, **k)

            def _prep_device_inputs(self, *a, **k):
                out = super()._prep_device_inputs(*a, **k)
                plans[who] = self._efb_plan
                return out
        return Int8

    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer, "GBDTTrainer", int8(jtrainer.GBDTTrainer, "jax"))
    mp.setattr(ptrainer, "GBDTTrainer", int8(ptrainer.GBDTTrainer, "port"))
    try:
        for who, fn, extra in (("jax", jcli.train_main, ["--devices", "1"]),
                               ("port", lambda a: cli.main(["train"] + a),
                                ["--device", "cpu"])):
            with contextlib.redirect_stdout(io.StringIO()):
                assert fn(args(who) + extra) == 0
    finally:
        mp.undo()
    _same_plan(plans["port"], plans["jax"])
    assert plans["port"].n_bundled_features == 24
    jt = (tmp_path / "jax" / "gbdt.model").read_text()
    pt = (tmp_path / "port" / "gbdt.model").read_text()
    jm, pm = JModel.loads(jt), JModel.loads(pt)
    assert len(pm.trees) == len(jm.trees) == 3
    for a, b in zip(pm.trees, jm.trees):
        for f in ("feat_name", "left", "right", "split", "default_left",
                  "sample_cnt"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5)
    assert any(n.startswith("s") for t in pm.trees for n in t.feat_name)
    js = json.loads((tmp_path / "jax" / "gbdt.model.bins.json").read_text())
    ps = json.loads((tmp_path / "port" / "gbdt.model.bins.json").read_text())
    js.pop("model_digest"), ps.pop("model_digest")
    assert json.dumps(ps) == json.dumps(js)
