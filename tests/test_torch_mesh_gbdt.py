"""The port's GBDT on N gloo ranks on the CPU (GBDTTrainer(mesh=...), the
sharded engine, the feature-parallel maker), held against the JAX
package's mesh-N trainer and the port's one-rank trainer on the same seeded
inputs (tests/test_gbdt_engine.py, test_goss_efb.py and
test_feature_parallel.py's cases at N = 2 and 4).

  int8 (loss policy, F = 6: at N = 4 the features pad to 8 and rank 3 owns
  only padding; the partitioned rungs under YTK_PARTITION=1; EFB): every
  tree equal to the one-rank port trees in every field, gains and leaf
  values bit for bit; against the JAX mesh-N trees split features, split
  values, children and sample counts exactly and the float statistics as
  the port's one-device trees are held to the JAX package's; the loss
  within rel 1e-5;
  GOSS (a = 0.5, b = 0) at the engine: the N-rank tree equals one rank
  grown on the hand-computed union of each shard's top half by |g|
  (test_goss_mesh8_matches_manual_union) and the JAX engine's sharded
  grow on a mesh of N devices, leaf assignment included;
  f32, both policies: loss within rel 1e-3 and AUC within 0.005 of one
  rank and of the JAX mesh-N run (test_engine_sharded_f32_quality's band);
  feature-parallel (tree_maker = "feature", columns sharded over the
  ranks): the data-parallel level-wise trees and the JAX package's
  feature-parallel mesh-N trees at test_feature_parallel.py's tolerances.

The ranks run once a world size (tests/torch_mp_worker.py)."""

import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec, \
    GBDTParams as JParams, ModelParams as JModel
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu.parallel import make_mesh

from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.engine import GrowSpec, grow
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

from torch_mp_worker import GBDT_CASES, case_data, case_params, goss_case, \
    run_ranks, tree_fields

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"gbdt{w}")
        out[w] = run_ranks("gbdt", w, str(d), timeout=600)
    return out


_ONE = {}


def _one_rank(name, tmp_path_factory, monkeypatch):
    """The port's one-rank run of a case (cached for the module)."""
    if name not in _ONE:
        kind, over, tkw, env = GBDT_CASES[name]
        X, y = case_data(kind)
        path = tmp_path_factory.mktemp(f"one_{name}") / "m.model"
        p = case_params(GBDTParams, ApproximateSpec, ModelParams, kind, over,
                        str(path))
        if name == "feature":
            # the data-parallel level-wise maker on the host engine
            p.tree_maker = "data"
            tkw = dict(engine="host")
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            _ONE[name] = GBDTTrainer(p, device="cpu", **tkw).train(
                train=GBDTData(X=X, y=y, weight=np.ones(len(y), np.float32),
                               n_real=len(y),
                               feature_names=[f"f{i}"
                                              for i in range(X.shape[1])]))
    return _ONE[name]


def _jax_mesh(name, world, tmp_path, monkeypatch):
    """The JAX package's mesh-N run of a case (the feature-parallel case on
    the engine its trainer picks, as test_feature_parallel.py runs it)."""
    kind, over, tkw, env = GBDT_CASES[name]
    X, y = case_data(kind)
    p = case_params(JParams, JSpec, JModel, kind, over,
                    str(tmp_path / "j.model"))
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    kw = dict(tkw)
    if name != "feature":
        kw.setdefault("engine", "device")
    return JTrainer(p, mesh=make_mesh(world), **kw).train(
        train=JData(X=X, y=y, weight=np.ones(len(y), np.float32),
                    n_real=len(y),
                    feature_names=[f"f{i}" for i in range(X.shape[1])]))


def _assert_trees_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("feat", "left", "right", "sample_cnt", "split",
                  "leaf_value", "hess_sum", "gain"):
            assert a[k] == b[k], k


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["int8_loss", "int8_part", "efb"])
def test_int8_ranks_equal_one_rank(ranks, world, name, tmp_path_factory,
                                   monkeypatch):
    """Exact: every field of every tree, the gains included, equals the
    one-rank port run; the loss within rel 1e-5; only rank 0 dumps."""
    one = _one_rank(name, tmp_path_factory, monkeypatch)
    for r, res in enumerate(ranks[world]):
        got = res[name]
        _assert_trees_equal(got["trees"], tree_fields(one.model))
        assert got["train_loss"] == pytest.approx(one.train_loss, rel=1e-5)
        assert got["dumped"] == (r == 0)


@pytest.mark.parametrize("world,name", [(2, "int8_loss"), (4, "int8_part"),
                                        (2, "efb")])
def test_int8_ranks_equal_jax_mesh(ranks, world, name, tmp_path,
                                   monkeypatch):
    """Against the JAX package's mesh-N trainer: split features, split
    values, children and sample counts exactly; leaf values and gains as
    the port's one-device trees are held to the JAX package's
    (test_torch_gbdt_objectives._assert_same_trees: XLA reorders the f32
    statistics of its whole-tree program, rtol 1e-5 plus 1e-5 of the
    tree's largest value); the loss within rel 1e-5."""
    want = _jax_mesh(name, world, tmp_path, monkeypatch)
    got = ranks[world][0][name]
    wt = tree_fields(want.model)
    assert len(got["trees"]) == len(wt)
    for a, b in zip(got["trees"], wt):
        for k in ("feat", "left", "right", "sample_cnt", "split"):
            assert a[k] == b[k], k
        for k in ("leaf_value", "gain"):
            scale = max(float(np.abs(b[k]).max()), 1e-30)
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5,
                                       atol=1e-5 * scale, err_msg=k)
    assert got["train_loss"] == pytest.approx(want.train_loss, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_goss_ranks_equal_manual_union(ranks, world):
    """Per-shard GOSS: the N-rank tree is one rank's tree on the union of
    every shard's top ceil(n_loc / 2) rows by |g| (int8 sums exact)."""
    bins, g, h, keep, F, B = goss_case(world)
    spec = GrowSpec(F=F, B=B, max_nodes=15, wave=2, policy="loss",
                    max_depth=10, max_leaves=8, lr=0.3, l1=0.0, l2=1.0,
                    min_h=1.0, max_abs=0.0, min_split_loss=0.0,
                    min_split_samples=0.0, hist_mode="int8", bm=128)
    tr, pos, _a, _w = grow(spec, torch.from_numpy(bins),
                           torch.from_numpy(keep), torch.from_numpy(g),
                           torch.from_numpy(h),
                           torch.ones(F, dtype=torch.bool))
    for res in ranks[world]:
        got = res["goss"]
        for k in ("feat", "slot", "slot_r", "left", "right", "leaf", "cnt"):
            np.testing.assert_array_equal(got[k], getattr(tr, k).numpy(),
                                          err_msg=k)
        assert got["n_nodes"] == int(tr.n_nodes)
    np.testing.assert_array_equal(
        np.concatenate([r["goss"]["pos"] for r in ranks[world]]),
        pos.numpy())


@pytest.mark.parametrize("world", WORLDS)
def test_goss_ranks_equal_jax_mesh(ranks, world):
    """Per-shard GOSS against the JAX package's engine on a mesh of `world`
    devices (test_goss_mesh8_matches_manual_union's sharded grow, key
    PRNGKey(0); b = 0 draws nothing): splits, children, counts and the
    rows' final nodes equal (int8 sums exact); leaf values as the port's
    one-device trees are held to the JAX package's (XLA reorders the f32
    leaf arithmetic: rtol 1e-5 plus 1e-5 of the largest |leaf|)."""
    import jax
    import jax.numpy as jnp

    from ytklearn_tpu.gbdt.engine import GrowSpec as JGrowSpec, \
        make_grow_tree

    bins, g, h, _keep, F, B = goss_case(world)
    spec = JGrowSpec(F=F, B=B, max_nodes=15, wave=2, policy="loss",
                     max_depth=10, max_leaves=8, lr=0.3, l1=0.0, l2=1.0,
                     min_h=1.0, max_abs=0.0, min_split_loss=0.0,
                     min_split_samples=0.0, force_dense=True,
                     hist_mode="int8", goss_a=0.5, goss_b=0.0)
    growN = make_grow_tree(spec, mesh=make_mesh(world))
    tr, _p, aux_pos, _w = jax.jit(
        lambda *a: growN(*a, key=jax.random.PRNGKey(0)))(
        jnp.asarray(bins), jnp.ones((len(g),), bool), jnp.asarray(g),
        jnp.asarray(h), jnp.ones((F,), bool))
    leaf = np.asarray(tr.leaf)
    for res in ranks[world]:
        got = res["goss"]
        for k in ("feat", "slot", "slot_r", "left", "right", "cnt"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(tr, k)),
                                          err_msg=k)
        np.testing.assert_allclose(got["leaf"], leaf, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(leaf).max()))
        assert got["n_nodes"] == int(tr.n_nodes)
    np.testing.assert_array_equal(
        np.concatenate([r["goss"]["pos"] for r in ranks[world]]),
        np.asarray(aux_pos[0]))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["f32_level", "f32_loss"])
def test_f32_ranks_quality(ranks, world, name, tmp_path_factory,
                           monkeypatch):
    """f32 partial sums add in another order: the fit is held, not the
    trees."""
    one = _one_rank(name, tmp_path_factory, monkeypatch)
    got = ranks[world][0][name]
    assert got["train_loss"] == pytest.approx(one.train_loss, rel=1e-3)
    assert got["auc"] == pytest.approx(one.train_metrics["auc"], abs=0.005)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", ["f32_level", "f32_loss"])
def test_f32_ranks_quality_jax_mesh(ranks, world, name, tmp_path,
                                    monkeypatch):
    """f32 on N ranks against the JAX package's mesh-N f32 run, both
    policies, at test_engine_sharded_f32_quality's band (loss rel 1e-3,
    AUC within 0.005): each side adds its f32 partial sums in its own
    order."""
    want = _jax_mesh(name, world, tmp_path, monkeypatch)
    got = ranks[world][0][name]
    assert got["train_loss"] == pytest.approx(want.train_loss, rel=1e-3)
    assert got["auc"] == pytest.approx(want.train_metrics["auc"], abs=0.005)


def _assert_fp_trees(got, want):
    """test_feature_parallel.py's tolerances."""
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a["feat"] == b["feat"]
        assert a["left"] == b["left"] and a["right"] == b["right"]
        np.testing.assert_allclose(a["split"], b["split"], rtol=1e-6)
        np.testing.assert_allclose(a["leaf_value"], b["leaf_value"],
                                   rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_feature_parallel_matches_jax_mesh(ranks, world, tmp_path,
                                           monkeypatch):
    """The port's feature-parallel maker on N ranks against the JAX
    package's on a mesh of N devices (tree_maker = "feature"), at
    test_feature_parallel.py's tolerances."""
    want = _jax_mesh("feature", world, tmp_path, monkeypatch)
    got = ranks[world][0]["feature"]
    _assert_fp_trees(got["trees"], tree_fields(want.model))
    assert got["train_loss"] == pytest.approx(want.train_loss, rel=1e-4)
    assert got["auc"] == pytest.approx(want.train_metrics["auc"], abs=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_feature_parallel_matches_data_parallel(ranks, world,
                                                tmp_path_factory,
                                                monkeypatch):
    """Columns sharded over the ranks grow the data-parallel level-wise
    maker's trees (test_feature_parallel.py's tolerances)."""
    one = _one_rank("feature", tmp_path_factory, monkeypatch)
    got = ranks[world][0]["feature"]
    _assert_fp_trees(got["trees"], tree_fields(one.model))
    assert got["train_loss"] == pytest.approx(one.train_loss, rel=1e-4)
    assert got["auc"] == pytest.approx(one.train_metrics["auc"], abs=1e-4)
    for r, res in enumerate(ranks[world]):
        assert res["feature"]["dumped"] == (r == 0)


def test_feature_parallel_auto_engine_is_host(tmp_path):
    p = GBDTParams(approximate=[ApproximateSpec(type="no_sample")],
                   tree_maker="feature",
                   model=ModelParams(data_path=str(tmp_path / "m")))
    assert GBDTTrainer(p, device="cpu").engine == "host"


def test_multi_process_refuses_the_host_engine(tmp_path):
    """Under --coordinator (own ingest, world > 1) the host engine is
    refused before any collective, as the reference refuses it."""
    import ytklearn_tpu_torch.parallel.mesh as pm

    m = pm.Mesh(rank=0, world=2, device=torch.device("cpu"), backend="gloo",
                shared_ingest=False)
    p = GBDTParams(approximate=[ApproximateSpec()], tree_maker="feature",
                   model=ModelParams(data_path=str(tmp_path / "m")))
    t = GBDTTrainer(p, device="cpu", mesh=m)
    with pytest.raises(ValueError, match="requires the device engine"):
        t.train(train=GBDTData(X=np.zeros((4, 2), np.float32),
                               y=np.zeros(4, np.float32),
                               weight=np.ones(4, np.float32), n_real=4,
                               feature_names=["a", "b"]))
    assert not os.path.exists(tmp_path / "m")
