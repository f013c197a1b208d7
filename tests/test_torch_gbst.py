"""The port's GBST (ytklearn_tpu_torch/models/gbst.py, boost.py) against
the JAX package's, on the same seeded convex_synth data.

The model: `heap_leaf_probs` and `tree_output` of all four variants on the
same weights at rtol 1e-6 (float32), the gradient of `pure_loss` at rtol
1e-5 (atol 1e-5 of its largest |entry|: float32 sums in another order), as
tests/test_torch_convex_models.py holds the convex families; the
row-chunked loss and gradient, with the per-feature gate mask passed whole
into every chunk, equal to the unchunked ones and to the JAX package's
chunked scan.

The trainer: each variant trained by both packages' GBSTTrainer on the CPU
(the JAX side in float32, `jax.enable_x64(False)`, as its CLI runs), with
gradient_boosting and random_forest, 0.8 instance and feature rates, 6
L-BFGS iterations a tree. The first tree's init weights and masks are
bit-equal; per-tree fit losses and the ensemble's train and test losses
agree at rtol 1e-4 and test AUC within 1e-4 (tests/test_torch_hoag_train
.py's bounds for L-BFGS runs whose float32 sums differ in order: few
iterations a tree keep the two trajectories together); the dumps of the
same weights are byte-identical. continue_train (2 + 1 trees, rates 1.0 so
both runs draw the same masks) reproduces the 3-tree run byte for byte
within each package and agrees with the other package's.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ytklearn_tpu import boost as jboost
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.models import gbst as jgbst
from ytklearn_tpu.optimize import blocked as jblocked
from ytklearn_tpu_torch import boost as pboost
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.io.fs import LocalFileSystem as PFS
from ytklearn_tpu_torch.io.reader import DataIngest
from ytklearn_tpu_torch.models import GBSTModel, carry_weights, \
    heap_leaf_probs
from ytklearn_tpu_torch.optimize.blocked import chunked_value_and_grad, \
    value_and_grad
from ytklearn_tpu_torch.scripts.convex_synth import write_gbst_case

VARIANTS = ["gbmlr", "gbsdt", "gbhmlr", "gbhsdt"]
RTOL = 1e-4


def _cfg(tmp, **kw):
    shape = dict(K=4, tree_num=3, instance_sample_rate=0.8,
                 feature_sample_rate=0.8, vocab=300, nnz=8, l2=1e-3,
                 max_iter=6)
    shape.update(kw)
    cfg = write_gbst_case(str(tmp), 1500, 400, 17, **shape)
    cfg["loss"]["evaluate_metric"] = ["auc"]
    cfg["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-7
    return cfg


# -- the model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gbst_model")
    cfg = _cfg(tmp, K=8)
    ing = DataIngest(PParams.from_config(cfg)).load()
    return cfg, ing


def _pair(cfg, ing, variant):
    jm = jgbst.GBSTModel(JParams.from_config(cfg), ing.train.dim, variant)
    pm = GBSTModel(PParams.from_config(cfg), ing.train.dim, variant,
                   device="cpu")
    return jm, pm


def _inputs(jm, ing, seed=3):
    """Perturbed init weights, a random gate mask (bias on), z, and the
    batch as numpy."""
    rng = np.random.RandomState(seed)
    w = (jm.init_weights(tree_seed=2)
         + rng.randn(jm.dim).astype(np.float32) * 0.4).astype(np.float32)
    gm = (rng.rand(jm.n_features) < 0.7).astype(np.float32)
    gm[0] = 1.0
    ds = ing.train
    z = (rng.randn(ds.n) * 0.3).astype(np.float32)
    return w, (ds.idx, ds.val, z, gm, ds.y, ds.weight)


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.max(np.abs(want))))


def test_heap_leaf_probs_match_jax():
    rng = np.random.RandomState(0)
    for K in (2, 4, 8, 16):
        sig = rng.rand(37, K - 1).astype(np.float32)
        want = np.asarray(jgbst.heap_leaf_probs(jnp.asarray(sig)))
        got = heap_leaf_probs(torch.from_numpy(sig)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("variant", VARIANTS)
def test_init_layout_and_reg_vectors_exact(variant, data):
    cfg, ing = data
    jm, pm = _pair(cfg, ing, variant)
    assert pm.dim == jm.dim and pm.regular_blocks() == jm.regular_blocks()
    for t in (0, 1, 5):
        assert np.array_equal(pm.init_weights(tree_seed=t),
                              jm.init_weights(tree_seed=t))
    for j, p in zip(jm.reg_vectors(0.1, 0.3), pm.reg_vectors(0.1, 0.3)):
        assert np.array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("variant", VARIANTS)
def test_tree_output_and_gradient_match_jax(variant, data):
    cfg, ing = data
    jm, pm = _pair(cfg, ing, variant)
    w, batch = _inputs(jm, ing)
    with jax.enable_x64(False):
        jw, jb = jnp.asarray(w), tuple(jnp.asarray(a) for a in batch)
        jout = np.asarray(jm.tree_output(jw, *jb[:2], jb[3]))
        jscores = np.asarray(jm.scores(jw, *jb[:4]))
        jrf = np.asarray(jm.rf_predict_scores(jw, *jb[:4], 3))
        jl, jg = jax.value_and_grad(jm.pure_loss)(jw, *jb)
    pw = carry_weights(w, pm)
    pb = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    np.testing.assert_allclose(pm.tree_output(pw, *pb[:2], pb[3]).numpy(),
                               jout, rtol=1e-6, atol=1e-6 * np.abs(jout).max())
    np.testing.assert_allclose(pm.scores(pw, *pb[:4]).numpy(), jscores,
                               rtol=1e-6, atol=1e-6 * np.abs(jscores).max())
    np.testing.assert_allclose(pm.rf_predict_scores(pw, *pb[:4], 3).numpy(),
                               jrf, rtol=1e-6, atol=1e-6 * np.abs(jrf).max())
    loss, grad = value_and_grad(pm.pure_loss)(pw, *pb)
    _close(float(loss), float(jl), 1e-5)
    _close(grad.numpy(), np.asarray(jg), 1e-5)
    # masked features' gates get no gradient, in both packages
    masked = np.nonzero(batch[3] == 0)[0]
    K = pm.K
    off, S = (K, K - 1) if pm.scalar_leaves else (0, 2 * K - 1)
    gates = (off + masked[:, None] * S + np.arange(K - 1)[None, :]).ravel()
    assert np.all(grad.numpy()[gates] == 0.0)
    assert np.all(np.asarray(jg)[gates] == 0.0)


@pytest.mark.parametrize("chunk", [256, 333])
@pytest.mark.parametrize("variant", ["gbmlr", "gbhsdt"])
def test_row_mask_chunking(variant, chunk, data):
    """A fit split into row chunks passes the (n_features,) gate mask whole
    into every chunk: loss and gradient equal the unchunked ones and the
    JAX package's chunked scan."""
    cfg, ing = data
    jm, pm = _pair(cfg, ing, variant)
    w, batch = _inputs(jm, ing, seed=4)
    assert chunk < ing.train.n
    pw = carry_weights(w, pm)
    pb = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in batch)
    loss, grad = value_and_grad(pm.pure_loss)(pw, *pb)
    closs, cgrad = chunked_value_and_grad(pm.pure_loss, chunk,
                                          pm.batch_row_mask)(pw, *pb)
    _close(float(closs), float(loss), 1e-5)
    _close(cgrad.numpy(), grad.numpy(), 1e-5)
    with jax.enable_x64(False):
        jl, jg = jblocked.chunked_value_and_grad(
            jm.pure_loss, chunk, jm.batch_row_mask)(
            jnp.asarray(w), *(jnp.asarray(a) for a in batch))
    _close(float(closs), float(jl), 1e-5)
    _close(cgrad.numpy(), np.asarray(jg), 1e-5)


# -- the trainer --------------------------------------------------------------


def _record(mp, module, sink):
    """Keep the first fit's w0, gate mask and effective weights."""
    real = module.minimize_lbfgs

    def rec(fn, w0, config, batch=(), **kw):
        if not sink:
            sink.append(tuple(np.array(a) for a in (w0, batch[3],
                                                     batch[5])))
        return real(fn, w0, config, batch=batch, **kw)

    mp.setattr(module, "minimize_lbfgs", rec)


def _train_pair(cfg, variant, root, tag):
    """Both trainers on one config -> {who: (BoostResult, first fit,
    model dir)}."""
    out = {}
    for who, module, pcls, kw in (("jax", jboost, JParams, {}),
                                  ("port", pboost, PParams,
                                   {"device": "cpu"})):
        c = copy.deepcopy(cfg)
        c["model"]["data_path"] = os.path.join(root, who, tag)
        sink = []
        mp = pytest.MonkeyPatch()
        _record(mp, module, sink)
        try:
            with jax.enable_x64(False):
                res = module.GBSTTrainer(pcls.from_config(c), variant,
                                         **kw).train()
        finally:
            mp.undo()
        out[who] = (res, sink[0] if sink else None, c["model"]["data_path"])
    return out


RUNS = [(v, t) for v in VARIANTS for t in ("gradient_boosting",
                                            "random_forest")]
RESUMED = ["gbmlr", "gbhsdt"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gbst_train")
    cfg = _cfg(tmp)
    out = {"dir": str(tmp)}
    for variant, typ in RUNS:
        c = copy.deepcopy(cfg)
        c["type"] = typ
        out[(variant, typ)] = _train_pair(c, variant, str(tmp),
                                          f"{variant}_{typ}")
    full = copy.deepcopy(cfg)
    full["instance_sample_rate"] = full["feature_sample_rate"] = 1.0
    for variant in RESUMED:
        out[(variant, "3")] = _train_pair(full, variant, str(tmp),
                                          f"{variant}_3")
        two = copy.deepcopy(full)
        two["tree_num"] = 2
        out[(variant, "2")] = _train_pair(two, variant, str(tmp),
                                          f"{variant}_2p1")
        more = copy.deepcopy(full)
        more["model"]["continue_train"] = True
        out[(variant, "2+1")] = _train_pair(more, variant, str(tmp),
                                            f"{variant}_2p1")
    ev = copy.deepcopy(cfg)
    ev["loss"]["just_evaluate"] = True
    out["just_evaluate"] = _train_pair(ev, "gbmlr", str(tmp), "evaluate")
    return out


def _agree(j, p):
    assert p.n_trees == j.n_trees
    np.testing.assert_allclose(p.per_tree_loss, j.per_tree_loss, rtol=RTOL)
    np.testing.assert_allclose(p.train_loss, j.train_loss, rtol=RTOL)
    np.testing.assert_allclose(p.test_loss, j.test_loss, rtol=RTOL)
    assert set(p.test_metrics) == set(j.test_metrics) == {"auc"}
    assert abs(p.test_metrics["auc"] - j.test_metrics["auc"]) <= 1e-4


@pytest.mark.parametrize("variant,typ", RUNS)
def test_trainer_matches_jax(variant, typ, runs):
    r = runs[(variant, typ)]
    (jres, jfirst, _), (pres, pfirst, pdir) = r["jax"], r["port"]
    for a, b in zip(jfirst, pfirst):  # first tree: w0, gate mask, weights
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 0.0 < pfirst[1].mean() < 1.0 and 0.0 < (pfirst[2] == 0).mean()
    _agree(jres, pres)
    assert len(pres.per_tree_loss) == 3
    assert pres.per_tree_iter == [6, 6, 6]
    assert pres.test_metrics["auc"] > 0.6
    for t in range(3):
        assert os.path.exists(f"{pdir}/tree-{t:05d}/model-00000")
    with open(f"{pdir}/tree-info") as f:
        assert "finished_tree_num:3\n" in f.read()


@pytest.mark.parametrize("variant", VARIANTS)
def test_dumps_of_the_same_weights_byte_identical(variant, runs):
    """The port's trained tree 1 loaded by both packages, dumped by both
    with the same gate mask: the tree text and the tree-info match byte
    for byte, and each package reads back the other's weights bit-equal."""
    r = runs[(variant, "gradient_boosting")]
    cfg = _cfg(os.path.join(runs["dir"], "dump_" + variant))
    ing = DataIngest(PParams.from_config(cfg)).load()
    jm, pm = _pair(cfg, ing, variant)
    jm.params.model.data_path = pm.params.model.data_path = r["port"][2]
    w = pm.load_tree(PFS(), ing.feature_map, 1)
    assert np.array_equal(w, jm.load_tree(JFS(), ing.feature_map, 1))
    gm = np.ones(pm.n_features, np.float32)
    gm[1::3] = 0.0
    texts = []
    for m, fs, who in ((jm, JFS(), "j"), (pm, PFS(), "p")):
        m.params.model.data_path = os.path.join(runs["dir"], variant + who)
        m.dump_tree(fs, w, gm, ing.feature_map, 4)
        m.dump_tree_info(fs, 5, 0.25)
        d = m.params.model.data_path
        with open(f"{d}/tree-00004/model-00000") as f, \
                open(f"{d}/tree-info") as g, \
                open(f"{d}_dict/dict-00000") as h:
            texts.append((f.read(), g.read(), h.read()))
    assert texts[0] == texts[1]
    assert texts[0][0].startswith("k:4\n")
    assert texts[0][0].splitlines()[-1].endswith(",")
    back = pm.load_tree(PFS(), ing.feature_map, 4)
    assert np.array_equal(back, jm.load_tree(JFS(), ing.feature_map, 4))


def _tree_texts(d, n):
    out = []
    for t in range(n):
        with open(f"{d}/tree-{t:05d}/model-00000") as f:
            out.append(f.read())
    return out


@pytest.mark.parametrize("variant", RESUMED)
def test_continue_train_reproduces_the_full_run(variant, runs):
    full, resumed = runs[(variant, "3")], runs[(variant, "2+1")]
    for who in ("jax", "port"):
        assert _tree_texts(full[who][2], 3) == \
            _tree_texts(resumed[who][2], 3)
        assert resumed[who][0].n_trees == 3
        assert len(resumed[who][0].per_tree_loss) == 1
    _agree(resumed["jax"][0], resumed["port"][0])
    _agree(full["jax"][0], full["port"][0])
    np.testing.assert_allclose(resumed["port"][0].train_loss,
                               full["port"][0].train_loss, rtol=1e-6)


def test_just_evaluate_stops_after_one_fit(runs):
    (jres, _, _), (pres, _, _) = runs["just_evaluate"]["jax"], \
        runs["just_evaluate"]["port"]
    assert pres.per_tree_iter == [0]
    assert pres.per_tree_status == ["callback_stop"]
    np.testing.assert_allclose(pres.per_tree_loss, jres.per_tree_loss,
                               rtol=RTOL)
    np.testing.assert_allclose(pres.train_loss, jres.train_loss, rtol=RTOL)


def test_trainer_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pboost.GBSTTrainer(PParams(), "gbmlr")


def test_hier_variants_need_a_power_of_two(data):
    cfg, ing = data
    c = copy.deepcopy(cfg)
    c["k"] = 6
    with pytest.raises(ValueError, match="power of two"):
        GBSTModel(PParams.from_config(c), ing.train.dim, "gbhsdt",
                  device="cpu")
