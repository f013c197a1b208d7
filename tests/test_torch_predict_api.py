"""Every host predictor's API against the JAX package's predictor on the
same model files and rows: score, scores, predict, predicts and
loss_value, with `other` (the sample-dependent base prediction) given and
not given, for every family `cli train` writes, softmax GBDT (K = 3)
included; and the public helpers that ride with them: GBDTModel.
predict_scores and Tree.predict, TransformPipeline.transform_scalar with
ContinuousPredictor._transform, and DataIngest.load_transform_sidecar.

Tolerances are those of tests/test_torch_scorer.py: GBDT raw scores equal,
its activated values at rtol 1e-14 (torch against jax elementwise
functions, the last ulp); the other families' scores and predictions at
rtol 1e-12, atol 1e-14 (float64 sums in another order). Losses take the
same bounds as the values they are computed from. The dense-matrix GBDT
scores and the replayed transforms are exact.
"""

import copy

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import build_ffm, build_fm, build_gbdt, build_gbst, \
    build_linear, build_multiclass, request_rows
from test_torch_continuous_predict import cases  # noqa: F401 (fixture)
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.tree import Tree as JTree
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.io.reader import DataIngest as JIngest
from ytklearn_tpu.predict import create_predictor as jcreate
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.gbdt.tree import GBDTModel
from ytklearn_tpu_torch.io.fs import LocalFileSystem as PFS
from ytklearn_tpu_torch.io.reader import DataIngest as PIngest
from ytklearn_tpu_torch.predict import create_predictor

K_SOFTMAX = 3


def _softmax_gbdt(tmp_path, seed=11, rounds=4):
    """A K = 3 softmax ensemble: `rounds` groups of three depth-2 trees."""
    rng = np.random.RandomState(seed)
    trees = []
    for _ in range(rounds * K_SOFTMAX):
        t = JTree()
        t.feat[0] = int(rng.randint(8))
        t.feat_name[0] = f"c{t.feat[0]}"
        t.split[0] = float(rng.randn())
        t.default_left[0] = bool(rng.rand() < 0.5)
        for child in t.add_children(0):
            if rng.rand() < 0.6:
                t.feat[child] = int(rng.randint(8))
                t.feat_name[child] = f"c{t.feat[child]}"
                t.split[child] = float(rng.randn())
                for leaf in t.add_children(child):
                    t.leaf_value[leaf] = float(rng.randn() * 0.3)
            else:
                t.leaf_value[child] = float(rng.randn() * 0.3)
        trees.append(t)
    model = JModel(base_prediction=0.0, num_tree_in_group=K_SOFTMAX,
                   obj_name="softmax", trees=trees)
    path = tmp_path / "softmax.model"
    path.write_text(model.dumps())
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": "softmax",
                            "class_num": K_SOFTMAX}}
    return jcreate("gbdt", cfg), [f"c{i}" for i in range(8)]


BUILDERS = {
    "linear": build_linear,
    "multiclass_linear": build_multiclass,
    "fm": build_fm,
    "ffm": build_ffm,
    "gbmlr": lambda t: build_gbst(t, "gbmlr"),
    "gbsdt": lambda t: build_gbst(t, "gbsdt"),
    "gbhmlr": lambda t: build_gbst(t, "gbhmlr", K=8, n_trees=3),
    "gbhsdt": lambda t: build_gbst(t, "gbhsdt", K=8, n_trees=3),
    "gbdt": lambda t: build_gbdt(t, n_trees=9, depth=4),
    "gbdt_softmax": _softmax_gbdt,
}
#: families whose score takes `other` (the others ignore it)
TAKES_OTHER = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt", "gbdt", "gbdt_softmax")


def _close(family, got, want):
    if family.startswith("gbdt"):
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def _pair(tmp_path, family):
    jpred, names = BUILDERS[family](tmp_path)
    kind = "gbdt" if family.startswith("gbdt") else family
    return jpred, create_predictor(kind, jpred.config), names


def _labels(rng, K, n):
    if K == 1:
        return [float(v) for v in rng.randint(0, 2, n)]
    return [list(np.eye(K)[c]) for c in rng.randint(0, K, n)]


def _others(rng, family, K, n):
    if family not in TAKES_OTHER:
        return [None] * n
    p = rng.uniform(0.05, 0.95, size=(n, K))
    if family == "gbdt_softmax":
        return [list(r) for r in p]
    return [float(r[0]) for r in p]


@pytest.mark.parametrize("with_other", [False, True])
@pytest.mark.parametrize("family", list(BUILDERS))
def test_predictor_api_matches_jax(tmp_path, family, with_other):
    """score/scores, predict/predicts and loss_value row by row; where the
    JAX predictor refuses a call (a multi-output family's score or
    predict), the port refuses it with the same exception type."""
    jpred, pred, names = _pair(tmp_path, family)
    K = jpred.n_outputs
    assert pred.n_outputs == K
    rng = np.random.RandomState(17 + len(family))
    rows = request_rows(11, rng, names)
    labels = _labels(rng, K, len(rows))
    others = (_others(rng, family, K, len(rows)) if with_other
              else [None] * len(rows))
    for r, y, o in zip(rows, labels, others):
        _close(family, pred.scores(r, o), jpred.scores(r, o))
        _close(family, pred.predicts(r, o), jpred.predicts(r, o))
        _close(family, pred.loss_value(r, y, o), jpred.loss_value(r, y, o))
        for name in ("score", "predict"):
            try:
                want = getattr(jpred, name)(r, o)
            except ValueError:
                with pytest.raises(ValueError):
                    getattr(pred, name)(r, o)
                continue
            _close(family, getattr(pred, name)(r, o), want)
        if family == "gbdt":
            assert pred.score(r, o) == jpred.score(r, o)
    if family == "gbdt_softmax":
        # the K activated values sum to one; each loss is the softmax
        # cross-entropy of the K scores against the one-hot label
        p = pred.predicts(rows[0])
        assert len(p) == K and abs(sum(p) - 1.0) < 1e-12
        s = np.asarray(pred.scores(rows[0]))
        want = np.log(np.exp(s - s.max()).sum()) - \
            (s - s.max())[int(np.argmax(labels[0]))]
        np.testing.assert_allclose(pred.loss_value(rows[0], labels[0]), want,
                                   rtol=1e-12)


@pytest.mark.parametrize("family", ["gbdt", "gbdt_softmax"])
def test_gbdt_dense_scores_match_jax(tmp_path, family):
    """GBDTModel.predict_scores and each Tree.predict over a dense matrix
    with NaN (the default child), bit-equal to the JAX package's."""
    jpred, pred, names = _pair(tmp_path, family)
    text = open(jpred.params.model.data_path).read()
    jm, pm = JModel.loads(text), GBDTModel.loads(text)
    rng = np.random.RandomState(5)
    X = rng.randn(300, max(len(names), 8)).astype(np.float32)
    X[rng.rand(*X.shape) < 0.2] = np.nan
    for jt, pt in zip(jm.trees, pm.trees):
        # the trees address features by index; the hand-built ones by name
        pt.feat = jt.feat = [int(n[1:]) if n else -1 for n in jt.feat_name]
        got, want = pt.predict(X), jt.predict(X)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = pm.predict_scores(X), jm.predict_scores(X)
    assert got.shape == want.shape == ((300,) if jm.num_tree_in_group == 1
                                       else (300, K_SOFTMAX))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["linear", "multiclass_linear"])
def test_transform_scalar_matches_jax(cases, name):  # noqa: F811
    """One feature's replay: every sidecar name, names without a node (0
    with the transform on) and the bias, through the port's pipeline and
    its predictor's _transform, against the JAX predictor's _transform."""
    c = cases[name]
    jpred = jcreate(c["family"], c["cfgs"]["jax"])
    pred = create_predictor(c["family"], c["cfgs"]["port"])
    names = sorted(jpred.transform_nodes) + ["unknown", "_bias_"]
    assert sorted(pred.transform_nodes) == sorted(jpred.transform_nodes)
    for i, nm in enumerate(names):
        for v in (-2.5, 0.0, 0.75 * i, 1e6):
            want = jpred._transform(nm, v)
            assert pred._transform(nm, v) == want
            assert pred.pipeline.transform_scalar(nm, v) == want


@pytest.mark.parametrize("name", ["linear", "multiclass_linear", "fm"])
def test_load_transform_sidecar_matches_jax(cases, name):  # noqa: F811
    """The sidecar read back over one feature map, in both packages: the
    same indices and nodes ({} when the model has no sidecar)."""
    c = cases[name]
    fmap = {}
    for pkg, Params, Ingest in (("jax", JParams, JIngest),
                                ("port", PParams, PIngest)):
        cfg = copy.deepcopy(c["cfgs"][pkg])
        ing = Ingest(Params.from_config(cfg), fs=JFS() if pkg == "jax"
                     else PFS())
        if not fmap:
            names = sorted({n for r in c["rows"] for n in r})
            fmap = {n: i for i, n in enumerate(names)}
        got = ing.load_transform_sidecar(fmap)
        if pkg == "jax":
            want = got
            continue
        assert sorted(got) == sorted(want)
        assert all(str(got[i]) == str(want[i]) for i in want)
        assert bool(want) == (name != "fm")
