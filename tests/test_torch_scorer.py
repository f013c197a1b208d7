"""The port's CompiledScorer (device="cpu") against the JAX CompiledScorer.

GBDT: same model text, same request rows: the port's stacked and fused
rungs must return raw scores bit-equal to the JAX stacked rung, the JAX
fused rung under the Pallas interpreter, and GBDTPredictor.batch_scores.
Activated predictions go through torch.sigmoid versus jax.nn.sigmoid,
which may differ in the last ulp, so they are held at rtol=1e-14.

Every other family `cli train` writes (linear, multiclass_linear, FM,
FFM, the four GBST variants; tests/serve_models.py writes the model
files and each package loads them itself): the f64 rung against the
port's host predictor and the JAX scorer at the reference's bounds, the
bf16 rung against the JAX bf16 rung within torch_bf16_bound.py's stated
bound.
"""

import numpy as np
import pytest
import torch

from serve_models import build_ffm, build_fm, build_gbdt, build_gbst, \
    build_linear, build_multiclass, request_rows
from torch_bf16_bound import bf16_bound, bf16_round
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.tree import Tree as JTree
from ytklearn_tpu.predict import create_predictor as jax_create_predictor
from ytklearn_tpu.serve import CompiledScorer as JaxScorer
from ytklearn_tpu_torch.predict import GBSTPredictor, create_predictor
from ytklearn_tpu_torch.serve import CompiledScorer, parse_ladder

LADDER = (4, 32)
BATCHES = (0, 1, 3, 4, 5, 33, 70)


def _port_predictor(path, **opt):
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": "sigmoid", **opt}}
    return create_predictor("gbdt", cfg)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_scorer")
    jpred, names = build_gbdt(tmp, n_trees=13, depth=4)
    pred = _port_predictor(tmp / "gbdt.model")
    jax_scorers = {
        "stacked": JaxScorer(jpred, ladder=LADDER),
        "fused": JaxScorer(jpred, ladder=LADDER, mode="fused",
                           fused_interpret=True),
    }
    assert jax_scorers["fused"].rung_info()["mode"] == "fused"
    return jpred, pred, names, jax_scorers


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("mode", ["stacked", "fused"])
def test_scores_bit_equal_to_jax(case, mode, n):
    jpred, pred, names, jax_scorers = case
    rows = request_rows(n, np.random.RandomState(100 + n), names)
    scorer = CompiledScorer(pred, ladder=LADDER, mode=mode, device="cpu")
    assert scorer.rung_info()["mode"] == mode
    s, p = scorer.score_and_predict(rows)
    want = jpred.batch_scores(rows)
    assert s.shape == want.shape == (n,)
    assert np.array_equal(s, want)
    assert np.array_equal(pred.batch_scores(rows), want)
    for jm in ("stacked", "fused"):
        js, jp = jax_scorers[jm].score_and_predict(rows)
        assert np.array_equal(s, js)
        np.testing.assert_allclose(p, jp, rtol=1e-14, atol=0)
    np.testing.assert_allclose(p, jpred.batch_predicts(rows), rtol=1e-14,
                               atol=0)


def test_host_predictor_api_matches_jax(case):
    """score/scores/predict/predicts/predict_leaf and the batch helpers of
    the host predictor, row by row against the JAX predictor."""
    jpred, pred, names, _ = case
    rows = request_rows(12, np.random.RandomState(8), names)
    assert (pred.K, pred.n_outputs, pred.use_rounds) == \
        (jpred.K, jpred.n_outputs, jpred.use_rounds)
    for r in rows:
        assert pred.score(r) == jpred.score(r)
        assert pred.scores(r) == jpred.scores(r)
        assert pred.predict_leaf(r) == jpred.predict_leaf(r)
        np.testing.assert_allclose(pred.predict(r), jpred.predict(r),
                                   rtol=1e-14, atol=0)
        np.testing.assert_allclose(pred.predicts(r), jpred.predicts(r),
                                   rtol=1e-14, atol=0)
    np.testing.assert_allclose(pred.batch_predicts(rows),
                               jpred.batch_predicts(rows), rtol=1e-14, atol=0)


def test_missing_and_boundary_rows(case):
    """Absent features, explicit NaN, values exactly at split thresholds,
    +-inf, and an unknown feature with a non-numeric value."""
    jpred, pred, _names, _ = case
    rows = [{}, {"c0": float("nan")}, {"c1": float("inf")},
            {"c2": float("-inf")}, {"unknown": "not-a-number", "c3": 0.5}]
    for t in pred.model.trees:
        for nid in range(t.n_nodes()):
            if not t.is_leaf(nid):
                rows.append({t.feat_name[nid]: float(t.split[nid])})
    want = jpred.batch_scores(rows)
    for mode in ("stacked", "fused"):
        scorer = CompiledScorer(pred, ladder=LADDER, mode=mode, device="cpu")
        assert np.array_equal(scorer.score_batch(rows), want)


def _write(tmp_path, model, name="m.model"):
    path = tmp_path / name
    path.write_text(model.dumps())
    return path


@pytest.mark.parametrize("gbdt_type,round_num", [
    ("random_forest", 50), ("gradient_boosting", 7), ("random_forest", 4),
])
def test_rf_divide_and_use_rounds_match_jax(tmp_path, gbdt_type, round_num):
    jpred, names = build_gbdt(tmp_path, n_trees=11, depth=3, base=0.125)
    cfg = {"model": {"data_path": str(tmp_path / "gbdt.model")},
           "type": gbdt_type,
           "optimization": {"loss_function": "sigmoid",
                            "round_num": round_num}}
    jpred = jax_create_predictor("gbdt", cfg)
    pred = create_predictor("gbdt", cfg)
    assert pred.use_rounds == jpred.use_rounds
    rows = request_rows(37, np.random.RandomState(3), names)
    want = jpred.batch_scores(rows)
    for mode in ("stacked", "fused"):
        scorer = CompiledScorer(pred, ladder=LADDER, mode=mode, device="cpu")
        got = scorer.score_batch(rows)
        assert np.array_equal(got, want)
        js = JaxScorer(jpred, ladder=LADDER, mode=mode, fused_interpret=True)
        if gbdt_type == "random_forest":
            # XLA rewrites the jitted `s / rounds` as `s * (1 / rounds)`,
            # so the JAX rungs drift one ulp from the host walk's true
            # divide, which the port keeps
            np.testing.assert_array_max_ulp(got, js.score_batch(rows), 1)
        else:
            assert np.array_equal(got, js.score_batch(rows))


def test_identity_loss_predictions_equal_scores(tmp_path):
    build_gbdt(tmp_path, n_trees=4, depth=2)
    cfg = {"model": {"data_path": str(tmp_path / "gbdt.model")},
           "optimization": {"loss_function": "l2"}}
    pred = create_predictor("gbdt", cfg)
    rows = request_rows(9, np.random.RandomState(4), [f"c{i}" for i in range(6)])
    s, p = CompiledScorer(pred, ladder=LADDER, mode="fused",
                          device="cpu").score_and_predict(rows)
    assert np.array_equal(s, p)
    assert np.array_equal(s, jax_create_predictor("gbdt", cfg).batch_scores(rows))


def _deep_model(depth):
    t = JTree()
    nid = 0
    for i in range(depth):
        t.feat[nid] = 0
        t.feat_name[nid] = "c0"
        t.split[nid] = float(depth - i)
        t.leaf_value[t.add_children(nid)[1]] = float(i)
        nid = t.left[nid]
    t.leaf_value[nid] = -1.0
    return JModel(base_prediction=0.5, trees=[t])


def _multiclass_model(seed):
    jpred_trees = []
    rng = np.random.RandomState(seed)
    for k in range(6):
        t = JTree()
        t.feat[0] = 0
        t.feat_name[0] = f"c{k % 3}"
        t.split[0] = float(rng.randn())
        left, right = t.add_children(0)
        t.leaf_value[left] = float(rng.randn())
        t.leaf_value[right] = float(rng.randn())
        jpred_trees.append(t)
    return JModel(base_prediction=0.0, num_tree_in_group=3, obj_name="l2",
                  trees=jpred_trees)


@pytest.mark.parametrize("shape", ["too_deep", "multiclass"])
def test_fused_refusals_match_jax(tmp_path, shape):
    """Ensembles the heap layout cannot take serve on the stacked rung,
    with the reason named, exactly where the JAX scorer downgrades."""
    model = _deep_model(11) if shape == "too_deep" else _multiclass_model(5)
    path = _write(tmp_path, model)
    loss = "sigmoid" if shape == "too_deep" else "l2"
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": loss}}
    jpred = jax_create_predictor("gbdt", cfg)
    pred = create_predictor("gbdt", cfg)
    js = JaxScorer(jpred, ladder=LADDER, mode="fused", fused_interpret=True)
    scorer = CompiledScorer(pred, ladder=LADDER, mode="fused", device="cpu")
    info, jinfo = scorer.rung_info(), js.rung_info()
    assert (info["mode"], info["downgraded"]) == ("stacked", True)
    assert (jinfo["mode"], jinfo["downgraded"]) == ("stacked", True)
    assert ("depth 11 > heap cap 10" if shape == "too_deep"
            else "K > 1") in info["reason"]
    rows = [{"c0": float(v), "c1": 0.3, "c2": -0.2}
            for v in np.linspace(-2, 12, 23)] + [{}]
    s = scorer.score_batch(rows)
    assert s.shape == jpred.batch_scores(rows).shape
    assert np.array_equal(s, jpred.batch_scores(rows))
    assert np.array_equal(s, js.score_batch(rows))


def test_binned_rung_refused(tmp_path):
    """A model too deep for the heap layout refuses the binned rung as the
    JAX scorer does: it serves stacked, and rung_info() names the
    binned_to_stacked downgrade and its reason."""
    path = _write(tmp_path, _deep_model(11))
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": "sigmoid"}}
    scorer = CompiledScorer(create_predictor("gbdt", cfg), ladder=LADDER,
                            mode="binned", device="cpu")
    info = scorer.rung_info()
    assert (info["requested"], info["mode"], info["downgraded"]) == \
        ("binned", "stacked", True)
    assert info["downgrade"] == "binned_to_stacked"
    assert "depth 11 > heap cap 10" in info["reason"]
    js = JaxScorer(jax_create_predictor("gbdt", cfg), ladder=LADDER,
                   mode="binned")
    assert js.rung_info()["mode"] == "stacked"


def test_knobs_pick_the_rung(case, monkeypatch):
    _jpred, pred, _names, _ = case
    monkeypatch.setenv("YTK_SERVE_FUSED", "1")
    monkeypatch.setenv("YTK_SERVE_LADDER", "2,16")
    scorer = CompiledScorer(pred, device="cpu")
    assert scorer.rung_info()["mode"] == "fused"
    assert scorer.ladder == (2, 16)
    monkeypatch.setenv("YTK_SERVE_PRECISION", "f16")
    with pytest.raises(ValueError, match="precision"):
        CompiledScorer(pred, device="cpu")


def test_gbdt_scores_in_f64_whatever_the_precision_knob(case, monkeypatch):
    jpred, pred, names, _ = case
    rows = request_rows(9, np.random.RandomState(3), names)
    monkeypatch.setenv("YTK_SERVE_PRECISION", "bf16")
    for mode in ("stacked", "fused"):
        scorer = CompiledScorer(pred, ladder=LADDER, mode=mode, device="cpu")
        assert scorer.rung_info()["precision"] == "f64"
        assert np.array_equal(scorer.score_batch(rows),
                              jpred.batch_scores(rows))


def test_no_device_raises_without_cuda(case, monkeypatch):
    """An entry point with no device asks for CUDA; where none is present it
    raises instead of scoring on the CPU."""
    _jpred, pred, _names, _ = case
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledScorer(pred, ladder=LADDER)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        CompiledScorer(pred, ladder=LADDER, device="cuda")


def test_parse_ladder(monkeypatch):
    assert parse_ladder("64,1,8,64") == (1, 8, 64)
    monkeypatch.setenv("YTK_SERVE_LADDER", "2,32")
    assert parse_ladder() == (2, 32)
    monkeypatch.delenv("YTK_SERVE_LADDER")
    assert parse_ladder() == (1, 8, 64, 512)
    with pytest.raises(ValueError):
        parse_ladder("0,4")


def test_unported_families_name_their_roadmap_item(tmp_path):
    """gbmlr, refused until ROADMAP.md item 1.10 ported it, now loads as a
    GBSTPredictor and serves; an unknown name still raises."""
    jpred, _names = build_gbst(tmp_path, "gbmlr")
    pred = create_predictor("gbmlr", jpred.config)
    assert isinstance(pred, GBSTPredictor)
    assert (pred.K, pred.n_trees, pred.stride) == (4, 2, 7)
    with pytest.raises(ValueError, match="unknown model name"):
        create_predictor("nope", {"model": {"data_path": "x"}})


# -- every family cli train writes --------------------------------------------
# The f64 rung against the port's host predictor and the JAX CompiledScorer
# (x64 on, as the suite's conftest sets it) at the JAX package's own bounds
# (tests/test_serve_scorer.py:26-42): scores rtol 1e-10, atol 1e-12 (f64
# sums in another order than the host loop), predictions rtol 1e-9.

FAMILY_BUILDERS = {
    "linear": build_linear,
    "multiclass_linear": build_multiclass,
    "fm": build_fm,
    "ffm": build_ffm,
    "gbmlr": lambda t: build_gbst(t, "gbmlr"),
    "gbsdt": lambda t: build_gbst(t, "gbsdt"),
    "gbhmlr": lambda t: build_gbst(t, "gbhmlr", K=8, n_trees=3),
    "gbhsdt": lambda t: build_gbst(t, "gbhsdt", K=8, n_trees=3),
}
FAMILY_LADDER = (1, 4, 16)


def _family(tmp_path, family, **cfg):
    jpred, names = FAMILY_BUILDERS[family](tmp_path)
    if cfg:
        from ytklearn_tpu.predict import create_predictor as jcreate
        jpred = jcreate(family, {**jpred.config, **cfg})
    return jpred, create_predictor(family, jpred.config), names


@pytest.mark.parametrize("n", [1, 5, 23, 40])
@pytest.mark.parametrize("family", list(FAMILY_BUILDERS))
def test_family_f64_rung_matches_host_and_jax(tmp_path, family, n):
    jpred, pred, names = _family(tmp_path, family)
    rows = request_rows(n, np.random.RandomState(20 + n), names)
    scorer = CompiledScorer(pred, ladder=FAMILY_LADDER, precision="f64",
                            device="cpu")
    info = scorer.rung_info()
    assert (info["mode"], info["precision"], info["downgraded"]) == \
        ("stacked", "f64", False)
    s, p = scorer.score_and_predict(rows)
    host = pred.batch_scores(rows)
    assert s.shape == host.shape == np.asarray(jpred.batch_scores(rows)).shape
    np.testing.assert_allclose(s, host, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(host, jpred.batch_scores(rows), rtol=1e-10,
                               atol=1e-12)
    js, jp = JaxScorer(jpred, ladder=FAMILY_LADDER,
                       precision="f64").score_and_predict(rows)
    np.testing.assert_allclose(s, js, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(p, pred.batch_predicts(rows), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(p, jp, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("family", ["gbmlr", "gbsdt", "gbhmlr", "gbhsdt"])
def test_gbst_host_predictor_matches_jax(tmp_path, family):
    """score/predict/predict_leaf row by row against the JAX predictor,
    with random_forest's divide and a fleet-wide binned knob that is no
    downgrade for GBST."""
    for typ in ("gradient_boosting", "random_forest"):
        jpred, pred, names = _family(tmp_path / typ, family, type=typ)
        rows = request_rows(15, np.random.RandomState(5), names)
        for r in rows:
            np.testing.assert_allclose(pred.score(r), jpred.score(r),
                                       rtol=1e-12, atol=1e-14)
            np.testing.assert_allclose(pred.predict(r), jpred.predict(r),
                                       rtol=1e-12, atol=1e-14)
            assert pred.predict_leaf(r) == jpred.predict_leaf(r)
        scorer = CompiledScorer(pred, ladder=FAMILY_LADDER, mode="binned",
                                device="cpu")
        info = scorer.rung_info()
        assert (info["requested"], info["mode"], info["downgraded"]) == \
            ("stacked", "stacked", False)
        np.testing.assert_allclose(scorer.score_batch(rows),
                                   jpred.batch_scores(rows), rtol=1e-10,
                                   atol=1e-12)


# -- the bf16 rung --------------------------------------------------------------
# The stated bound of torch_bf16_bound.py: the port and the JAX rung differ
# only in the order of their f32 sums, plus, for FFM, XLA squaring the bf16
# X in f32 where the JAX source and the port round X * X to bf16.

CONVEX = ["linear", "multiclass_linear", "fm", "ffm"]


@pytest.mark.parametrize("family", CONVEX)
def test_bf16_rung_matches_jax_within_the_stated_bound(tmp_path, family):
    jpred, pred, names = _family(tmp_path, family)
    rows = request_rows(32, np.random.RandomState(9), names,
                        extra_unknown=False)
    s16 = CompiledScorer(pred, ladder=(32,), precision="bf16", device="cpu")
    s64 = CompiledScorer(pred, ladder=(32,), precision="f64", device="cpu")
    assert s16.rung_info()["precision"] == "bf16"
    got, p16 = s16.score_and_predict(rows)
    js = JaxScorer(jpred, ladder=(32,), precision="bf16")
    want = js.score_batch(rows)
    bound = bf16_bound(family, pred, s16, s16.featurize(rows),
                       xla_square=True)
    if family == "multiclass_linear":  # the implicit class is 0 in both
        assert np.all(got[:, -1] == 0.0) and np.all(want[:, -1] == 0.0)
        got, want = got[:, :-1], want[:, :-1]
    assert np.all(np.abs(got - want) <= bound)
    # an f32 result, not a bf16 one
    assert np.any(got != bf16_round(got))
    # the reference's band against the f64 rung (tests/test_serve_kernels
    # .py: test_bf16_band_per_family)
    band = float(np.max(np.abs(p16 - s64.predict_batch(rows))))
    assert 0.0 < band < 0.1


@pytest.mark.parametrize("family", ["gbmlr", "gbhsdt"])
def test_gbst_serves_f64_whatever_the_precision_knob(tmp_path, family,
                                                      monkeypatch):
    jpred, pred, names = _family(tmp_path, family)
    monkeypatch.setenv("YTK_SERVE_PRECISION", "bf16")
    scorer = CompiledScorer(pred, ladder=FAMILY_LADDER, device="cpu")
    assert scorer.rung_info()["precision"] == "f64"
    rows = request_rows(9, np.random.RandomState(2), names)
    np.testing.assert_allclose(scorer.score_batch(rows),
                               pred.batch_scores(rows), rtol=1e-10,
                               atol=1e-12)


def test_featurize_is_prep_row_row_by_row(tmp_path):
    """The full stage's dense rows hold each row's prep_row items at their
    vocab columns (the bias column at 1, absent features 0), for a model
    without hashing or transform; hashed and transformed models:
    tests/test_torch_continuous_predict.py."""
    _jpred, pred, names = _family(tmp_path, "fm")
    rows = request_rows(30, np.random.RandomState(4), names) + [
        {"_bias_": 5.0, "c1": 2.0}, {}, {"unknown": "x", "c0": 1.5}]
    scorer = CompiledScorer(pred, ladder=FAMILY_LADDER, device="cpu")
    X = scorer.featurize(rows)
    for i, r in enumerate(rows):
        want = np.zeros(scorer.dim)
        for n, v in pred._prep({k: v for k, v in r.items()
                                if k != "unknown"}):
            if n in scorer.vocab:
                want[scorer.vocab[n]] += v
        want[scorer._bias_col] = 1.0
        assert np.array_equal(X[i], want)
