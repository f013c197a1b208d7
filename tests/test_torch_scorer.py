"""The port's CompiledScorer (device="cpu") against the JAX CompiledScorer.

Same model text, same request rows: the port's stacked and fused rungs
must return raw scores bit-equal to the JAX stacked rung, the JAX fused
rung under the Pallas interpreter, and GBDTPredictor.batch_scores.
Activated predictions go through torch.sigmoid versus jax.nn.sigmoid,
which may differ in the last ulp, so they are held at rtol=1e-14.
"""

import numpy as np
import pytest
import torch

from serve_models import build_gbdt, request_rows
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.tree import Tree as JTree
from ytklearn_tpu.predict import create_predictor as jax_create_predictor
from ytklearn_tpu.serve import CompiledScorer as JaxScorer
from ytklearn_tpu_torch.predict import create_predictor
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


def test_binned_rung_refused(case):
    _jpred, pred, _names, _ = case
    with pytest.raises(NotImplementedError, match="binned"):
        CompiledScorer(pred, ladder=LADDER, mode="binned", device="cpu")


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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        create_predictor("linear", {"model": {"data_path": "x"}})
    with pytest.raises(ValueError, match="unknown model name"):
        create_predictor("nope", {"model": {"data_path": "x"}})
