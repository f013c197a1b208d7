"""The last reference definitions the port lacked, against the JAX
package's: CommonParams.from_file and GBDTParams.from_file (config/
params.py), EvalSet.format (eval/metrics.py), DataIngest.
build_feature_map (io/reader.py) and LossFunction.check_label with its
overrides (losses.py); and GBDTParams' watch flags (`optimization.
watch_train` / `watch_test`), which the port did not parse: the host
engine's round log then carries each round's metrics as the JAX host
engine's does, and the device engine's sync lines the metrics of its sync
rounds.
"""

import dataclasses
import logging

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import losses as jlosses
from ytklearn_tpu.config import params as jparams
from ytklearn_tpu.eval.metrics import EvalSet as JEvalSet
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu.io import reader as jreader
from ytklearn_tpu_torch import losses
from ytklearn_tpu_torch.config import params
from ytklearn_tpu_torch.eval.metrics import EvalSet
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.io import reader

CONVEX_CONF = """
data {
  train { data_path = "train.txt" }
  test { data_path = "test.txt" }
  delim { x_delim = "###", y_delim = ",", features_delim = ",",
          feature_name_val_delim = ":" }
  max_feature_dim = 77
}
model { data_path = "model.txt", need_bias = true, bias_feature_name = "_b_" }
feature { filter_threshold = 2 }
loss { loss_function = "sigmoid", regularization { l2 = [0.5] } }
optimization { line_search { mode = "wolfe", lbfgs { m = 6 } } }
"""

GBDT_CONF = """
data { train { data_path = "train.txt" }, max_feature_dim = 28 }
model { data_path = "gbdt.model", feature_importance_path = "imp.txt" }
optimization {
  round_num = 7, max_leaf_cnt = 31, tree_grow_policy = "level",
  loss_function = "l2", eval_metric = ["rmse", "mae"],
  watch_train = true, watch_test = true
}
feature { approximate = [{ cols = "default", type = "sample_by_quantile",
                           max_cnt = 255 }] }
"""


def _same_fields(a, b, path=""):
    """Every field the two dataclasses share holds the same value
    (nested dataclasses field by field; `raw` skipped)."""
    names = {f.name for f in dataclasses.fields(a)} & \
        {f.name for f in dataclasses.fields(b)}
    assert names, path
    for name in sorted(names - {"raw"}):
        x, y = getattr(a, name), getattr(b, name)
        if dataclasses.is_dataclass(x):
            _same_fields(x, y, f"{path}.{name}")
        elif isinstance(x, list) and x and dataclasses.is_dataclass(x[0]):
            assert len(x) == len(y), f"{path}.{name}"
            for i, (u, v) in enumerate(zip(x, y)):
                _same_fields(u, v, f"{path}.{name}[{i}]")
        else:
            assert x == y, f"{path}.{name}: {x!r} != {y!r}"


@pytest.mark.parametrize("which", ["common", "gbdt"])
def test_params_from_file_match_jax(tmp_path, which):
    path = tmp_path / f"{which}.conf"
    path.write_text(CONVEX_CONF if which == "common" else GBDT_CONF)
    cls = "CommonParams" if which == "common" else "GBDTParams"
    got = getattr(params, cls).from_file(str(path))
    want = getattr(jparams, cls).from_file(str(path))
    _same_fields(got, want)
    if which == "gbdt":
        assert got.watch_train and got.watch_test and got.round_num == 7
    else:
        assert got.feature.filter_threshold == 2


def test_eval_set_format_matches_jax():
    rng = np.random.RandomState(0)
    pred = rng.rand(400).astype(np.float32)
    y = (rng.rand(400) < pred).astype(np.float32)
    names = ["auc", "rmse", "mae"]
    got_set, want_set = EvalSet(names), JEvalSet(names)
    got = got_set.evaluate(torch.from_numpy(pred), torch.from_numpy(y))
    want = want_set.evaluate(jnp.asarray(pred), jnp.asarray(y))
    for prefix in ("", "train", "[round=3] test"):
        assert got_set.format(want, prefix) == want_set.format(want, prefix)
        text = got_set.format(got, prefix)
        assert text.count("\n") == 2
        assert text.splitlines()[0].startswith(f"{prefix} auc = ")
    assert got_set.format({}) == want_set.format({}) == ""


@pytest.mark.parametrize("need_bias,threshold", [(True, 2), (False, 1),
                                                 (True, 0)])
def test_build_feature_map_matches_jax(tmp_path, need_bias, threshold):
    conf = CONVEX_CONF.replace("need_bias = true",
                               f"need_bias = {str(need_bias).lower()}")
    conf = conf.replace("filter_threshold = 2",
                        f"filter_threshold = {threshold}")
    path = tmp_path / "c.conf"
    path.write_text(conf)
    pp = params.CommonParams.from_file(str(path))
    jp = jparams.CommonParams.from_file(str(path))
    rng = np.random.RandomState(1)
    lines = []
    for i in range(60):
        feats = rng.choice([f"f{k}" for k in range(12)] + ["_b_", "zz"],
                           size=rng.randint(1, 6), replace=False)
        lines.append(f"1###{i % 2}###" + ",".join(
            f"{f}:{rng.rand():.3f}" for f in feats))
    rows = [reader.parse_line(ln, pp.data.delim) for ln in lines]
    jrows = [jreader.parse_line(ln, jp.data.delim) for ln in lines]
    got = reader.DataIngest(pp).build_feature_map(rows)
    want = jreader.DataIngest(jp).build_feature_map(jrows)
    assert got == want
    if need_bias:
        assert got["_b_"] == 0 and got["f0"] == 1
    else:
        assert got["_b_"] == 0 and got["f0"] == 1 and got["zz"] > 1
    assert len(got) > 5


LABELS = {
    "unit": np.array([0.0, 0.25, 1.0]),
    "negative": np.array([0.0, -0.5, 2.0]),
    "above_one": np.array([0.0, 1.5]),
    "one_hot": np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]),
    "soft_rows": np.array([[0.2, 0.7, 0.1], [0.5, 0.5, 0.0]]),
    "bad_rows": np.array([[0.2, 0.7, 0.3], [1.0, 0.0, 0.0]]),
}


@pytest.mark.parametrize("name", sorted(set(losses._SIMPLE)
                                        | {"sigmoid", "huber"}))
def test_check_label_matches_jax(name):
    got_loss = losses.create_loss(name)
    want_loss = jlosses.create_loss(name)
    multi = got_loss.is_multiclass
    assert multi == want_loss.is_multiclass
    seen = set()
    for key, y in LABELS.items():
        if (y.ndim == 2) != multi:
            continue
        got = got_loss.check_label(torch.from_numpy(y.astype(np.float32)))
        want = want_loss.check_label(jnp.asarray(y, jnp.float32))
        assert isinstance(got, bool) and got == want, key
        seen.add(got)
    if name in ("sigmoid", "poisson") or multi:
        assert seen == {True, False}  # an override that refuses some


def _watch_data(n=1500, seed=2):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    y = ((X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.randn(n) * 0.3) > 0)
    return X, y.astype(np.float32)


def test_watch_flags_fill_the_host_engines_round_log(tmp_path):
    """optimization.watch_train/watch_test: the host engine's round log
    holds each round's train and test metrics, as the JAX host engine's
    (metrics of the same f64 scores: within 1e-6)."""
    X, y = _watch_data()
    names = [f"f{i}" for i in range(4)]
    cfg = {"model": {"data_path": str(tmp_path / "m")},
           "optimization": {"round_num": 3, "max_leaf_cnt": 7,
                            "max_depth": 4, "tree_grow_policy": "level",
                            "loss_function": "sigmoid",
                            "eval_metric": ["auc", "rmse"],
                            "watch_train": True, "watch_test": True}}
    pp = params.GBDTParams.from_config(cfg)
    jp = jparams.GBDTParams.from_config(cfg)
    assert pp.watch_train and pp.watch_test
    w = np.ones(1000, np.float32)
    wt = np.ones(500, np.float32)
    pres = GBDTTrainer(pp, device="cpu", engine="host").train(
        GBDTData(X[:1000], y[:1000], w, 1000, names),
        GBDTData(X[1000:], y[1000:], wt, 500, names))
    jres = JTrainer(jp, engine="host").train(
        JData(X[:1000], y[:1000], w, 1000, names),
        JData(X[1000:], y[1000:], wt, 500, names))
    assert len(pres.round_log) == len(jres.round_log) == 3
    for a, b in zip(pres.round_log, jres.round_log):
        for key in ("train_metrics", "test_metrics"):
            assert sorted(a[key]) == sorted(b[key]) == ["auc", "rmse"]
            for m in a[key]:
                np.testing.assert_allclose(a[key][m], b[key][m], rtol=1e-6)


def test_watch_flags_add_metrics_to_the_device_engines_sync_lines(
        tmp_path, caplog):
    X, y = _watch_data()
    names = [f"f{i}" for i in range(4)]
    lines = {}
    for watch in (False, True):
        cfg = {"model": {"data_path": str(tmp_path / f"m{watch}")},
               "optimization": {"round_num": 3, "max_leaf_cnt": 7,
                                "loss_function": "sigmoid",
                                "eval_metric": ["auc"],
                                "watch_train": watch, "watch_test": watch}}
        pp = params.GBDTParams.from_config(cfg)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="ytklearn_tpu_torch.gbdt"):
            GBDTTrainer(pp, device="cpu", hist_precision="int8").train(
                GBDTData(X[:1000], y[:1000], np.ones(1000, np.float32),
                         1000, names),
                GBDTData(X[1000:], y[1000:], np.ones(500, np.float32), 500,
                         names))
        lines[watch] = [r.getMessage() for r in caplog.records
                        if r.getMessage().startswith("[round=")]
    assert len(lines[True]) == len(lines[False]) == 3
    for i, (off, on) in enumerate(zip(lines[False], lines[True])):
        assert " train auc=" not in off
        if i < 2:  # the last round's metrics are the finalized result's
            assert " train auc=" in on and " test auc=" in on
        else:
            assert " train auc=" not in on
