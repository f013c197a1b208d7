"""The port's GBDT text ingest against the JAX package's, on the Python
parser of both (YTK_NO_NATIVE=1 for the port; the native paths are held
together in tests/test_torch_native_ingest.py).

Both read the same seeded ytklearn-format files (`weight###label###name:val,
...`, dense and Higgs-like) written by the test, through the same config,
and must return identical X (NaN-aware), y, weight, n_real, feature names
and missing-value fill for `value@0`, `mean` and `quantile@0.5`. The lines
carry: features missing at random, one malformed line (under
max_error_tol) that names a feature no other line has, a duplicate feature
in one line (the last value wins), a feature only the test file has (it is
skipped), and training data split over a directory of two files (read in
sorted order).
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.gbdt.data import GBDTIngest as JIngest
from ytklearn_tpu.io import native as jnative
from ytklearn_tpu_torch.config.params import GBDTParams
from ytklearn_tpu_torch.gbdt.data import GBDTIngest
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.io.reader import parse_line, shard_plan

F = 8


def _lines(rng, n, names, extra=None):
    out = []
    for _ in range(n):
        x = rng.randn(len(names))
        y = int(x[0] * x[1] + np.sin(2 * x[2]) + rng.randn() * 0.5 > 0)
        order = rng.permutation(len(names))
        feats = [f"{names[j]}:{float(np.float32(x[j]))!r}" for j in order
                 if rng.rand() > 0.1]
        if extra is not None:
            feats.append(f"{extra}:{rng.randn():.6f}")
        w = 1.0 if rng.rand() < 0.8 else 2.5
        out.append(f"{w}###{y}###{','.join(feats)}")
    return out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ingest")
    rng = np.random.RandomState(17)
    names = [f"f{i}" for i in range(F)]
    train = _lines(rng, 700, names)
    train.insert(5, "1###0###fbad:1.0,f1:not-a-number")  # error line
    train.insert(9, "1###1###f2:0.5,f0:1.5,f2:-0.75,f3:2.0")  # duplicate f2
    train.insert(12, "")  # blank lines are skipped, not errors
    d = tmp / "train"
    d.mkdir()
    (d / "part-1").write_text("\n".join(train[400:]) + "\n")
    (d / "part-0").write_text("\n".join(train[:400]) + "\n")
    test = _lines(rng, 300, names, extra="ftest")
    (tmp / "test.txt").write_text("\n".join(test) + "\n")
    return str(d), str(tmp / "test.txt"), str(tmp / "m.model")


def _cfg(files, missing, **data):
    train, test, model = files
    d = {"train": {"data_path": train, "max_error_tol": 1},
         "test": {"data_path": test, "max_error_tol": 0},
         "max_feature_dim": F + 2}
    d.update(data)
    return {"data": d, "model": {"data_path": model},
            "feature": {"missing_value": missing},
            "optimization": {"loss_function": "sigmoid"}}


def _load_both(cfg, monkeypatch):
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    want = JIngest(JParams.from_config(cfg)).load()
    got = GBDTIngest(GBDTParams.from_config(cfg)).load()
    return want, got


def _assert_same(got, want):
    np.testing.assert_array_equal(got.X, want.X)
    np.testing.assert_array_equal(got.y, want.y)
    np.testing.assert_array_equal(got.weight, want.weight)
    assert got.X.dtype == want.X.dtype == np.float32
    assert got.n_real == want.n_real
    assert got.feature_names == want.feature_names
    np.testing.assert_array_equal(got.missing_fill, want.missing_fill)


@pytest.mark.parametrize("missing", ["value@0", "mean", "quantile@0.5"])
def test_load_matches_jax(files, missing, monkeypatch):
    (jtr, jte), (tr, te) = _load_both(_cfg(files, missing), monkeypatch)
    _assert_same(tr, jtr)
    _assert_same(te, jte)
    assert tr.n_real == 701 and te.n_real == 300  # the error line dropped
    assert "fbad" not in tr.feature_names and "ftest" not in tr.feature_names
    assert tr.feature_names[F:] == [str(F), str(F + 1)]  # unclaimed
    assert sorted(tr.feature_names[:F]) == [f"f{i}" for i in range(F)]
    assert not np.isnan(tr.X).any() and not np.isnan(te.X).any()
    row = tr.X[8]  # the duplicate line (after one dropped error line)
    assert row[tr.feature_names.index("f2")] == np.float32(-0.75)
    if missing == "value@0":
        assert (tr.missing_fill == 0).all()


def test_bare_value_fills_zero_and_unknown_strategy_raises(files,
                                                          monkeypatch):
    (jtr, _), (tr, _) = _load_both(_cfg(files, "value"), monkeypatch)
    _assert_same(tr, jtr)
    assert (tr.missing_fill == 0).all()
    with pytest.raises(ValueError, match="unknown missing_value"):
        GBDTIngest(GBDTParams.from_config(_cfg(files, "median"))).load()


def test_error_tolerance_and_feature_overflow(files, monkeypatch):
    """Past max_error_tol the bad line raises; a line that would claim a
    column past max_feature_dim is an error line too."""
    monkeypatch.setattr(jnative, "native_available", lambda: False)
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    cfg = _cfg(files, "value@0")
    cfg["data"]["train"]["max_error_tol"] = 0
    for ingest in (JIngest(JParams.from_config(cfg)),
                   GBDTIngest(GBDTParams.from_config(cfg))):
        with pytest.raises(ValueError, match="could not convert"):
            ingest.load()
    cfg = _cfg(files, "value@0", max_feature_dim=F - 1)
    cfg["data"]["train"]["max_error_tol"] = 10 ** 6
    (jtr, jte), (tr, te) = _load_both(cfg, monkeypatch)
    _assert_same(tr, jtr)
    _assert_same(te, jte)
    assert tr.n_real < 701  # lines that name the eighth feature dropped
    cfg["data"]["train"]["max_error_tol"] = 1
    with pytest.raises(ValueError, match="max_feature_dim"):
        GBDTIngest(GBDTParams.from_config(cfg)).load()


def test_multiclass_labels_expand(files, monkeypatch, tmp_path):
    """K > 1: a class index expands to a one-hot label row."""
    path = tmp_path / "mc.txt"
    path.write_text("1###2###a:1.0\n1###0###a:2.0,b:1.0\n1###0,1,0###b:3\n")
    cfg = _cfg((str(path), "", str(tmp_path / "m")), "value@0",
               max_feature_dim=2)
    cfg["data"]["test"] = {}
    cfg["optimization"] = {"loss_function": "softmax", "class_num": 3}
    (jtr, jte), (tr, te) = _load_both(cfg, monkeypatch)
    _assert_same(tr, jtr)
    assert jte is None and te is None
    np.testing.assert_array_equal(tr.y, [[0, 0, 1], [1, 0, 0], [0, 1, 0]])


def test_parse_line_and_read_plan(tmp_path):
    p = GBDTParams.from_config({"model": {"data_path": "m"}})
    pl = parse_line(" 2.0###1,0###a:1.5, b :-2\n", p.data.delim)
    assert (pl.weight, pl.labels, pl.feats) == (2.0, [1.0, 0.0],
                                                [("a", 1.5), ("b", -2.0)])
    assert parse_line("1###0###", p.data.delim).feats == []
    (tmp_path / "d" / "s").mkdir(parents=True)
    for name, text in (("d/b", "3\n4"), ("d/a", "1\n2\n"), ("d/s/c", "5\n")):
        (tmp_path / name).write_text(text)
    fs = LocalFileSystem()
    d = str(tmp_path / "d")
    assert list(fs.read_lines([d])) == ["1", "2", "3", "4", "5"]
    assert list(fs.select_read_lines([d], 2, 1)) == ["2", "4"]
    assert shard_plan(fs, p.data, [d]) == ([d], 1, 0)
    with pytest.raises(FileNotFoundError):
        fs.recur_get_paths([str(tmp_path / "nope*")])


def test_config_parses_as_jax(monkeypatch):
    """experiment/higgs/local_gbdt.conf gives the same field values."""
    from ytklearn_tpu.config import hocon as jhocon
    from ytklearn_tpu_torch.config import hocon

    path = "experiment/higgs/local_gbdt.conf"
    j = JParams.from_config(jhocon.load(path))
    p = GBDTParams.from_config(hocon.load(path))
    for f in ("train_paths", "train_max_error_tol", "test_paths",
              "test_max_error_tol", "y_sampling", "assigned",
              "unassigned_mode", "max_feature_dim"):
        assert getattr(p.data, f) == getattr(j.data, f), f
    for f in ("x_delim", "y_delim", "features_delim",
              "feature_name_val_delim"):
        assert getattr(p.data.delim, f) == getattr(j.data.delim, f), f
    for f in ("missing_value", "round_num", "max_depth", "max_leaf_cnt",
              "tree_grow_policy", "learning_rate", "l1", "l2",
              "min_child_hessian_sum", "min_split_samples", "loss_function",
              "eval_metric", "split_type", "gbdt_type"):
        assert getattr(p, f) == getattr(j, f), f
    assert [a.__dict__ for a in p.approximate] == \
        [a.__dict__ for a in j.approximate]
    assert (p.model.data_path, p.model.feature_importance_path) == \
        (j.model.data_path, j.model.feature_importance_path)
