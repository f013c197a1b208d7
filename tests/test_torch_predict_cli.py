"""`cli predict` and `cli convert` of the port against the JAX package's, on
the CPU.

Models of every family are trained by the port (`cli train --device
cpu`, few iterations) and dumped as the reference's model text, which
both predictors read. Each save mode (predict_result_only,
label_and_predict, predict_as_feature) and each predict type (value;
leafid for the tree families) writes result files through both CLIs:
labels, feature text and leaf ids equal exactly, predicted values at rtol
1e-14 (the two frameworks' activations may part in the last ulp), the
printed average loss at rtol 1e-12. The tree families' sample-dependent
base prediction (a fourth column) is held the same way. `cli convert`
writes byte-identical files for the binary, multiclass, regression and
unlabelled libsvm cases.
"""

import contextlib
import copy
import io
import json

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import cli as jcli
from ytklearn_tpu.io.libsvm import convert_libsvm as jconvert
from ytklearn_tpu_torch import cli, obs
from ytklearn_tpu_torch.io.libsvm import convert_libsvm
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
    write_gbst_case

from test_continual import _gbdt_cfg, _write_rows

SAVE_MODES = ("predict_result_only", "label_and_predict",
              "predict_as_feature")
TREES = ("gbdt", "gbmlr", "gbsdt", "gbhmlr", "gbhsdt")
FAMILIES = ("linear", "multiclass_linear", "fm", "ffm") + TREES


def _quiet(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(argv)
    return rc, buf.getvalue().strip().splitlines()[-1]


def _family_case(tmp, family):
    """(config, data file) of a model of `family` trained by the port."""
    if family == "gbdt":
        _write_rows(tmp / "g.train", 400, 4, nonlinear=True)
        _write_rows(tmp / "g.test", 120, 6, nonlinear=True)
        cfg = _gbdt_cfg(tmp, tmp / "model", "g.train", 3)
        cfg["data"]["test"]["data_path"] = str(tmp / "g.test")
        test = tmp / "g.test"
    elif family in TREES:
        cfg = write_gbst_case(str(tmp), 300, 80, 11, K=4, tree_num=2,
                              vocab=60, nnz=6, l2=1e-3, max_iter=4)
        test = tmp / "test.txt"
    else:
        cfg = write_convex_case(str(tmp), family, 300, 80, 11, vocab=60,
                                nnz=6, K=4, n_fields=4, k=3, l2=1e-3,
                                max_iter=5)
        test = tmp / "test.txt"
    cfg["model"]["data_path"] = str(tmp / "model")
    conf = tmp / "train.conf"
    conf.write_text(json.dumps(cfg))
    rc, _ = _quiet(cli.main, ["train", family, str(conf), "--device", "cpu"])
    assert rc == 0
    if family == "gbdt":  # serve every tree the dump holds
        cfg["optimization"]["round_num"] = 0
        conf.write_text(json.dumps(cfg))
    return cfg, conf, test


@pytest.fixture(scope="module", params=FAMILIES)
def model_case(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"predict_{request.param}")
    return (request.param,) + _family_case(tmp, request.param)


def _split(line, save_mode):
    """(exact part, values) of one result line."""
    if save_mode == "predict_result_only":
        return "", [float(v) for v in line.split(",")]
    if save_mode == "label_and_predict":
        label, _, preds = line.partition("###")
        return label, [float(v) for v in preds.split(",")]
    head, _, feats = line.rpartition("###")
    kvs = feats.split(",")
    extra = [kv for kv in kvs if "_label_" in kv]
    rest = [kv for kv in kvs if "_label_" not in kv]
    return (head + "###" + ",".join(rest) + "|"
            + ",".join(kv.split(":")[0] for kv in extra),
            [float(kv.split(":")[1]) for kv in extra])


def _predict_pair(tmp, family, conf, data, extra):
    """Both CLIs over the same data file, each into its own suffix:
    ({who: result lines}, {who: printed JSON})."""
    lines, out = {}, {}
    for who, fn, dev in (("jax", jcli.predict_main, []),
                         ("port", lambda a: cli.main(["predict"] + a),
                          ["--device", "cpu"])):
        rc, last = _quiet(fn, [str(conf), family, str(data), "--suffix",
                               f"_{who}"] + extra + dev)
        assert rc == 0
        out[who] = json.loads(last)
        lines[who] = (data.parent / (data.name + f"_{who}")).read_text() \
            .splitlines()
    return lines, out


@pytest.mark.parametrize("save_mode", SAVE_MODES)
def test_predict_values_equal_the_reference(tmp_path, model_case,
                                            save_mode):
    family, cfg, conf, data = model_case
    lines, out = _predict_pair(tmp_path, family, conf, data,
                               ["--save-mode", save_mode, "--eval-metric",
                                "auc"])
    assert len(lines["port"]) == len(lines["jax"]) > 0
    for a, b in zip(lines["port"], lines["jax"]):
        ea, va = _split(a, save_mode)
        eb, vb = _split(b, save_mode)
        assert ea == eb
        np.testing.assert_allclose(va, vb, rtol=1e-14, atol=0)
    np.testing.assert_allclose(out["port"]["avg_loss"],
                               out["jax"]["avg_loss"], rtol=1e-12)


@pytest.mark.parametrize("save_mode", SAVE_MODES)
def test_predict_leafid_equals_the_reference(tmp_path, model_case,
                                             save_mode):
    family, cfg, conf, data = model_case
    args = [str(conf), family, str(data), "--predict-type", "leafid",
            "--save-mode", save_mode]
    if family not in TREES:
        for fn, extra in ((jcli.predict_main, []),
                          (lambda a: cli.main(["predict"] + a),
                           ["--device", "cpu"])):
            with pytest.raises(ValueError, match="does not support"):
                fn(args + extra)
        return
    lines, _ = _predict_pair(tmp_path, family, conf, data,
                             ["--predict-type", "leafid", "--save-mode",
                              save_mode])
    assert lines["port"] == lines["jax"] and lines["port"]


@pytest.mark.parametrize("family", ["gbdt", "gbmlr"])
def test_sample_dependent_base_equals_the_reference(tmp_path, family):
    cfg, conf, data = _family_case(tmp_path, family)
    if family == "gbdt":
        cfg["optimization"]["sample_dependent_base_prediction"] = True
    else:
        cfg["sample_dependent_base_prediction"] = True
    conf.write_text(json.dumps(cfg))
    rng = np.random.RandomState(3)
    src = data.read_text().splitlines()
    other = tmp_path / "with_base.txt"
    other.write_text("".join(f"{ln}###{rng.uniform(0.05, 0.95):.6f}\n"
                             for ln in src))
    lines, out = _predict_pair(tmp_path, family, conf, other,
                               ["--save-mode", "label_and_predict"])
    plain, _ = _predict_pair(tmp_path, family, conf, data,
                             ["--save-mode", "label_and_predict"])
    for a, b in zip(lines["port"], lines["jax"]):
        ea, va = _split(a, "label_and_predict")
        eb, vb = _split(b, "label_and_predict")
        assert ea == eb
        np.testing.assert_allclose(va, vb, rtol=1e-14, atol=0)
    assert lines["port"] != plain["port"]  # the base column moved them
    np.testing.assert_allclose(out["port"]["avg_loss"],
                               out["jax"]["avg_loss"], rtol=1e-12)


def test_predict_refusals(tmp_path, model_case):
    """`--trace-out`, refused until ROADMAP.md 1.12, now writes a Chrome
    trace of the batch predict that loads and holds its spans, and the
    result files are the ones a run without it writes."""
    family, cfg, conf, data = model_case
    path = tmp_path / "t.json"
    try:
        for who, extra in (("plain", []), ("traced", ["--trace-out",
                                                       str(path)])):
            rc, _ = _quiet(lambda a: cli.main(["predict"] + a),
                           [str(conf), family, str(data), "--suffix",
                            f"_{who}", "--device", "cpu"] + extra)
            assert rc == 0
    finally:
        obs.configure(enabled=False, trace_path=None)
        obs.reset()
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"predict.score_file", "predict.activate"} <= names
    assert (data.parent / (data.name + "_traced")).read_text() == \
        (data.parent / (data.name + "_plain")).read_text()


# -- cli convert ----------------------------------------------------------------

_LIBSVM = {
    "binary": ("binary_classification@-1,+1",
               ["+1 1:0.5 3:1.25 7:2", "-1 2:1 3:0.125", "+1 4:3e-05",
                "", "-1 1:1 2:2 3:3 4:4"]),
    "multiclass": ("multi_classification@a,b,c",
                   ["a 1:1 2:0.5", "c 3:2", "b 1:0.25 5:9", "a 2:1"]),
    "regression": ("regression", ["1.5 1:1 2:2", "-0.25 3:0.5",
                                  "7 1:1e3", "0 2:0"]),
    "unlabelled": ("regression", ["1:1 2:2", "3:0.5 4:1", "2:7"]),
}


@pytest.mark.parametrize("case", sorted(_LIBSVM))
def test_convert_is_byte_identical_to_the_reference(tmp_path, case):
    mode, lines = _LIBSVM[case]
    src = tmp_path / "in.libsvm"
    src.write_text("\n".join(lines) + "\n")
    n = convert_libsvm(mode, str(src), str(tmp_path / "port.txt"))
    assert n == jconvert(mode, str(src), str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    # the CLIs print the same record
    outs = []
    for who, fn in (("jax", jcli.convert_main),
                    ("port", lambda a: cli.main(["convert"] + a))):
        rc, last = _quiet(fn, [mode, str(src), str(tmp_path / "same.txt"),
                               "--features-delim", ";"])
        outs.append((rc, json.loads(last),
                     (tmp_path / "same.txt").read_bytes()))
    assert outs[0] == outs[1]


def test_convert_rejects_as_the_reference(tmp_path):
    src = tmp_path / "in.libsvm"
    src.write_text("z 1:1\n")
    for fn in (convert_libsvm, jconvert):
        with pytest.raises(ValueError, match="unknown label"):
            fn("binary_classification@a,b", str(src), str(tmp_path / "o"))
        with pytest.raises(ValueError, match="needs 2 labels"):
            fn("binary_classification@a,b,c", str(src), str(tmp_path / "o"))
        with pytest.raises(ValueError, match="unsupported mode"):
            fn("ranking", str(src), str(tmp_path / "o"))


def test_convert_then_train(tmp_path):
    """`cli convert` output trains through `cli train` as the text format."""
    rng = np.random.RandomState(5)
    rows = []
    for _ in range(200):
        x = rng.randn(3)
        y = "+1" if x[0] - x[1] + 0.3 * rng.randn() > 0 else "-1"
        rows.append(f"{y} " + " ".join(f"{j + 1}:{x[j]:.4f}"
                                       for j in range(3)))
    (tmp_path / "a.libsvm").write_text("\n".join(rows) + "\n")
    rc, last = _quiet(cli.main, ["convert", "binary_classification@-1,+1",
                                 str(tmp_path / "a.libsvm"),
                                 str(tmp_path / "a.txt")])
    assert rc == 0 and json.loads(last)["lines"] == 200
    cfg = {"data": {"train": {"data_path": str(tmp_path / "a.txt")}},
           "model": {"data_path": str(tmp_path / "m")},
           "loss": {"loss_function": "sigmoid", "evaluate_metric": ["auc"],
                    "regularization": {"l2": [0.01]}}}
    (tmp_path / "c.conf").write_text(json.dumps(copy.deepcopy(cfg)))
    rc, last = _quiet(cli.main, ["train", "linear", str(tmp_path / "c.conf"),
                                 "--device", "cpu"])
    res = json.loads(last)
    assert rc == 0 and res["train_metrics"]["auc"] > 0.8
