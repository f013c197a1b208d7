"""`cli train gbdt` of the port against the JAX package's CLI.

Both CLIs train experiment/higgs/local_gbdt.conf (loss policy, lr 0.1,
min_child_hessian_sum 100, `value@0` fill) with `--set` overrides for the
data and model paths, 3 rounds, 15 leaves, an 8-feature dim and 32 bins,
on seeded Higgs-like text files the test writes (a few values missing).
The JAX CLI runs with its defaults on one device, the port's with
`--device cpu`: both train with bf16 histograms.

Tolerance. bf16 histograms are float sums in another order than the
reference's, so the data is checked first: every chosen split of every
round beats its runner-up by more than 1e-4 relative
(test_torch_engine.split_margins). There the model texts have the same
tree structure, split values and feature names (on this data they are
byte-identical), the `.bins.json` sidecars are byte-identical, the JSON
lines agree (losses at rtol 1e-4, AUC at 1e-4 absolute), and the JAX
GBDTPredictor scores the port's dump bit for bit as the port's predictor
does.
"""

import contextlib
import io
import json

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import cli as jcli
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.predict import create_predictor as jax_create_predictor
from ytklearn_tpu_torch import cli, obs
from ytklearn_tpu_torch.obs import profiler
from ytklearn_tpu_torch.gbdt import trainer as ptrainer
from ytklearn_tpu_torch.gbdt.binning import model_text_digest
from ytklearn_tpu_torch.predict import create_predictor
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
    write_gbst_case
from test_torch_engine import split_margins

CONF = "experiment/higgs/local_gbdt.conf"
F = 8
APPROX = [{"cols": "default", "type": "sample_by_quantile", "max_cnt": 32,
           "use_sample_weight": False, "alpha": 0.5}]


def _write(path, rng, n):
    X = rng.randn(n, F).astype(np.float32)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) + 0.8 * (X[:, 3] > 0.5)
         + rng.randn(n) * 0.5 > 0).astype(int)
    rows = []
    for i in range(n):
        feats = ",".join(f"f{j}:{float(X[i, j])!r}" for j in range(F)
                         if rng.rand() > 0.02)
        rows.append(f"1###{y[i]}###{feats}")
    path.write_text("\n".join(rows) + "\n")
    return X


def _args(tmp, who):
    return [
        "gbdt", CONF,
        "--set", f"data.train.data_path={tmp / 'train.txt'}",
        "--set", f"data.test.data_path={tmp / 'test.txt'}",
        "--set", f"data.max_feature_dim={F}",
        "--set", f"model.data_path={tmp / who / 'gbdt.model'}",
        "--set", f"model.feature_importance_path={tmp / who / 'imp'}",
        "--set", "optimization.round_num=3",
        "--set", "optimization.max_leaf_cnt=15",
        "--set", f"feature.approximate={json.dumps(APPROX)}",
    ]


def _json_line(out):
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_train")
    rng = np.random.RandomState(29)
    _write(tmp / "train.txt", rng, 6000)
    X_test = _write(tmp / "test.txt", rng, 1500)
    mp = pytest.MonkeyPatch()
    rounds = []
    real_round = ptrainer.GBDTTrainer._round

    def recording(self, rnd, dd, spec, state):
        g, h = self.loss.grad_hess(self.loss.predict(state[0]), dd.y)
        out = real_round(self, rnd, dd, spec, state)
        tree = {k: v[rnd].numpy() for k, v in out[2].items()}
        rounds.append((tree, (g * dd.weight).numpy(),
                       (h * dd.weight).numpy(), dd, spec))
        return out

    mp.setattr(ptrainer.GBDTTrainer, "_round", recording)
    outs = {}
    try:
        for who, fn, extra in (("jax", jcli.train_main, ["--devices", "1"]),
                               ("port", lambda a: cli.main(["train"] + a),
                                ["--device", "cpu"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert fn(_args(tmp, who) + extra) == 0
            outs[who] = _json_line(buf.getvalue())
    finally:
        mp.undo()
    return {"tmp": tmp, "out": outs, "rounds": rounds, "X_test": X_test}


def test_data_has_wide_split_margins(runs):
    assert len(runs["rounds"]) == 3
    for tree, g, h, dd, spec in runs["rounds"]:
        assert spec.hist_mode == "mxu" and spec.use_bf16  # the defaults
        bins = dd.bins_t.t().long().numpy()
        m = split_margins(tree, bins, g, h, dd.real_mask.numpy(), spec.l2,
                          spec.min_h, True)
        assert len(m) >= 8 and m.min() > 1e-4, m.min()


def test_json_lines_agree(runs):
    j, p = runs["out"]["jax"], runs["out"]["port"]
    assert set(p) == set(j) == {"model", "trees", "train_loss", "test_loss",
                                "train_metrics", "test_metrics"}
    assert (p["model"], p["trees"]) == (j["model"], j["trees"]) == ("gbdt", 3)
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(p[k], j[k], rtol=1e-4)
    for k in ("train_metrics", "test_metrics"):
        assert set(p[k]) == set(j[k]) == {"auc"}
        assert abs(p[k]["auc"] - j[k]["auc"]) <= 1e-4


def _read(tmp, who, name):
    return (tmp / who / name).read_text()


def test_model_texts_and_sidecars(runs):
    tmp = runs["tmp"]
    jt, pt = _read(tmp, "jax", "gbdt.model"), _read(tmp, "port", "gbdt.model")
    jm, pm = JModel.loads(jt), JModel.loads(pt)
    assert len(pm.trees) == len(jm.trees) == 3
    for a, b in zip(pm.trees, jm.trees):
        for f in ("feat_name", "left", "right", "split", "default_left",
                  "sample_cnt"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-4,
                                   atol=1e-7)
    js = json.loads(_read(tmp, "jax", "gbdt.model.bins.json"))
    ps = json.loads(_read(tmp, "port", "gbdt.model.bins.json"))
    assert ps["model_digest"] == model_text_digest(pt)
    assert js["model_digest"] == model_text_digest(jt)
    ps.pop("model_digest"), js.pop("model_digest")
    assert json.dumps(ps) == json.dumps(js)  # the same edges, byte for byte
    # on this data the bf16 sums come out the same in both orders: the
    # model texts, and so the sidecars with their digests, are identical
    assert pt == jt
    assert _read(tmp, "port", "gbdt.model.bins.json") == \
        _read(tmp, "jax", "gbdt.model.bins.json")
    assert _read(tmp, "port", "imp").splitlines()[0] == \
        _read(tmp, "jax", "imp").splitlines()[0]


def test_jax_predictor_scores_the_port_dump(runs):
    tmp = runs["tmp"]
    cfg = {"model": {"data_path": str(tmp / "port" / "gbdt.model")},
           "optimization": {"loss_function": "sigmoid", "round_num": 100}}
    rows = [{f"f{j}": float(x[j]) for j in range(F)} for x in runs["X_test"]]
    rows[0] = {}  # every feature missing: the default directions
    want = jax_create_predictor("gbdt", cfg).batch_scores(rows)
    assert np.array_equal(create_predictor("gbdt", cfg).batch_scores(rows),
                          want)


@pytest.mark.parametrize("extra,match", [
    (["--max-restarts", "1"], "1.5"),
    (["--resume", "auto"], "1.5"),
    (["--coordinator", "localhost:1234"], "1.7"),
    (["--devices", "2"], "1.7"),
    (["--trace-out", "t.json"], "1.12"),
    (["--profile"], "1.12"),
])
def test_unported_options_raise_by_item(extra, match, runs):
    """The options items 1.5, 1.7 and 1.12 lifted train one round on the
    CPU and return 0: `--max-restarts 1` with nothing failing, `--resume
    auto` with no model there (a cold start), `--coordinator` as a one-rank
    gloo group and `--devices 2` as two gloo ranks (rank 0 dumps; the JSON
    line carries the ranks' reports; since item 1.7b a linear model trains
    under both as well), `--trace-out T` writing a Chrome trace that loads
    and holds the run's spans, and `--profile DIR` writing the ytkprof
    report (the trainer's phases, coverage of the run) and a
    torch.profiler capture of the rounds into DIR."""
    if match == "1.7":
        tag = extra[0].strip("-")
        if extra[0] == "--coordinator":
            from ytklearn_tpu_torch.gbdt.launch import free_port

            extra = ["--coordinator", f"127.0.0.1:{free_port()}",
                     "--num-processes", "1", "--process-id", "0"]
        args = _args(runs["tmp"], tag) + [
            "--set", "optimization.round_num=1", "--device", "cpu"] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["train"] + args) == 0
        line = _json_line(buf.getvalue())
        assert line["trees"] == 1
        assert (runs["tmp"] / tag / "gbdt.model").exists()
        if tag == "devices":
            assert [r["rank"] for r in line["ranks"]] == [0, 1]
            assert {r["backend"] for r in line["ranks"]} == {"gloo"}
        else:
            assert line["rank"]["backend"] == "gloo"
            assert line["rank"]["collectives"]["psum_scatter"]["calls"] > 0
        # the convex families take both flags too (item 1.7b)
        d = runs["tmp"] / f"linear_{tag}"
        conf = d / "c.conf"
        cfg = write_convex_case(str(d), "linear", 200, 50, 3, max_iter=2)
        conf.write_text(json.dumps(cfg))
        if tag == "coordinator":
            from ytklearn_tpu_torch.gbdt.launch import free_port

            extra = ["--coordinator", f"127.0.0.1:{free_port()}",
                     "--num-processes", "1", "--process-id", "0"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["train", "linear", str(conf), "--device",
                             "cpu"] + extra) == 0
        line = _json_line(buf.getvalue())
        assert line["n_iter"] == 2 and (d / "model").exists()
        if tag == "devices":
            assert [r["rank"] for r in line["ranks"]] == [0, 1]
        else:
            assert line["rank"]["collectives"]["psum"]["calls"] > 0
        return
    if match in ("1.5", "1.12"):
        tag = extra[0].strip("-")
        out = runs["tmp"] / f"{tag}.out"
        if extra == ["--profile"]:
            extra = extra + [str(out)]
        elif extra[0] == "--trace-out":
            extra = [extra[0], str(out)]
        args = _args(runs["tmp"], tag) + [
            "--set", "optimization.round_num=1", "--device", "cpu"] + extra
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                assert cli.main(["train"] + args) == 0
            assert _json_line(buf.getvalue())["trees"] == 1
            assert (runs["tmp"] / tag / "gbdt.model").exists()
            if extra[0] == "--trace-out":
                doc = json.loads(out.read_text())
                names = {e["name"] for e in doc["traceEvents"]}
                assert {"gbdt.train", "gbdt.round", "gbdt.sync",
                        "ingest.parse"} <= names
            elif extra[0] == "--profile":
                rep = json.loads((out / "ytkprof.json").read_text())
                assert rep["schema"] == "ytkprof"
                assert {"gbdt.load", "gbdt.preprocess", "gbdt.train",
                        "gbdt.finalize"} <= set(rep["phases"])
                assert 0.5 < rep["phase_coverage"] <= 1.0
                assert rep["kernels"]["parsed"] == 1
                assert rep["kernels"]["top_kernels"]
                assert list(out.glob("gbdt.train_*/trace.json"))
        finally:
            profiler.configure_profiler(on=False, capture_dir=None)
            profiler.reset_profiler()
            obs.configure(enabled=False, trace_path=None)
            obs.reset()
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {match}"):
        cli.main(["train", "gbdt", CONF] + extra)


@pytest.mark.parametrize("name,item", [("gbmlr", "1.10"),
                                       ("gbhsdt", "1.10"),
                                       ("gbsdt", "1.10")])
def test_unported_models_raise_by_item(name, item, tmp_path):
    """The GBST names, refused until ROADMAP.md item 1.10 ported them, now
    train: one tree on the CPU through `cli train`, its JSON line and its
    dump."""
    cfg = write_gbst_case(str(tmp_path), 300, 100, 3, K=4, tree_num=1,
                          vocab=60, max_iter=3)
    conf = tmp_path / "gbst.conf"
    conf.write_text(json.dumps(cfg))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["train", name, str(conf), "--device", "cpu"]) == 0
    line = _json_line(buf.getvalue())
    assert (line["model"], line["trees"]) == (name, 1)
    assert np.isfinite(line["train_loss"]) and np.isfinite(line["test_loss"])
    model = cfg["model"]["data_path"]
    with open(f"{model}/tree-00000/model-00000") as f:
        assert f.readline() == "k:4\n"
    with open(f"{model}/tree-info") as f:
        assert "finished_tree_num:1\n" in f.read()


def test_default_device_needs_cuda(runs, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train"] + _args(runs["tmp"], "nodev"))
