"""`cli train` and HoagTrainer of the port (ytklearn_tpu_torch/cli.py,
train.py) against the JAX package's, end to end on seeded synthetic text
files, the JAX side in float32 (`jax.enable_x64(False)`) as its CLI runs.

Runs: the four families through both CLIs (linear sparse with L1, so
OWL-QN; multiclass_linear with softmax, K = 5; FM; FFM), then through the
trainers grid search, HOAG, continue_train from each package's own dump,
and just_evaluate. Each pair: the same status and iterations, the first 5
iterations' train avg loss at rtol 1e-4, the final avg loss and test loss
at rtol 1e-4, and test AUC within 1e-4 (float32 sums in another order).
"""

import contextlib
import copy
import io
import json

import jax
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import cli as jcli
from ytklearn_tpu import train as jtrain
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu_torch import cli
from ytklearn_tpu_torch import train as ptrain
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

RTOL = 1e-4
# (run, family, write_convex_case keywords)
FAMILIES = [
    ("linear", "linear", dict(vocab=5000, nnz=10, l1=5e-5, l2=1e-3,
                              max_iter=12)),
    ("multiclass_linear", "multiclass_linear", dict(vocab=60, K=5, l2=0.01)),
    ("fm", "fm", dict(vocab=200, k=4, l2=1e-4, max_iter=15)),
    ("ffm", "ffm", dict(vocab=120, n_fields=6, k=3, l2=0.01, max_iter=15)),
]


def _case(tmp, family, max_iter=20, **kw):
    cfg = write_convex_case(str(tmp), family, 1500, 400, 17,
                            max_iter=max_iter, **kw)
    cfg["loss"]["evaluate_metric"] = ["auc"]
    cfg["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-7
    return cfg


def _capture(mp, module, sink):
    real = module.HoagTrainer.train

    def train(self, *a, **kw):
        res = real(self, *a, **kw)
        sink.append(res)
        return res

    mp.setattr(module.HoagTrainer, "train", train)


def _cli_pair(tmp, name, cfg):
    """Both CLIs on one config file -> {who: (json line, TrainResult)}."""
    out = {}
    for who, fn, extra in (("jax", jcli.train_main, ["--devices", "1"]),
                           ("port", lambda a: cli.main(["train"] + a),
                            ["--device", "cpu"])):
        c = copy.deepcopy(cfg)
        c["model"]["data_path"] = str(tmp / who / "model")
        conf = tmp / f"{who}.conf"
        conf.write_text(json.dumps(c))
        sink = []
        mp = pytest.MonkeyPatch()
        _capture(mp, jtrain if who == "jax" else ptrain, sink)
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf), jax.enable_x64(False):
                assert fn([name, str(conf)] + extra) == 0
        finally:
            mp.undo()
        out[who] = (json.loads(buf.getvalue().strip().splitlines()[-1]),
                    sink[0])
    return out


def _trainer_pair(cfg, family, paths):
    out = {}
    for who, cls, pcls, kw in (("jax", jtrain.HoagTrainer, JParams, {}),
                               ("port", ptrain.HoagTrainer, PParams,
                                {"device": "cpu"})):
        c = copy.deepcopy(cfg)
        c["model"]["data_path"] = paths[who]
        with jax.enable_x64(False):
            out[who] = (None, cls(pcls.from_config(c), family, **kw).train())
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for name, family, kw in FAMILIES:
        tmp = tmp_path_factory.mktemp(name)
        out[name] = _cli_pair(tmp, family, _case(tmp, family, **kw))
        out[name + "_dir"] = tmp
    tmp = tmp_path_factory.mktemp("hyper")
    base = _case(tmp, "linear", vocab=300, l2=0.01)
    paths = {w: str(tmp / w / "model") for w in ("jax", "port")}
    grid = copy.deepcopy(base)
    grid["hyper"] = {"switch_on": True, "mode": "grid",
                     "grid": {"l2": [0.001, 0.03, 0.3]}}
    grid["optimization"]["line_search"]["lbfgs"]["convergence"][
        "max_iter"] = 8
    out["grid"] = _trainer_pair(grid, "linear", paths)
    hoag = copy.deepcopy(base)
    hoag["hyper"] = {"switch_on": True, "mode": "hoag",
                     "hoag": {"l2": [0.05], "outer_iter": 3}}
    hoag["optimization"]["line_search"]["lbfgs"]["convergence"][
        "max_iter"] = 8
    out["hoag"] = _trainer_pair(hoag, "linear", paths)
    # continue_train and just_evaluate from each package's FM dump
    fm = out["fm_dir"]
    fm_cfg = _case(fm, "fm", **FAMILIES[2][2])
    fm_paths = {w: str(fm / w / "model") for w in ("jax", "port")}
    cont = copy.deepcopy(fm_cfg)
    cont["model"]["continue_train"] = True
    cont["optimization"]["line_search"]["lbfgs"]["convergence"][
        "max_iter"] = 5
    out["continue"] = _trainer_pair(cont, "fm", fm_paths)
    ev = copy.deepcopy(fm_cfg)
    ev["loss"]["just_evaluate"] = True
    out["just_evaluate"] = _trainer_pair(ev, "fm", fm_paths)
    return out


def _agree(j, p):
    assert (p.status, p.n_iter) == (j.status, j.n_iter)
    jh = [r["avg_loss"] for r in j.history[:6]]
    ph = [r["avg_loss"] for r in p.history[:6]]
    np.testing.assert_allclose(ph, jh, rtol=RTOL)
    np.testing.assert_allclose(p.avg_loss, j.avg_loss, rtol=RTOL)
    if j.test_loss is not None:
        np.testing.assert_allclose(p.test_loss, j.test_loss, rtol=RTOL)
    assert set(p.test_metrics) == set(j.test_metrics)
    for k in j.test_metrics:
        assert abs(p.test_metrics[k] - j.test_metrics[k]) <= 1e-4


@pytest.mark.parametrize("name", [f[0] for f in FAMILIES])
def test_cli_train_families_match_jax(name, runs):
    (jline, jres), (pline, pres) = runs[name]["jax"], runs[name]["port"]
    assert set(pline) == set(jline) == {
        "model", "n_iter", "status", "avg_loss", "test_loss",
        "train_metrics", "test_metrics"}
    assert pline["model"] == jline["model"] == name
    assert (pline["n_iter"], pline["status"]) == (jline["n_iter"],
                                                  jline["status"])
    np.testing.assert_allclose(pline["avg_loss"], jline["avg_loss"],
                               rtol=RTOL)
    _agree(jres, pres)
    assert pres.n_iter >= 5
    tmp = runs[name + "_dir"]
    assert (tmp / "port" / "model" / "model-00000").exists()
    assert (tmp / "port" / "model_dict" / "dict-00000").exists()


def test_owlqn_zero_weights(runs):
    jw, pw = runs["linear"]["jax"][1].w, runs["linear"]["port"][1].w
    jz, pz = jw == 0.0, pw == 0.0
    assert jz.sum() > 50
    assert np.all(np.abs(jw[jz != pz]) < 1e-6)


@pytest.mark.parametrize("name", ["grid", "hoag", "continue",
                                  "just_evaluate"])
def test_hyper_and_warm_start_match_jax(name, runs):
    (_, jres), (_, pres) = runs[name]["jax"], runs[name]["port"]
    _agree(jres, pres)
    if name == "grid":
        assert (pres.best_l1, pres.best_l2) == (jres.best_l1, jres.best_l2)
        assert len(pres.history) > 8  # three rounds
    if name == "hoag":
        np.testing.assert_allclose(pres.best_l2, jres.best_l2, rtol=1e-3)
        assert len({r["l2"][0] for r in pres.history}) > 1  # l2 moved
    if name == "continue":  # starts from the dump, below a fresh start
        assert pres.history[0]["avg_loss"] < 0.6
    if name == "just_evaluate":
        assert pres.status == "callback_stop" and pres.n_iter == 0


def test_trainer_needs_a_device(runs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ptrain.HoagTrainer(PParams(), "linear")
    conf = runs["fm_dir"] / "port.conf"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train", "fm", str(conf)])
