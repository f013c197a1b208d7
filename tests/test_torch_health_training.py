"""The training sentinels of the port (obs/health.py: check_loss,
ProgressGuard, check_ingest, check_tree) against the JAX package's, on the
CPU: each fires the same `health.*` counters and events as the reference
at the same call site. The units alone, then through their callers: the
GBDT trainer's sync read (a NaN loss at a round) and tree conversion (an
empty tree), DataIngest's Python and native parsers (5% bad lines), the
L-BFGS iteration loop (a plateau; a NaN loss) and HoagTrainer's test-loss
callback (a non-finite test loss). Seeds from numpy, small sizes.
"""

import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import obs as jobs
from ytklearn_tpu.config.params import CommonParams as JCommon
from ytklearn_tpu.gbdt import trainer as jtrainer
from ytklearn_tpu.io.reader import DataIngest as JIngest
from ytklearn_tpu.obs import health as jhealth
from ytklearn_tpu.optimize import LBFGSConfig as JLBFGSConfig
from ytklearn_tpu.optimize import minimize_lbfgs as jminimize
from ytklearn_tpu.train import HoagTrainer as JHoag
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.config.params import CommonParams as PCommon
from ytklearn_tpu_torch.gbdt import trainer as ptrainer
from ytklearn_tpu_torch.io.reader import DataIngest as PIngest
from ytklearn_tpu_torch.obs import health
from ytklearn_tpu_torch.optimize import LBFGSConfig, minimize_lbfgs
from ytklearn_tpu_torch.train import HoagTrainer as PHoag

from test_torch_gbdt_objectives import _train_pair


@pytest.fixture
def both_obs():
    """Obs collection on in both packages, fresh registries; restored."""
    was = (obs.enabled(), jobs.enabled())
    obs.configure(enabled=True)
    jobs.configure(enabled=True)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()
    obs.configure(enabled=was[0])
    jobs.configure(enabled=was[1])


def _health(mod, prefix="health."):
    return {k: v for k, v in mod.snapshot()["counters"].items()
            if k.startswith(prefix)}


def _events(mod, name):
    """(site, sorted args without the site) of each `name` event."""
    out = []
    for e in mod.REGISTRY.events:
        if e["name"] == name:
            args = dict(e.get("args") or {})
            out.append((args.pop("site", None), sorted(args.items())))
    return out


def test_training_checks_as_the_reference(both_obs):
    cases = [("check_loss", ("s", v)) for v in (1.0, float("nan"),
                                                float("inf"))]
    cases += [("check_ingest", ("s", e, r)) for e, r in
              ((0, 10), (2, 50), (5, 200), (1, 1000), (10, 190))]
    cases += [("check_tree", ("s", n, g)) for n, g in
              ((1, []), (5, [1.0, float("nan")]), (7, [0.5, 0.25]))]
    for fn, args in cases:
        assert getattr(health, fn)(*args) == getattr(jhealth, fn)(*args)
    pg, jpg = health.ProgressGuard("p", window=3), jhealth.ProgressGuard(
        "p", window=3)
    for v in (5.0, 4.0, 4.0, 4.0, 4.0, 3.0, 3.0, 3.0, 3.0, float("nan")):
        assert pg.update(v) == jpg.update(v)
    assert _health(obs) == _health(jobs)
    assert _events(obs, "health.divergence") == _events(jobs,
                                                        "health.divergence")


def test_ingest_tolerance_and_health_off_as_the_reference(both_obs):
    for h in (health, jhealth):
        h.configure_health(ingest_tol=0.1)
    try:
        assert health.check_ingest("s", 10, 190) is jhealth.check_ingest(
            "s", 10, 190) is True
        assert health.check_ingest("s", 30, 170) is jhealth.check_ingest(
            "s", 30, 170) is False
    finally:
        for h in (health, jhealth):
            h.configure_health(ingest_tol=0.01)
    for h in (health, jhealth):
        h.configure_health(on=False)
    try:
        assert health.check_loss("s", float("nan"))
        assert health.check_tree("s", 1, [float("nan")])
        assert health.ProgressGuard("s", window=1).update(1.0)
    finally:
        for h in (health, jhealth):
            h.configure_health(on=True)
    assert _health(obs) == _health(jobs) == {
        "health.ingest_errors": 1.0, "health.ingest_errors.s": 1.0}


@pytest.mark.parametrize("fn,args", [
    ("check_loss", ("s", float("nan"))),
    ("check_tree", ("s", 5, [float("inf")])),
    ("check_ingest", ("s", 10, 100)),
])
def test_strict_mode_escalates_a_training_sentinel_as_the_reference(
        both_obs, tmp_path, fn, args):
    msgs = []
    # strict mode set in both packages' state (an override another test
    # may have left wins over the env knob), restored after
    was = (health._state.strict, jhealth._state.strict)
    try:
        with mock.patch.dict(os.environ, {"YTK_FLIGHT_DIR": str(tmp_path)}):
            for h in (health, jhealth):
                h.configure_health(strict=True)
                with pytest.raises(h.HealthError) as e:
                    getattr(h, fn)(*args)
                msgs.append(str(e.value).split(" (flight dump")[0])
            # a plateau and an empty tree only warn, even in strict mode
            for h in (health, jhealth):
                assert h.check_tree("s", 1, []) is False
                g = h.ProgressGuard("s", window=1)
                g.update(1.0)
                assert g.update(1.0) is False
    finally:
        health._state.strict, jhealth._state.strict = was
    assert msgs[0] == msgs[1]


# -- the GBDT trainer -------------------------------------------------------------


def _gbdt_data(seed, n=1500):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 4).astype(np.float32)
    y = (X[:, 0] - 0.5 * X[:, 1] + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y, np.ones(n, np.float32)


def test_gbdt_nan_loss_at_the_sync_read_as_the_reference(both_obs, tmp_path,
                                                         monkeypatch):
    """A NaN train loss read at round 2's sync fires `health.nan` at
    `gbdt.sync` once, naming the round, in both trainers; every sync
    passes through the sentinel at the same rounds."""
    seen = {}
    for who, mod in (("port", ptrainer), ("jax", jtrainer)):
        real = mod.GBDTTrainer._health_sync
        rounds = seen.setdefault(who, [])

        def poisoned(self, rnd, tl, _real=real, _rounds=rounds):
            _rounds.append(rnd)
            return _real(self, rnd, float("nan") if rnd == 2 else tl)

        monkeypatch.setattr(mod.GBDTTrainer, "_health_sync", poisoned)
    _train_pair(tmp_path, _gbdt_data(1), None, loss_function="l2",
                round_num=5)
    assert seen["port"] == seen["jax"] and 2 in seen["port"]
    want = {"health.nan": 1.0, "health.nan.gbdt.sync": 1.0}
    assert {k: v for k, v in _health(obs).items() if "nan" in k} == want
    assert {k: v for k, v in _health(jobs).items() if "nan" in k} == want
    assert _events(obs, "health.nan") == _events(jobs, "health.nan") == [
        ("gbdt.sync", [("round", 2), ("value", "nan")])]


def test_gbdt_empty_trees_as_the_reference(both_obs, tmp_path):
    """min_split_loss above every gain: each tree is a stump, and the tree
    conversion fires `health.empty_tree` once a tree in both trainers."""
    jres, pres, _ = _train_pair(tmp_path, _gbdt_data(2), None,
                                loss_function="l2", round_num=4,
                                min_split_loss=1e12)
    assert len(pres.model.trees) == len(jres.model.trees) == 4
    want = {"health.empty_tree": 4.0, "health.empty_tree.gbdt.tree": 4.0}
    assert {k: v for k, v in _health(obs).items() if "empty" in k} == want
    assert {k: v for k, v in _health(jobs).items() if "empty" in k} == want
    assert _events(obs, "health.empty_tree") == \
        _events(jobs, "health.empty_tree")


# -- DataIngest ---------------------------------------------------------------------


def _ingest_file(path, n_good, n_bad, seed):
    rng = np.random.RandomState(seed)
    lines = [f"1###{int(rng.rand() < 0.5)}###f0:{rng.randn():.5f},"
             f"f1:{rng.randn():.5f}" for _ in range(n_good)]
    for i in range(n_bad):
        lines.insert(int(rng.randint(len(lines))), f"garbage line {i}")
    path.write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("n_good,n_bad", [(190, 10), (995, 5), (60, 6)])
def test_ingest_error_rate_fires_on_both_parsers_as_the_reference(
        both_obs, tmp_path, parser, n_good, n_bad):
    path = tmp_path / "train.txt"
    _ingest_file(path, n_good, n_bad, n_good + n_bad)
    cfg = {"data": {"train": {"data_path": str(path),
                              "max_error_tol": 100}},
           "model": {"data_path": str(tmp_path / "m")}}
    getattr(PIngest(PCommon.from_config(cfg)),
            "_load_python" if parser == "python" else "_load_fast")()
    getattr(JIngest(JCommon.from_config(cfg)),
            "_load_python" if parser == "python" else "_load_fast")()
    site = "ingest.parse" if parser == "python" else "ingest.parse_native"
    fired = n_bad / (n_good + n_bad) > 0.01 and n_good + n_bad >= 100
    assert _health(obs) == _health(jobs) == (
        {"health.ingest_errors": 1.0, f"health.ingest_errors.{site}": 1.0}
        if fired else {})
    for k in ("ingest.error_lines", "ingest.rows_parsed"):
        assert obs.snapshot()["counters"][k] == \
            jobs.snapshot()["counters"][k]
    assert _events(obs, "health.ingest_errors") == \
        _events(jobs, "health.ingest_errors")


# -- L-BFGS and the convex trainer -------------------------------------------------


def test_lbfgs_plateau_fires_divergence_as_the_reference(both_obs):
    """A loss flat in float32 around 100: ten iterations without a 1e-7
    relative gain fire `health.divergence` at `lbfgs`, again each ten."""
    x = np.linspace(1.0, 2.0, 6).astype(np.float32)
    w0 = np.full(6, 30.0, np.float32)
    res = minimize_lbfgs(lambda w, x: 100.0 + torch.sum(x * w * w) * 1e-3,
                         torch.from_numpy(w0), LBFGSConfig(max_iter=40,
                                                           eps=0.0),
                         batch=(torch.from_numpy(x),))
    with jax.enable_x64(False):
        jres = jminimize(lambda w, x: 100.0 + jnp.sum(x * w * w) * 1e-3, w0,
                         JLBFGSConfig(max_iter=40, eps=0.0), batch=(x,))
    assert (res.status, res.n_iter) == (jres.status, jres.n_iter)
    assert _health(obs) == _health(jobs)
    assert _health(obs)["health.divergence.lbfgs"] >= 1
    assert _events(obs, "health.divergence") == \
        _events(jobs, "health.divergence")


def test_lbfgs_nan_loss_fires_and_stops_as_the_reference(both_obs):
    res = minimize_lbfgs(lambda w, x: torch.sum(w * x) * float("nan"),
                         torch.ones(4), LBFGSConfig(max_iter=3),
                         batch=(torch.ones(4),))
    with jax.enable_x64(False):
        jres = jminimize(lambda w, x: jnp.sum(w * x) * jnp.float32("nan"),
                         np.ones(4, np.float32), JLBFGSConfig(max_iter=3),
                         batch=(np.ones(4, np.float32),))
    assert (res.status, res.n_iter) == (jres.status, jres.n_iter)
    assert _health(obs) == _health(jobs)


def test_convex_test_loss_sentinel_as_the_reference(both_obs, tmp_path):
    """Held-out rows with an infinite value: the test loss is non-finite
    at every iteration's callback, and HoagTrainer fires
    `health.nan` at `train.convex_test` each time, as the reference."""
    rng = np.random.RandomState(9)
    lines = []
    for _ in range(300):
        x = rng.randn(3)
        y = int(rng.rand() < 1 / (1 + np.exp(-(x[0] - x[1]))))
        lines.append(f"1###{y}###a:{x[0]:.5f},b:{x[1]:.5f},c:{x[2]:.5f}")
    (tmp_path / "train").write_text("\n".join(lines) + "\n")
    (tmp_path / "test").write_text("\n".join(lines[:50] + [
        "1###0###a:inf", "1###1###a:inf"]) + "\n")
    counts = []
    for who, params, cls in (("port", PCommon, PHoag),
                             ("jax", JCommon, JHoag)):
        cfg = {"data": {"train": {"data_path": str(tmp_path / "train")},
                        "test": {"data_path": str(tmp_path / "test")}},
               "model": {"data_path": str(tmp_path / who / "m")},
               "loss": {"loss_function": "sigmoid", "evaluate_metric": [],
                        "regularization": {"l2": [0.01]}},
               "optimization": {"line_search": {"lbfgs": {"convergence": {
                   "max_iter": 5}}}}}
        kw = {"device": "cpu"} if who == "port" else {}
        with jax.enable_x64(False):
            res = cls(params.from_config(cfg), "linear", **kw).train()
        counts.append(res.n_iter)
    assert counts[0] == counts[1]
    assert _health(obs) == _health(jobs)
    assert _health(obs)["health.nan.train.convex_test"] == counts[0] + 1
    assert _events(obs, "health.nan") == _events(jobs, "health.nan")
