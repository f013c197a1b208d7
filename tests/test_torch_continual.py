"""Continual training in the port (ytklearn_tpu_torch/continual,
optimize/ftrl.py) against the JAX package's, on the CPU.

FTRL: `ftrl_init` inverts the closed form; `ftrl_pass` matches the JAX
pass on the same stream at rtol 1e-5 (float32 sums in another order) and
repeats bit for bit. Gates: `evaluate_gates` gives the same `GateReport`;
`holdout_loss` matches at rtol 1e-12 (float64 tree walks). Retrain
(continual/driver.py): the lifecycle of a linear model (bootstrap, warm,
FTRL, rejections, strict mode, archives and YTK_CONTINUAL_KEEP pruning,
rollback) takes the same decisions and writes the same version records
and files as the JAX package's; a GBDT int8 warm start grows the
reference's trees; the FTRL refusal for gbdt, the lock's reclaim of a
dead or stale owner and the gate's narrowed scorer fallback behave as
stated. The data are the
reference's own `tests/test_continual.py` fixtures (seeded numpy).
"""

import dataclasses
import json
import math
import os
import socket
import time
from unittest import mock

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
import ytklearn_tpu.continual as jcont
from ytklearn_tpu import obs as jobs
from ytklearn_tpu.gbdt import trainer as jgbdt_trainer
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.optimize import ftrl as jftrl
from ytklearn_tpu.predict import create_predictor as jcreate
from ytklearn_tpu_torch import continual as pcont
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.continual import driver as pdriver
from ytklearn_tpu_torch.continual import gates as pgates
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.optimize import ftrl as pftrl
from ytklearn_tpu_torch.predict import create_predictor as pcreate
from ytklearn_tpu_torch.serve import scorer as pscorer

from test_continual import (  # the reference's own fixtures and data
    _corrupt_weights,
    _gbdt_cfg,
    _linear_cfg,
    _toy_batch,
    _write_rows,
)
from test_torch_gbdt_objectives import _assert_same_trees


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_continual_data")
    _write_rows(d / "d1.train", 600, 1)
    _write_rows(d / "d2.train", 600, 2)
    _write_rows(d / "holdout", 300, 3)
    _write_rows(d / "g1.train", 400, 4, nonlinear=True)
    _write_rows(d / "g2.train", 400, 5, nonlinear=True)
    _write_rows(d / "gholdout", 200, 6, nonlinear=True)
    return d


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


# -- FTRL ----------------------------------------------------------------------


class _PortQuad:
    """A weighted logistic loss on dense rows, the port's model surface."""

    def __init__(self, dim):
        self.dim = dim

    def reg_vectors(self, l1, l2):
        v = torch.ones((self.dim,), dtype=torch.float32)
        return l1 * v, l2 * v

    def pure_loss(self, w, X, y, weight):
        z = X @ w
        return torch.sum(weight * (torch.logaddexp(torch.zeros_like(z), z)
                                   - y * z))


class _JaxQuad:
    def __init__(self, dim):
        self.dim = dim

    def reg_vectors(self, l1, l2):
        import jax.numpy as jnp

        v = jnp.ones((self.dim,), jnp.float32)
        return l1 * v, l2 * v

    def pure_loss(self, w, X, y, weight):
        import jax.numpy as jnp

        z = X @ w
        return jnp.sum(weight * (jnp.logaddexp(0.0, z) - y * z))


def test_ftrl_init_inverts_closed_form():
    cfg = pftrl.FTRLConfig(alpha=0.05, beta=1.0, l1=0.1, l2=0.01)
    w0 = torch.tensor([0.5, -1.25, 0.0, 3.0])
    l1v = torch.full((4,), cfg.l1)
    l2v = torch.full((4,), cfg.l2)
    st = pftrl.ftrl_init(w0, cfg, l1v, l2v)
    denom = (cfg.beta + torch.sqrt(st.n)) / cfg.alpha + l2v
    w = torch.where(torch.abs(st.z) <= l1v, torch.zeros_like(st.z),
                    -(st.z - torch.sign(st.z) * l1v) / denom)
    assert torch.equal(w, w0)
    js = jftrl.ftrl_init(w0.numpy(), jftrl.FTRLConfig(**dataclasses.asdict(
        cfg)), l1v.numpy(), l2v.numpy())
    np.testing.assert_array_equal(st.z.numpy(), np.asarray(js.z))
    np.testing.assert_array_equal(st.n.numpy(), np.asarray(js.n))


@pytest.mark.parametrize("seed,alpha,l1,l2,batch_rows", [
    (0, 0.5, 0.0, 0.0, 32), (3, 0.2, 0.05, 0.01, 48), (4, 0.5, 5.0, 0.0, 32),
    (5, 0.1, 0.0, 0.1, 256)])
def test_ftrl_pass_matches_jax_and_repeats(seed, alpha, l1, l2, batch_rows):
    import jax

    X, y, wt = _toy_batch(seed=seed)
    w0 = np.random.RandomState(seed + 5).randn(X.shape[1]).astype(np.float32)
    cfg = pftrl.FTRLConfig(alpha=alpha, beta=1.0, l1=l1, l2=l2)
    a = pftrl.ftrl_pass(_PortQuad(X.shape[1]), w0, (X, y, wt), cfg,
                        batch_rows=batch_rows)
    b = pftrl.ftrl_pass(_PortQuad(X.shape[1]), w0, (X, y, wt), cfg,
                        batch_rows=batch_rows)
    for f in ("w", "z", "n"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    with jax.enable_x64(False):
        j = jftrl.ftrl_pass(_JaxQuad(X.shape[1]), w0, (X, y, wt),
                            jftrl.FTRLConfig(alpha=alpha, beta=1.0, l1=l1,
                                             l2=l2), batch_rows=batch_rows)
        jw, jz, jn = (np.asarray(v) for v in (j.w, j.z, j.n))
    np.testing.assert_allclose(a.w.numpy(), jw, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(a.z.numpy(), jz, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(a.n.numpy(), jn, rtol=1e-5, atol=1e-7)
    # the same coordinates sit at exactly zero (the L1 cut)
    np.testing.assert_array_equal(a.w.numpy() == 0, jw == 0)


# -- gates ---------------------------------------------------------------------

_GATE_CASES = [
    (1.04, 1.0, 0.05, {}), (1.06, 1.0, 0.05, {}), (1.0, 1.0, 0.0, {}),
    (1.0 + 1e-6, 1.0, 0.0, {}), (0.5, 1.0, 0.0, {"health.nan": 1.0}),
    (0.5, 1.0, 0.0, {"health.nan": 2.0, "health.empty_tree": 3.0}),
    (float("nan"), 1.0, 0.0, {}), (float("inf"), 2.0, 0.1, {}),
    (0.5, None, 0.0, {}), (None, None, 0.0, {}),
    (0.7, float("nan"), 0.0, {}), (-0.3, -0.5, 0.2, {}),
    (float("nan"), 1.0, 0.0, {"health.ingest_errors": 1.0}),
]


@pytest.mark.parametrize("case", _GATE_CASES, ids=[str(i) for i in range(
    len(_GATE_CASES))])
def test_evaluate_gates_equals_the_reference(case):
    cand, inc, band, hits = case
    adv = {"psi_max": 0.3, "worst_features": ["f1"]}
    p = dataclasses.asdict(pcont.evaluate_gates(cand, inc, band, hits, 7,
                                                advisory=adv))
    j = dataclasses.asdict(jcont.evaluate_gates(cand, inc, band, hits, 7,
                                                advisory=adv))
    assert repr(p) == repr(j)  # repr: NaN losses compare as text


def test_drift_advisory_and_health_delta_equal_the_reference(both_obs):
    block = {"models": {
        "a@v1": {"psi_max": 0.4, "ks_max": 0.2, "rows_sampled": 50,
                 "worst_features": ["x"],
                 "score": {"calibration_delta": 0.05}},
        "b@v2": {"no_baseline": True},
        "c@v1": {"psi_max": 0.1, "ks_max": 0.6, "rows_sampled": 20,
                 "score": {"calibration_delta": 0.2}}}}
    assert pgates.drift_advisory(block) == jcont.gates.drift_advisory(block)
    assert pgates.drift_advisory({"fleet": block["models"]}) == \
        jcont.gates.drift_advisory({"fleet": block["models"]})
    assert pgates.drift_advisory(None) is None
    before = (pcont.health_counters(), jcont.health_counters())
    from ytklearn_tpu.obs import health as jhealth
    from ytklearn_tpu_torch.obs import health as phealth

    for h in (phealth, jhealth):
        h.check_loss("s", float("nan"))
        h.check_tree("t", 1, [0.0])
    assert pcont.health_delta(before[0]) == jcont.health_delta(before[1]) \
        == {"health.nan": 1.0, "health.empty_tree": 1.0}


def _train_gbdt(tmp, data_dir, rounds=4):
    """A small GBDT dumped by the port on the CPU (int8), and its config."""
    cfg = _gbdt_cfg(data_dir, tmp / "gh.model", "g1.train", rounds)
    pcont.retrain("gbdt", cfg, device="cpu", hist_precision="int8")
    return cfg


@pytest.mark.parametrize("family", ["gbdt", "linear"])
def test_holdout_loss_matches_the_reference(tmp_path, data_dir, family):
    if family == "gbdt":
        cfg = _train_gbdt(tmp_path, data_dir)
        paths = [str(data_dir / "gholdout")]
        cfg = pdriver._eval_cfg(cfg, "gbdt")
    else:
        cfg = _linear_cfg(data_dir, tmp_path / "lr.model", max_iter=4)
        pcont.retrain("linear", cfg, device="cpu")
        paths = [str(data_dir / "holdout")]
    jl, jn = jcont.holdout_loss(jcreate(family, cfg), paths, compiled=False)
    for compiled in (True, False):
        pl, pn = pcont.holdout_loss(pcreate(family, cfg), paths,
                                    compiled=compiled, device="cpu")
        assert pn == jn > 0
        np.testing.assert_allclose(pl, jl, rtol=1e-12)


def test_gate_falls_back_only_on_a_scorer_refusal(both_obs, tmp_path,
                                                   data_dir):
    cfg = _train_gbdt(tmp_path, data_dir)
    pred = pcreate("gbdt", pdriver._eval_cfg(cfg, "gbdt"))
    paths = [str(data_dir / "gholdout")]
    want, _ = pcont.holdout_loss(pred, paths, compiled=False, device="cpu")
    assert obs.snapshot()["counters"].get("continual.gate_eval_fallback",
                                          0) == 0

    def refuse(self):
        raise pscorer.LoweringRefused("no lowering for GBDTPredictor")

    with mock.patch.object(pscorer.CompiledScorer, "_lower", refuse):
        got, _ = pcont.holdout_loss(pred, paths, device="cpu")
    assert got == want
    assert obs.snapshot()["counters"]["continual.gate_eval_fallback"] == 1

    def broken(self):
        raise RuntimeError("CUDA error: the kernel failed to launch")

    with mock.patch.object(pscorer.CompiledScorer, "_lower", broken):
        with pytest.raises(RuntimeError, match="failed to launch"):
            pcont.holdout_loss(pred, paths, device="cpu")
    assert obs.snapshot()["counters"]["continual.gate_eval_fallback"] == 1


# -- the retrain driver --------------------------------------------------------


def _tree_files(root):
    """{relative path: bytes} of every file the model roots hold."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _version_fields(info):
    """A version record without its clock and its float losses."""
    return {k: v for k, v in info.items()
            if k not in ("promoted_at", "candidate_loss", "incumbent_loss")}


def _lifecycle(pkg, root, data_dir, **kw):
    """The reference test's lifecycle, through one package's driver; a
    record of each step's decision and the version file after it."""
    os.makedirs(root, exist_ok=True)
    model = os.path.join(root, "lr.model")
    rec = []

    def step(name, fn):
        try:
            r = fn()
        except pkg.RetrainRejected as e:
            rec.append((name, "strict", e.report.reasons))
            return
        except FileNotFoundError:
            rec.append((name, "nothing to roll back"))
            return
        info = pkg.read_version(LocalFileSystem(), model)
        js = r.to_json()
        rec.append((name, js["promoted"], js["version"], js["mode"],
                    js["rolled_back"],
                    (js.get("gate") or {}).get("passed"),
                    len((js.get("gate") or {}).get("reasons", [])),
                    _version_fields(info), r))

    cfg1 = _linear_cfg(data_dir, model, max_iter=2, band=0.02)
    cfg2 = _linear_cfg(data_dir, model, train="d2.train", max_iter=12,
                       band=0.02)
    step("bootstrap", lambda: pkg.retrain("linear", cfg1, **kw))
    step("warm", lambda: pkg.retrain("linear", cfg2, **kw))
    step("ftrl", lambda: pkg.retrain("linear", cfg2, mode="ftrl", **kw))
    step("nan", lambda: pkg.retrain("linear", cfg2,
                                    candidate_hook=_corrupt_weights, **kw))
    with mock.patch.dict(os.environ, {"YTK_CONTINUAL_STRICT": "1"}):
        step("strict", lambda: pkg.retrain(
            "linear", cfg2, candidate_hook=_corrupt_weights, **kw))
    files = _tree_files(root)
    step("rollback1", lambda: pkg.rollback("linear", cfg2))
    step("rollback2", lambda: pkg.rollback("linear", cfg2))
    step("rollback3", lambda: pkg.rollback("linear", cfg2))
    return rec, files, _tree_files(root)


@pytest.mark.parametrize("keep", ["1", "2"])
def test_retrain_lifecycle_linear_equals_the_reference(tmp_path, data_dir,
                                                       keep):
    import jax

    with mock.patch.dict(os.environ, {"YTK_CONTINUAL_KEEP": keep}):
        with jax.enable_x64(False):
            jrec, jfiles, jend = _lifecycle(jcont, str(tmp_path / "jax"),
                                            data_dir)
        prec, pfiles, pend = _lifecycle(pcont, str(tmp_path / "port"),
                                        data_dir, device="cpu")
    assert [r[:8] for r in prec] == [r[:8] for r in jrec]
    assert [r[1] for r in prec] == [True, True, True, False, "strict",
                                    False, False if keep == "2" else
                                    "nothing to roll back",
                                    "nothing to roll back"]
    # the same file sets (archives, shadow, version record, lock gone)
    assert sorted(pfiles) == sorted(jfiles)
    assert sorted(pend) == sorted(jend)
    assert not any(f.endswith(".retrain.lock") for f in pfiles)
    # held-out losses at the convex stack's float32 tolerance
    for p, j in zip(prec, jrec):
        if len(p) < 9 or p[8].gate is None:
            continue
        for k in ("candidate_loss", "incumbent_loss"):
            a, b = getattr(p[8].gate, k), getattr(j[8].gate, k)
            if a is None or b is None or not math.isfinite(b):
                assert repr(a) == repr(b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-4)
    # the rejected candidate's NaN loss is null in valid JSON
    nan = [r for r in prec if r[0] == "nan"][0][8]
    assert json.loads(json.dumps(nan.to_json()))["gate"]["candidate_loss"] \
        is None


def test_retrain_ftrl_rejected_for_gbdt(data_dir, tmp_path):
    cfg = _gbdt_cfg(data_dir, tmp_path / "g.model", "g1.train", 3)
    for pkg, kw in ((jcont, {}), (pcont, {"device": "cpu"})):
        with pytest.raises(ValueError, match="convex-family"):
            pkg.retrain("gbdt", cfg, mode="ftrl", **kw)
    assert not os.path.exists(str(tmp_path / "g.model.retrain.lock"))


def test_gbdt_int8_warm_start_grows_the_reference_trees(tmp_path, data_dir,
                                                        monkeypatch):
    """retrain gbdt twice (bootstrap 4 rounds, then +3 on fresh rows) in
    int8 through both drivers: the same promotions and version records,
    the same tree structure, node values within the documented f32 ulps
    (ROADMAP.md section 3), the reference's held-out losses."""
    real = jgbdt_trainer.GBDTTrainer.__init__

    def int8_init(self, *a, **k):
        k.setdefault("hist_precision", "int8")
        real(self, *a, **k)

    monkeypatch.setattr(jgbdt_trainer.GBDTTrainer, "__init__", int8_init)
    out = {}
    for who, pkg, kw in (("jax", jcont, {}),
                         ("port", pcont, {"device": "cpu",
                                          "hist_precision": "int8"})):
        model = tmp_path / who / "g.model"
        res = []
        for train, rounds in (("g1.train", 4), ("g2.train", 4)):
            cfg = _gbdt_cfg(data_dir, model, train, rounds)
            cfg["optimization"]["loss_function"] = "l2"
            res.append(pkg.retrain("gbdt", cfg, extra_rounds=3, **kw))
        out[who] = (res, model.read_text(),
                    pkg.read_version(LocalFileSystem(), str(model)))
    (pres, ptext, pver), (jres, jtext, jver) = out["port"], out["jax"]
    assert [(r.promoted, r.version, r.trained["trees"]) for r in pres] == \
        [(r.promoted, r.version, r.trained["trees"]) for r in jres] == \
        [(True, 1, 4.0), (True, 2, 7.0)]
    assert _version_fields(pver) == _version_fields(jver)
    pm, jm = JModel.loads(ptext), JModel.loads(jtext)

    class _Res:
        def __init__(self, model):
            self.model = model

    assert pm.base_prediction == jm.base_prediction
    _assert_same_trees(_Res(pm), _Res(jm))
    for p, j in zip(pres, jres):
        np.testing.assert_allclose(p.gate.candidate_loss,
                                   j.gate.candidate_loss, rtol=1e-5)
    assert pres[1].gate.incumbent_loss == pytest.approx(
        jres[1].gate.incumbent_loss, rel=1e-5)
    # the archive of v1 is the bootstrap's model, in both
    assert (tmp_path / "port" / "g.model.v1").read_text().count("tree") == \
        (tmp_path / "jax" / "g.model.v1").read_text().count("tree")


@pytest.mark.parametrize("family", ["linear", "gbdt"])
def test_retrain_on_two_ranks_decides_as_one_device(tmp_path, data_dir,
                                                    family):
    """`retrain --devices 2` on the CPU (the candidate on two gloo ranks
    through the train launcher, the gates in this process): over a
    bootstrap and a warm retrain the same promote or reject decisions and
    version records as one device, every rank's report in the result; the
    GBDT int8 candidate, promoted, byte for byte the one-device model."""
    out = {}
    for tag, devices in (("one", None), ("two", ["cpu", "cpu"])):
        model = tmp_path / tag / ("g.model" if family == "gbdt"
                                  else "lr.model")
        rec = []
        for i, train in enumerate(("1.train", "2.train")):
            if family == "gbdt":
                cfg = _gbdt_cfg(data_dir, model, "g" + train, 4)
                kw = {"extra_rounds": 3, "hist_precision": "int8"}
            else:
                cfg = _linear_cfg(data_dir, model, train="d" + train,
                                  max_iter=2 if i == 0 else 12, band=0.02)
                kw = {}
            r = pcont.retrain(family, cfg, device="cpu", devices=devices,
                              **kw)
            rec.append((r.promoted, r.version, r.gate.passed,
                        r.gate.reasons, _version_fields(pcont.read_version(
                            LocalFileSystem(), str(model))),
                        [x["rank"] for x in r.ranks]))
        out[tag] = (rec, model)
    (one, m1), (two, m2) = out["one"], out["two"]
    assert [x[:5] for x in one] == [x[:5] for x in two]
    assert [x[5] for x in one] == [[], []]
    assert [x[5] for x in two] == [[0, 1], [0, 1]]
    if family == "gbdt":
        assert m2.read_bytes() == m1.read_bytes()
        assert (m2.parent / "g.model.v1").read_bytes() == \
            (m1.parent / "g.model.v1").read_bytes()


# -- the lock ------------------------------------------------------------------


def _write_owner(path, **owner):
    with open(path, "w") as f:
        json.dump(owner, f)


@pytest.mark.parametrize("owner,reclaim", [
    ("dead_pid", True), ("stale_heartbeat", True), ("unreadable", True),
    ("live_peer", False)])
def test_lock_reclaims_a_dead_or_stale_owner_as_the_reference(
        tmp_path, both_obs, owner, reclaim):
    outcomes = []
    for who, mod in (("port", pdriver), ("jax", jcont.driver)):
        path = str(tmp_path / f"{who}.retrain.lock")
        now = time.time()
        if owner == "dead_pid":
            _write_owner(path, pid=2 ** 22 + 12345, host=socket.gethostname(),
                         started_at=now, heartbeat_at=now)
        elif owner == "stale_heartbeat":
            _write_owner(path, pid=os.getppid(), host="elsewhere",
                         started_at=now - 2000, heartbeat_at=now - 1000)
        elif owner == "unreadable":
            with open(path, "w") as f:
                f.write("{not json")
        else:
            _write_owner(path, pid=os.getppid(), host=socket.gethostname(),
                         started_at=now, heartbeat_at=now)
        lock = mod.RetrainLock(LocalFileSystem(), path, ttl_s=60.0)
        try:
            lock.acquire()
        except RuntimeError as e:
            outcomes.append(("held", "another retrain holds" in str(e)))
            continue
        assert lock._beater is not None and lock._beater.is_alive()
        rec = json.load(open(path))
        assert rec["pid"] == os.getpid()
        beater = lock._beater
        lock.release()
        assert not beater.is_alive() and not os.path.exists(path)
        outcomes.append(("reclaimed", True))
    assert outcomes[0] == outcomes[1] == (
        ("reclaimed", True) if reclaim else ("held", True))
    if reclaim:
        assert obs.snapshot()["counters"]["continual.lock_reclaimed"] == \
            jobs.snapshot()["counters"]["continual.lock_reclaimed"] == 1


def test_retrain_leaves_no_thread_and_restores_obs(tmp_path, data_dir):
    import threading

    was = obs.enabled()
    obs.configure(enabled=False)
    try:
        before = {t.name for t in threading.enumerate()}
        cfg = _linear_cfg(data_dir, tmp_path / "lr.model", max_iter=2)
        assert pcont.retrain("linear", cfg, device="cpu").promoted
        assert not obs.enabled()
        after = {t.name for t in threading.enumerate()}
        assert "ytk-retrain-lock" not in after - before
    finally:
        obs.configure(enabled=was)


def test_cli_retrain_rollback_and_strict(tmp_path, data_dir, capsys):
    from ytklearn_tpu_torch import cli

    conf = tmp_path / "lr.conf"
    model = tmp_path / "lr.model"
    conf.write_text(json.dumps(_linear_cfg(data_dir, model, max_iter=2)))
    assert cli.main(["retrain", "linear", str(conf), "--device", "cpu"]) == 0
    r1 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r1["promoted"] and r1["version"] == 1
    assert cli.main(["retrain", "linear", str(conf), "--device", "cpu",
                     "--data", str(data_dir / "d2.train"),
                     "--set", "continual.band=0.5",
                     "--set", "optimization.line_search.lbfgs.convergence"
                     ".max_iter=12"]) == 0
    r2 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r2["promoted"] and r2["version"] == 2
    assert cli.main(["retrain", "linear", str(conf), "--rollback"]) == 0
    r3 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert r3["rolled_back"] and r3["version"] == 1
    # a strict rejection exits 1 with its JSON record
    with mock.patch.dict(os.environ, {"YTK_CONTINUAL_STRICT": "1",
                                      "YTK_CONTINUAL_BAND": "0"}):
        with mock.patch.object(pdriver, "_train_candidate",
                               lambda *a, **k: _corrupt_weights(
                                   str(model) + ".shadow") or {}):
            rc = cli.main(["retrain", "linear", str(conf), "--device",
                           "cpu", "--set", "continual.band=-1"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and out["promoted"] is False and out["strict"]
    # --devices 2 (refused until ROADMAP.md 1.7b): the candidate trains on
    # two gloo ranks, the gate runs here
    assert cli.main(["retrain", "linear", str(conf), "--device", "cpu",
                     "--devices", "2", "--set", "continual.band=0.5"]) == 0
    r5 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["rank"] for r in r5["ranks"]] == [0, 1]
    assert r5["trained"]["n_iter"] == 2 and "gate" in r5
    # --trace-out (refused until ROADMAP.md 1.12): a Chrome trace of the
    # retrain that loads and holds the driver's and the trainer's spans
    trace = tmp_path / "t.json"
    was = obs.enabled()
    try:
        assert cli.main(["retrain", "linear", str(conf), "--device", "cpu",
                         "--trace-out", str(trace)]) == 0
    finally:
        obs.configure(enabled=was, trace_path=None)
        obs.reset()
    r4 = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert "promoted" in r4
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"continual.train_candidate", "continual.holdout_eval",
            "train.load", "train.round", "lbfgs.iteration"} <= names
