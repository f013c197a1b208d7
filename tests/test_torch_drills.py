"""The port's drills (ytklearn_tpu_torch/scripts/{trace_drill,drift_drill,
mesh_drill}.py) against the JAX package's scripts of the same names:

- the generators and model texts equal the reference's (drift's W_TRUE,
  its training lines and in-distribution and shifted rows; mesh's
  `_write_linear` tenants and request rows);
- the pure checkers (`_fleet_agrees`, `_feature_psi`, `_model_field`,
  `_check_conservation`) give the reference's answers on the same inputs;
- each drill runs end to end with `--device cpu` at small settings (the
  three at once, as chip_smoke.py runs them), holds its correctness
  checks, and its record renders byte for byte the same through the
  port's and the reference's obs_report.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_threads import ONE_THREAD_ENV

from ytklearn_tpu_torch.scripts import drift_drill as p_drift
from ytklearn_tpu_torch.scripts import mesh_drill as p_mesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_ref(name: str):
    import importlib.util

    path = os.path.join(REPO, "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_drift():
    return _load_ref("drift_drill")


@pytest.fixture(scope="module")
def ref_mesh():
    return _load_ref("mesh_drill")


def test_drift_generators_equal_the_reference(ref_drift, tmp_path):
    assert np.array_equal(ref_drift.W_TRUE, p_drift.W_TRUE)
    assert ref_drift.N_FEATS == p_drift.N_FEATS
    ref_drift._write_rows(str(tmp_path / "ref.ytk"), 300, 1)
    p_drift._write_rows(str(tmp_path / "port.ytk"), 300, 1)
    assert (tmp_path / "ref.ytk").read_bytes() == \
        (tmp_path / "port.ytk").read_bytes()
    for shift in (None, {0: 4.0, 1: 4.0}):
        a = ref_drift.gen_rows(np.random.RandomState(7), 40, shift=shift)
        b = p_drift.gen_rows(np.random.RandomState(7), 40, shift=shift)
        assert json.dumps(a) == json.dumps(b)


def test_mesh_tenants_and_rows_equal_the_reference(ref_mesh, tmp_path):
    assert ref_mesh.CONSERVED == p_mesh.CONSERVED
    for d in ("ref", "port"):
        (tmp_path / d).mkdir()
    for seed, name in enumerate(("hog", "calm", "steady")):
        rc = ref_mesh._write_linear(str(tmp_path / "ref"), name, seed)
        pc = p_mesh._write_linear(str(tmp_path / "port"), name, seed)
        assert (tmp_path / "ref" / f"{name}.model").read_bytes() == \
            (tmp_path / "port" / f"{name}.model").read_bytes()
        rconf, pconf = json.load(open(rc)), json.load(open(pc))
        assert os.path.basename(rconf["model"]["data_path"]) == \
            os.path.basename(pconf["model"]["data_path"])
        rconf["model"].pop("data_path")
        pconf["model"].pop("data_path")
        assert rconf == pconf
    assert ref_mesh._rows(np.random.RandomState(3), 5) == \
        p_mesh._rows(np.random.RandomState(3), 5)


def _quality_payload(psi):
    return {"models": {"default": {
        "psi_max": max(psi.values()), "rows_sampled": 10,
        "worst_features": sorted(psi, key=lambda k: -psi[k])[:2],
        "features": {k: {"psi": v, "ks": v / 2} for k, v in psi.items()}}}}


def test_drift_checkers_equal_the_reference(ref_drift):
    a = _quality_payload({"c0": 1.25, "c1": 0.5, "c2": 0.01})
    b = _quality_payload({"c0": 1.25, "c1": 0.5, "c2": 0.01})
    c = _quality_payload({"c0": 1.25, "c1": 0.75, "c2": 0.01})
    d = _quality_payload({"c0": 1.25, "c1": 0.5})
    for x, y in ((a, b), (a, c), (a, d), ({}, {}), (a, {})):
        fx, fy = x.get("models", {}), y.get("models", {})
        assert ref_drift._fleet_agrees(fx, fy) == \
            p_drift._fleet_agrees(fx, fy)
    assert p_drift._fleet_agrees(a["models"], b["models"])
    assert not p_drift._fleet_agrees(a["models"], c["models"])
    for q in (a, c, {}, {"models": {}}):
        assert ref_drift._feature_psi(q) == p_drift._feature_psi(q)
        for field in ("psi_max", "worst_features", "rows_sampled"):
            assert ref_drift._model_field(q, field) == \
                p_drift._model_field(q, field)
        assert ref_drift._fleet_field(q.get("models", {}), "psi_max") == \
            p_drift._fleet_field(q.get("models", {}), "psi_max")


def _replica(requests, per_model, **extra):
    counters = {"serve.requests": requests, **extra}
    return {"counters": counters, "model_metrics": {"models": {
        name: {"counters": c} for name, c in per_model.items()}}}


def test_conservation_checker_equals_the_reference(ref_mesh):
    cases = {
        "0": _replica(10.0, {"hog": {"requests": 6.0},
                             "calm": {"requests": 4.0}},
                      **{"serve.shed": 2.0}),
        "1": _replica(7.0, {"hog": {"requests": 3.0, "shed": 2.0}},
                      **{"serve.shed": 2.0}),
        "2": _replica(5.0, {"hog": {"requests": 5.0, "cache.hit": 1.0}}),
    }
    rf, pf = [], []
    got_r = ref_mesh._check_conservation(cases, rf)
    got_p = p_mesh._check_conservation(cases, pf)
    assert got_r == got_p and rf == pf
    assert not got_p["ok"] and len(pf) == 3


DRILLS = {
    "trace_drill": ["--seconds", "2", "--threads", "4", "--requests", "512"],
    "drift_drill": ["--rounds", "4", "--rows", "512",
                    "--overhead-seconds", "0.5"],
    "mesh_drill": ["--quiet-requests", "20", "--hog-requests", "20",
                   "--abuse-requests", "120"],
}


def _env(**over):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_", "SERVE_"))}
    env["PYTHONPATH"] = REPO
    env.update(ONE_THREAD_ENV)
    env.update(over)
    return env


@pytest.fixture(scope="module")
def drills(tmp_path_factory):
    """The three drills at once on the CPU -> {name: (rc, record path,
    stderr)}."""
    tmp = tmp_path_factory.mktemp("drills")
    procs = {}
    for name, args in DRILLS.items():
        rec = tmp / f"{name}.json"
        err = open(tmp / f"{name}.err", "w+")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{name}",
             "--device", "cpu", "--record", str(rec), *args],
            cwd=REPO, env=_env(SERVE_BENCH_TREES="20"),
            stdout=subprocess.DEVNULL, stderr=err), rec, err)
    out = {}
    try:
        for name, (p, rec, err) in procs.items():
            p.wait(timeout=400)
            err.seek(0)
            out[name] = (p.returncode, rec, err.read())
            err.close()
    finally:
        for p, _rec, _err in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _render(argv, env):
    return subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("name", sorted(DRILLS))
def test_drill_on_the_cpu_renders_in_both_reports(drills, name):
    rc, path, err = drills[name]
    rec = json.loads(path.read_text())
    assert rec["device"] == "cpu" and rec["card"] == "cpu"
    assert set(rec["kernel_launches"]) >= {"heap_walk", "binned_walk"}
    assert not any(rec["kernel_launches"].values())
    assert [set(f) for f in rec["floors"]] == [
        {"name", "value", "limit", "met"}]
    floor_met = rec["floors"][0]["met"]
    # a CPU run may miss its one speed floor; every other check holds
    assert rc == (0 if floor_met else 1), err[-3000:]
    assert len(rec["failures"]) == (0 if floor_met else 1), rec["failures"]
    if name == "trace_drill":
        s1 = rec["steps"]["traced_fleet"]
        assert s1["errors"] == 0 and 0.9 <= s1["p99_hop_share"] <= 1.1
        assert s1["replica_side"]["inside_forward"]
        assert rec["steps"]["slo_burn"]["event_in_dump"]
    elif name == "drift_drill":
        steps = rec["steps"]
        for rep in steps["shifted"]["replicas"].values():
            assert rep["drift_fired"] and rep["retraces"] == 0
        for rep in steps["in_distribution"]["replicas"].values():
            assert not rep["drift_fired"]
        assert steps["fleet_merge"]["agrees"]
    else:
        assert rec["conservation"]["ok"] and rec["burn_isolation"]["ok"]
        assert rec["flight"]["ok"]
    port = _render(["-m", "ytklearn_tpu_torch.scripts.obs_report",
                    str(path)], _env())
    ref = _render([os.path.join(REPO, "scripts", "obs_report.py"),
                   str(path)], _env(JAX_PLATFORMS="cpu"))
    assert port.returncode == 0 and ref.returncode == 0, (
        port.stderr[-2000:], ref.stderr[-2000:])
    assert port.stdout == ref.stdout
    assert "drill" in port.stdout
