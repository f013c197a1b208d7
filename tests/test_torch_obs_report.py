"""The port's obs_report (ytklearn_tpu_torch/scripts/obs_report.py) against
the JAX package's scripts/obs_report.py: the same text, byte for byte, and
the same exit code on every checked-in artifact whose kind it sniffs (and
on CHAOS_r18.json, which both reject), on a flight dump and a /metrics
snapshot the port writes here, and on a record of the port's prof_drill
(`--device cpu`), which is also checked as the reference's own PROF
artifact is."""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import build_gbdt, request_rows
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.obs import recorder
from ytklearn_tpu_torch.scripts import obs_report
from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACTS = ("PROF_r20.json", "TRACE_r17.json", "SERVE_r16.json",
             "SERVE_r22.json", "BENCH_r05.json", "DRIFT_r19.json",
             "MESH_r21.json", "CHAOS_r18.json")


def _reference():
    spec = importlib.util.spec_from_file_location(
        "reference_obs_report", os.path.join(REPO, "scripts",
                                             "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


def _render(mod, path):
    """(exit code, stdout, SystemExit message) of mod.main([path])."""
    buf = io.StringIO()
    msg = None
    with contextlib.redirect_stdout(buf):
        try:
            rc = mod.main([path])
        except SystemExit as e:
            rc, msg = 1, str(e.code)
    return rc, buf.getvalue(), msg


def _same(path):
    got = _render(obs_report, path)
    assert got == _render(REF, path)
    return got


@pytest.mark.parametrize("name", ARTIFACTS)
def test_checked_in_artifacts_render_as_the_reference(name):
    rc, out, msg = _same(os.path.join(REPO, name))
    if name == "CHAOS_r18.json":
        assert rc == 1 and msg.startswith("unrecognized artifact shape")
    else:
        assert rc == 0 and msg is None and out


def test_port_flight_dump_renders_as_the_reference(tmp_path):
    obs.reset()
    obs.configure(enabled=True)
    try:
        with obs.span("gbdt.train", rounds=2):
            with obs.span("gbdt.round", round=0):
                obs.inc("gbdt.rounds")
        obs.inc("compile.traces.backend_compile", 2)
        obs.inc("health.retrace")
        obs.event("health.retrace", site="serve.scorer",
                  culprits=[{"program": "serve.rung.8",
                             "kernel": "binned_walk[2]", "ms": 1.5}])
        obs.gauge("mem.gbdt.train.host_rss_peak_bytes", 2.0 ** 28)
        recorder.install(flight_dir=str(tmp_path))
        try:
            path = recorder.dump(reason="test_obs_report")
        finally:
            recorder.uninstall()
    finally:
        obs.configure(enabled=False)
        obs.reset()
    rc, out, _msg = _same(path)
    assert rc == 0 and "reason: test_obs_report" in out
    assert "health.retrace" in out


def test_port_metrics_snapshot_renders_as_the_reference(tmp_path):
    build_gbdt(tmp_path, n_trees=4, depth=3, seed=2)
    cfg = {"model": {"data_path": str(tmp_path / "gbdt.model")},
           "optimization": {"loss_function": "sigmoid"}}
    obs.reset()
    obs.configure(enabled=True)
    reg = ModelRegistry(ladder=(4, 16), device="cpu", watch_interval_s=0)
    try:
        reg.load("default", "gbdt", cfg)
        app = ServeApp(reg, BatchPolicy(max_batch=16, max_wait_ms=0.2))
        rng = np.random.RandomState(5)
        for n in (1, 5, 12):
            app.predict(request_rows(n, rng), timeout=60.0)
        obs.REGISTRY.enable_history(8)
        obs.REGISTRY.sample_history(now=100.0)
        doc = app.metrics_payload(history=True, models=True, prof=True)
        for b in app._batchers.values():
            b.close(drain=True)
    finally:
        reg.close()
        obs.REGISTRY.disable_history()
        obs.configure(enabled=False)
        obs.reset()
    path = tmp_path / "metrics.json"
    path.write_text(json.dumps(doc))
    rc, out, _msg = _same(str(path))
    assert rc == 0 and "serve" in out


def test_prof_drill_cpu_record_renders(tmp_path):
    """The port's drill on the CPU, rendered as the reference's test
    renders its checked-in PROF artifact."""
    rec = tmp_path / "prof.json"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_"))}
    env["PYTHONPATH"] = REPO
    r = subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.scripts.prof_drill",
         "--record", str(rec), "--device", "cpu", "--rows", "2000",
         "--trees", "3"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rc, out, _msg = _same(str(rec))
    assert rc == 0
    assert "profiling drill" in out
    assert "profiled phases" in out
    assert "compile ledger" in out
    assert "gbdt.train" in out
    with open(rec) as f:
        doc = json.load(f)
    assert doc["schema"] == "ytkprof_drill"
    assert doc["phase_coverage"] >= 0.9
    assert doc["retraces"] == 0
    assert doc["prof"]["kernels"]["top_kernels"]
    assert doc["ok"] and doc["device"] == "cpu"
    rows = sum(v["rows"] for v in doc["serve"]["rungs"].values())
    assert rows == doc["serve"]["rows_sent"]
