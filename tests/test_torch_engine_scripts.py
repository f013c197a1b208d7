"""The engine's profile, micro and ablation scripts
(ytklearn_tpu_torch/scripts/{profile_gbdt,profile_engine,micro_engine,
ablate_engine}.py) as a user runs them: `python -m
ytklearn_tpu_torch.scripts.<script> <the reference's positional arguments>
--device cpu` at a tiny size. Each exits 0 and prints the reference's
lines, "not measured (cpu)" in place of every time; the profile scripts
print the profiling plane's report. The ablation writes its record (every
arm, its wave table and columns) and, with the quality band made
impossible (ABLATE_AUC_TOL=-1), exits 1 after writing it. With no
`--device` on a machine without a GPU each raises instead of timing the
CPU. tests/test_torch_engine_scripts_jax.py holds the scripts' trainers
against the JAX package's.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import ONE_THREAD_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {
    "profile_gbdt": ["3000", "2", "loss"],
    "profile_engine": ["3000", "2", "8", "loss", "15", "int8"],
    "micro_engine": ["5000"],
    "ablate_engine": ["4000", "b256", "goss", "wave32"],
}


def _run(script, *args, **env_over):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "ABLATE_", "YTK_"))}
    env["PYTHONPATH"] = REPO
    env.update(ONE_THREAD_ENV)
    env.update(env_over)
    return subprocess.run(
        [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{script}",
         *args], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_runs_on_the_cpu_without_times(script, tmp_path):
    rec = tmp_path / "ablate.json"
    out = _run(script, *SCRIPTS[script], "--device", "cpu",
               ABLATE_TREES="2", ABLATE_RECORD=str(rec))
    assert out.returncode == 0, out.stderr[-3000:]
    text = out.stdout
    assert "not measured (cpu)" in text and " ms" not in text
    # the plain versions run on the CPU: no kernel launched
    assert ('kernel launches: {"K1": 0, "K2": 0, "K3": 0, "K4": 0, '
            '"K5": 0} [cpu]') in text
    if script.startswith("profile"):
        line = next(ln for ln in text.splitlines()
                    if ln.startswith("policy=loss "))
        assert "trees=2 total=not measured (cpu) " \
               "trees/s=not measured (cpu) train_loss=" in line
        assert line.endswith("[cpu]")
        assert "profile.run" in text and "coverage" in text
        assert "gbdt.train" in text
    if script == "profile_engine":
        assert "wave=8 prec=int8 rows=3000" in text and "test_auc=" in text
        assert "tree nodes min/med/max:" in text
    if script == "micro_engine":
        labels = ["hist_wave N=16 bf16", "hist_wave N=32 bf16",
                  "route wave of 16", "grow full tree (255 leaves, wave 16)"]
        for label in labels:
            assert f"{label:40s} not measured (cpu)" in text
        assert "n=5000 n_pad=16384 [cpu]" in text
    if script == "ablate_engine":
        for cfg in ("b256", "goss", "wave32"):
            assert f"CONFIG {cfg}: steady=not measured (cpu) trees/s" in text
        record = json.loads(rec.read_text())
        assert record["n_rows"] == 4000 and record["device"] == "cpu"
        assert sorted(record["configs"]) == ["b256", "goss", "wave32"]
        for entry in record["configs"].values():
            assert entry["steady_trees_per_sec"] is None
            assert 0.5 < entry["auc"] <= 1.0
            assert entry["wave_columns"] == [
                "rows_scanned", "rows_needed", "splits", "hist_width",
                "rows_sampled"]
            waves = entry["last_tree_waves"]
            assert waves and all(len(w) == 5 and w[3] > 0 for w in waves)
            assert entry["scan_over_need"] >= 1.0
        assert record["configs"]["goss"]["time_stats"]["goss"] is True
        assert record["configs"]["b256"]["time_stats"]["goss"] is False


def test_ablation_band_failure_exits_1_after_the_record(tmp_path):
    """ABLATE_AUC_TOL=-1 asks a GOSS arm for an AUC one above the
    baseline's: the band fails, the record is written first, exit 1;
    the efb arm bundles the exclusive block and is no GOSS arm."""
    rec = tmp_path / "band.json"
    out = _run("ablate_engine", "4000", "b256", "goss", "efb", "--device",
               "cpu", ABLATE_TREES="2", ABLATE_RECORD=str(rec),
               ABLATE_AUC_TOL="-1")
    assert out.returncode == 1, out.stderr[-3000:]
    assert f"ablation record written: {rec}" in out.stdout
    assert "QUALITY BAND FAIL: goss AUC" in out.stderr
    assert "efb AUC" not in out.stderr
    record = json.loads(rec.read_text())
    assert sorted(record["configs"]) == ["b256", "efb", "goss"]
    assert "efb_plan" in record["configs"]["efb"]
    assert "efb_plan" not in record["configs"]["b256"]


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_script_without_device_needs_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is the card")
    from importlib import import_module

    mod = import_module(f"ytklearn_tpu_torch.scripts.{script}")
    with pytest.raises(Exception, match="(?i)cuda"):
        mod.main(SCRIPTS[script])


def _reference_ablate():
    """The JAX package's scripts/ablate_engine.py as a module (it imports
    JAX only inside its main)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "reference_ablate_engine",
        os.path.join(REPO, "scripts", "ablate_engine.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ablation_helpers_match_the_reference(tmp_path):
    """apply_env's arms (a leaked knob cleared), read_bench_record over
    every schema generation and wave_table, each against the reference
    script's own function; the band's baseline choice and NaN."""
    import numpy as np

    from ytklearn_tpu_torch.scripts import ablate_engine as port

    ref = _reference_ablate()
    saved = {k: os.environ.get(k) for k in port._AB_VARS}
    try:
        for cfg in ("b256", "nopart", "fused", "nofused", "goss", "efb",
                    "goss+efb", "wave64", "b64"):
            got = {}
            for apply in (port.apply_env, ref._apply_env):
                os.environ["YTK_PARTITION"] = "0"  # an earlier arm's leak
                apply(cfg)
                got[apply] = {k: os.environ.get(k) for k in port._AB_VARS}
            assert got[port.apply_env] == got[ref._apply_env], cfg
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v
    records = {
        "v1": {"value": 12.5, "auc": 0.9, "trees": 40},
        "v3": {"schema_version": 3, "value": 20.0, "health_events": 2,
               "obs": {"counters": {"gbdt.downgrade.total": 1}}},
        "wrapped": {"cmd": "bench", "rc": 0, "tail": "",
                    "parsed": {"schema_version": 2, "value": 7.0,
                               "obs": {"counters": {
                                   "health.nan_loss": 3}}}},
    }
    for name, rec in records.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(rec))
        assert port.read_bench_record(str(path)) == \
            ref.read_bench_record(str(path)), name
    wl = np.zeros((2, 6, 5), np.int64)
    wl[-1, :3] = [[100, 80, 2, 1, 0], [80, 40, 4, 2, 0], [40, 9, 1, 4, 3]]
    assert port.wave_table(wl) == ref.wave_table(wl)
    cfgs = {"b256": {"auc": 0.80}, "goss": {"auc": 0.796},
            "goss+efb": {"auc": float("nan")}}
    assert port.band_failures(cfgs, 0.005) == [
        "goss+efb AUC nan fell below b256 0.8000 - tol 0.005"]
    assert port.band_failures({"goss": {"auc": 0.1}}, 0.005) == []
    assert port.wave_of("wave42") == 42 and port.wave_of("b64") == 16
