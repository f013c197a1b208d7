"""The tuning and timing tools (ytklearn_tpu_torch/scripts/) as a user runs
them: `python -m ytklearn_tpu_torch.scripts.<tool>`. With `--device cpu`
and a small `--rows` each runs its control flow and spot checks on the
plain versions, exits 0 and prints "not measured" in place of every time;
with no `--device` on a machine without a GPU it raises (exit non-zero)
instead of timing the CPU. The bench cell (scripts/bench_gbdt.py) prints
JSON: its fields and GOSS's kept rows are checked at a tiny size, and its
GOSS resolution and quality band against bench.py's under the same
environment."""

import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {
    "tune_hist_kernel": [],
    "tune_hist": ["--chain", "2"],
    "micro_hist_gather": ["--divs", "8,64"],
    "tune_gbdt": ["--trees", "2", "--configs", "32:int8,64:int8,32:bf16"],
    "time_hist": [],
    "time_walk": ["--sweep", "--serve", "3"],
}


BENCH = ["--rows", "4096", "--test-rows", "1024", "--trees", "4"]


def _run(tool, *extra, args=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "BENCH_", "YTK_GOSS"))}
    env["PYTHONPATH"] = REPO
    args = ["--rows", "4096", *TOOLS[tool]] if args is None else args
    return subprocess.run(
        [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{tool}",
         *args, *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_without_times(tool):
    out = _run(tool, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines and "not measured (cpu)" in out.stdout
    assert " ms" not in out.stdout  # no CPU time printed as a device time
    assert all(line.endswith("[cpu]") for line in lines)
    if tool == "tune_hist_kernel":
        assert "u8 variant exact: True" in out.stdout
        assert "does not fit" in out.stdout
        assert sum(line.startswith("K8 ") for line in lines) == 9
    if tool == "micro_hist_gather":
        assert out.stdout.count("fused == gathered (exact): True") == 2
    if tool == "time_walk":
        assert "(exact: False)" not in out.stdout
        assert "time_walk: rung 4096:" in out.stdout
        assert sum(line.startswith("time_walk sweep:") for line in lines) > 0
        assert sum(line.startswith("time_walk serve:") for line in lines) == 2


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_raises_without_a_gpu(tool):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the tool would time it")
    out = _run(tool)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "not measured" not in out.stdout


def test_bench_gbdt_runs_on_the_cpu():
    """bench.py's cell at a tiny size: the fields, GOSS's kept rows a tree
    (ceil(0.2 n) + ceil(0.125 (n - ceil(0.2 n))) of the 4096 real rows),
    no band off the default cell, and no time on the CPU; --repeats runs
    fresh processes and adds the medians, --out writes the summary."""
    out = _run("bench_gbdt", "--device", "cpu", args=BENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(rec) >= {"trees_per_sec", "auc", "logloss", "trees", "source",
                        "goss", "goss_rows_per_tree", "band", "card"}
    assert rec["trees_per_sec"] == "not measured (cpu)"
    assert (rec["trees"], rec["source"], rec["goss"]) == \
        (4, "synthetic", "a=0.2,b=0.125")
    k_a = -(-4096 * 2 // 10)
    assert rec["goss_rows_per_tree"] == k_a + -(-(4096 - k_a) // 8) == 1230
    assert rec["band"] is None and rec["card"] == "cpu"
    assert 0.5 < rec["auc"] <= 1.0 and rec["logloss"] < 0.69


def test_bench_gbdt_repeats_in_fresh_processes(tmp_path):
    path = tmp_path / "bench.json"
    out = _run("bench_gbdt", "--device", "cpu", "--repeats", "2", "--out",
               str(path), args=BENCH)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 3
    summary = json.loads(lines[-1])
    assert json.loads(path.read_text()) == summary
    runs = [json.loads(x) for x in lines[:2]]
    assert summary["runs"] == runs and summary["repeats"] == 2
    assert runs[0]["auc"] == runs[1]["auc"] == summary["median"]["auc"]
    assert summary["median"]["trees_per_sec"] == "not measured (cpu)"


@pytest.mark.parametrize("env", [
    {}, {"BENCH_GOSS": "0"}, {"BENCH_GOSS": "off"},
    {"BENCH_GOSS": "0.3,0.2"}, {"BENCH_GOSS": "0.5"},
    {"YTK_GOSS_A": "0.4"}, {"YTK_GOSS_A": "0.4", "YTK_GOSS_B": "0.3"},
    {"YTK_GOSS_A": "0.4", "BENCH_GOSS": "0.25,0.1"},
])
def test_bench_gbdt_resolves_goss_as_bench_py(monkeypatch, env):
    import bench
    from ytklearn_tpu_torch.scripts import bench_gbdt

    for k in ("BENCH_GOSS", "YTK_GOSS_A", "YTK_GOSS_B"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench_gbdt.resolve_goss() == bench.resolve_goss()


@pytest.mark.parametrize("auc,logloss", [
    (0.9489, 0.3118), (0.9438, 0.3118), (0.9440, 0.3118), (0.9587, 0.30),
    (0.9590, 0.30), (0.95, 0.2917), (0.95, 0.2919), (0.95, 0.3319),
    (0.949614, 0.308781)])
@pytest.mark.parametrize("knobs_set", [False, True])
def test_bench_gbdt_band_is_bench_py_synthetic_band(auc, logloss,
                                                    knobs_set):
    import bench
    from ytklearn_tpu_torch.scripts import bench_gbdt

    assert bench_gbdt.quality_band(auc, logloss, knobs_set) == \
        bench.quality_band("synthetic", auc, logloss, knobs_set)
    assert bench_gbdt.SYNTH_BAND == bench.SYNTH_BAND
    assert bench_gbdt.SYNTH_AUC_HEADROOM == bench.SYNTH_AUC_HEADROOM
    assert bench_gbdt.BENCH_GOSS_DEFAULT == bench.BENCH_GOSS_DEFAULT


def test_bench_gbdt_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would time it")
    out = _run("bench_gbdt", args=BENCH)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and "trees_per_sec" not in out.stdout
