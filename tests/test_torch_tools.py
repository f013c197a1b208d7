"""The tuning and timing tools (ytklearn_tpu_torch/scripts/) as a user runs
them: `python -m ytklearn_tpu_torch.scripts.<tool>`. With `--device cpu`
and a small `--rows` each runs its control flow and spot checks on the
plain versions, exits 0 and prints "not measured" in place of every time;
with no `--device` on a machine without a GPU it raises (exit non-zero)
instead of timing the CPU. The bench cell (scripts/bench_gbdt.py) prints
JSON: its fields and GOSS's kept rows are checked at a tiny size, and its
GOSS resolution and quality band against bench.py's under the same
environment. The FM cell (scripts/bench_fm.py) runs at 4096 rows and hands
L-BFGS what bench.py::bench_fm hands it."""

import json
import os
import subprocess
import sys

import pytest
import torch

from torch_threads import ONE_THREAD_ENV

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
    env.update(ONE_THREAD_ENV)
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


FM_ROWS = ["--rows", "4096"]


def test_bench_fm_runs_on_the_cpu_and_repeats(tmp_path):
    """bench.py's FM cell at 4096 rows: the fields, no rate on the CPU;
    --repeats runs fresh processes and adds the medians."""
    path = tmp_path / "fm.json"
    out = _run("bench_fm", "--device", "cpu", "--repeats", "2", "--out",
               str(path), args=FM_ROWS)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    runs = [json.loads(x) for x in lines[:2]]
    summary = json.loads(lines[-1])
    assert json.loads(path.read_text()) == summary
    for rec in runs:
        assert rec["fm_examples_per_sec"] == "not measured (cpu)"
        assert (rec["rows"], rec["n_iter"], rec["card"]) == (4096, 12, "cpu")
        assert 0.0 < rec["fm_loss"] < 0.69
    assert summary["median"]["fm_examples_per_sec"] == "not measured (cpu)"


def test_bench_fm_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the script would time it")
    out = _run("bench_fm", args=FM_ROWS)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "fm_examples_per_sec" not in out.stdout


def test_bench_fm_is_bench_py_cell(monkeypatch):
    """The rows, labels, initial weights and row chunk bench.py::bench_fm
    hands its minimize_lbfgs are the port's, exactly, and the losses at w0
    and after the first two iterations agree at rtol 1e-4 (float32 sums
    in another order; the JAX side in float32, as bench.py runs). The
    cell has no regularization and starts at FM's zero-latent saddle, so
    later iterations part by more (5e-4 at the third)."""
    import dataclasses

    import jax
    import numpy as np

    import bench
    import ytklearn_tpu.optimize as jopt
    from ytklearn_tpu_torch.scripts import bench_fm

    n = 2048
    seen = []
    real = jopt.minimize_lbfgs

    def capture(fn, w0, config, **kw):
        losses = []
        kw["callback"] = lambda it, st: losses.append(float(st.loss)) \
            and False
        res = real(fn, w0, dataclasses.replace(config, max_iter=2), **kw)
        seen.append((np.asarray(w0), [np.asarray(a) for a in kw["batch"]],
                     kw["row_chunk"], losses))
        return res

    monkeypatch.setattr(jopt, "minimize_lbfgs", capture)
    monkeypatch.setenv("BENCH_FM_ROWS", str(n))
    with jax.enable_x64(False):
        bench.bench_fm()
    w0, batch, chunk, jlosses = seen[0]
    cell = bench_fm.Cell(n, torch.device("cpu"))
    for a, b in zip(batch, bench_fm.make_data(n)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(w0, cell.w0.numpy())
    assert chunk is None and cell.row_chunk is None
    plosses = []
    cell.run(2, callback=lambda it, st: plosses.append(st.loss) and False)
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-4)


def test_covertype_synth_writes_the_shape(tmp_path):
    """scripts/covertype_synth.py: 54 features a row (10 integer
    measurements and one column of each one-hot group named), 7 classes,
    the split's test labels returned; the same seed, the same text."""
    from ytklearn_tpu_torch.scripts import covertype_synth as cs

    assert subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.scripts.covertype_synth",
         str(tmp_path / "a"), "--rows", "600", "--test-rows", "200",
         "--seed", "5"], cwd=REPO, env={**os.environ, "PYTHONPATH": REPO},
        timeout=120).returncode == 0
    train, test, ytest = cs.write_split(str(tmp_path / "b"), 600, 200, 5)
    assert open(train).read() == (tmp_path / "a" / "train.txt").read_text()
    lines = open(test).read().splitlines()
    assert len(lines) == 200 == len(ytest)
    for line, y in zip(lines, ytest):
        w, label, feats = line.split("###")
        names = [kv.split(":")[0] for kv in feats.split(",")]
        assert w == "1" and int(label) == y and 0 <= y < cs.K
        assert names[:10] == [f"f{j}" for j in range(10)]
        assert 10 <= int(names[10][1:]) < 14 <= int(names[11][1:]) < 54
    assert len(set(ytest.tolist())) >= 4  # the classes overlap and mix
