"""The tuning and timing tools (ytklearn_tpu_torch/scripts/) as a user runs
them: `python -m ytklearn_tpu_torch.scripts.<tool>`. With `--device cpu`
and a small `--rows` each runs its control flow and spot checks on the
plain versions, exits 0 and prints "not measured" in place of every time;
with no `--device` on a machine without a GPU it raises (exit non-zero)
instead of timing the CPU."""

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


def _run(tool, *extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    return subprocess.run(
        [sys.executable, "-m", f"ytklearn_tpu_torch.scripts.{tool}",
         "--rows", "4096", *TOOLS[tool], *extra],
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
