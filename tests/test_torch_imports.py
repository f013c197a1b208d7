"""The port stands alone: no module of ytklearn_tpu_torch, and not
chip_smoke.py, imports JAX or anything of the JAX package ytklearn_tpu."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
import ytklearn_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "ytklearn_tpu_torch")


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "ytklearn_tpu")


def _port_modules():
    names = [ytklearn_tpu_torch.__name__]
    for info in pkgutil.walk_packages(ytklearn_tpu_torch.__path__,
                                      prefix="ytklearn_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def test_every_module_imports_without_jax_or_the_jax_package():
    mods = _port_modules()
    for m in ("serve.kernels", "cli", "cuda_build", "eval.metrics",
              "gbdt.binning", "gbdt.data", "gbdt.engine", "gbdt.hist",
              "gbdt.route", "gbdt.state", "gbdt.trainer", "io.fs",
              "io.reader", "scripts.tune_hist_kernel", "scripts.tune_hist",
              "scripts.micro_hist_gather", "scripts.tune_gbdt",
              "scripts.time_hist", "continual", "continual.driver",
              "continual.gates", "continual.online", "optimize.ftrl",
              "io.libsvm", "predict.base", "serve.fleet",
              "serve.fleet.front", "serve.fleet.worker",
              "serve.fleet.autoscaler", "scripts.chaos_drill",
              "obs.quality", "obs.profiler", "scripts.prof_drill",
              "scripts.obs_report", "parallel", "parallel.mesh",
              "parallel.collectives", "gbdt.feature_parallel", "gbdt.launch",
              "scripts.cross_check", "parallel.launch", "train_launch",
              "train", "boost", "optimize.blocked", "optimize.lbfgs",
              "models.base", "scripts.profile_gbdt",
              "scripts.profile_engine", "scripts.micro_engine",
              "scripts.ablate_engine"):
        assert f"ytklearn_tpu_torch.{m}" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules)))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    assert [m for m in loaded if _forbidden(m)] == []


def _py_files():
    for root, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_py_files()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_ast_has_no_jax_imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                in ("import_module",) and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                _forbidden(str(node.args[0].value)):
            bad.append(node.args[0].value)
    assert bad == []
