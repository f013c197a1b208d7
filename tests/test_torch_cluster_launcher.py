"""The port's cluster launcher (ytklearn_tpu_torch/bin/cluster_optimizer.sh,
the JAX package's bin/cluster_optimizer.sh driving `python -m
ytklearn_tpu_torch.cli train ... --coordinator --num-processes
--process-id`):

- two CPU ranks exit 0, both rank-labelled in YTK_MASTER_LOG, and their
  int8 GBDT dump is byte for byte the dump of `cli train --devices 2
  --device cpu` (features of few distinct values, so each process's bin
  candidates are the global ones), its bin sidecar's edges equal;
- a rank that crashes makes the launch exit 1 (each rank's status is
  waited on alone), and a crash of rank 0 in the foreground ends it with
  rank 0's code (a stub interpreter through PYTHON stands in for the
  ranks);
- slave hosts with the loopback coordinator are refused with exit 2
  before any rank starts;
- the launcher starts the port's CLI, never the JAX package's.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np

from torch_threads import ONE_THREAD_ENV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCHER = os.path.join(REPO, "ytklearn_tpu_torch", "bin",
                        "cluster_optimizer.sh")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(tmp_path, **over):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_"))}
    env.update(ONE_THREAD_ENV)
    env["PYTHON"] = sys.executable
    env["YTK_COORDINATOR_PORT"] = str(_free_port())
    env["YTK_MASTER_LOG"] = str(tmp_path / "master.log")
    env.update(over)
    return env


def _write_case(tmp_path):
    """Lines of four features rounded to one decimal (a few dozen distinct
    values each, under max_cnt) and a small int8 GBDT config."""
    rng = np.random.RandomState(5)
    lines = []
    for _ in range(400):
        x = np.round(rng.randn(4), 1)
        y = int(x[0] * 1.2 - x[1] + 0.2 * rng.randn() > 0)
        feats = ",".join(f"f{j}:{x[j]:.1f}" for j in range(4))
        lines.append(f"1###{y}###{feats}")
    (tmp_path / "train.ytk").write_text("\n".join(lines) + "\n")
    cfg = {
        "data": {"train": {"data_path": str(tmp_path / "train.ytk")},
                 "test": {"data_path": ""}, "max_feature_dim": 8},
        "model": {"data_path": "", "dump_freq": 0},
        "optimization": {"round_num": 3, "max_depth": 3, "max_leaf_cnt": 8,
                         "regularization": {"learning_rate": 0.3},
                         "min_child_hessian_sum": 1e-6,
                         "loss_function": "sigmoid", "eval_metric": []},
        "feature": {"approximate": [{"type": "sample_by_quantile",
                                     "max_cnt": 255}]},
    }
    conf = tmp_path / "gbdt.conf"
    conf.write_text(json.dumps(cfg))
    return conf


TRAIN_ARGS = ["--device", "cpu", "--hist-precision", "int8"]


def test_two_cpu_ranks_dump_the_devices_2_model(tmp_path):
    conf = _write_case(tmp_path)
    out = subprocess.run(
        ["bash", LAUNCHER, "gbdt", str(conf), "2", *TRAIN_ARGS,
         "--set", f"model.data_path={tmp_path / 'launch' / 'm.model'}"],
        capture_output=True, text=True, env=_env(tmp_path), timeout=300,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    r0 = json.loads(out.stdout.strip().splitlines()[-1])
    assert r0["trees"] == 3 and r0["rank"]["rank"] == 0
    assert r0["rank"]["backend"] == "gloo"
    master = (tmp_path / "master.log").read_text()
    assert "[rank 0]" in master and "[rank 1]" in master, master[:2000]
    r1 = [json.loads(ln[len("[rank 1] "):]) for ln in master.splitlines()
          if ln.startswith("[rank 1] {")]
    assert len(r1) == 1 and r1[0]["rank"]["rank"] == 1
    assert r1[0]["trees"] == 3

    env = dict(os.environ, PYTHONPATH=REPO, **ONE_THREAD_ENV)
    env = {k: v for k, v in env.items() if not k.startswith(("JAX_", "XLA_"))}
    dev2 = subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "train", "gbdt",
         str(conf), *TRAIN_ARGS, "--devices", "2",
         "--set", f"model.data_path={tmp_path / 'dev2' / 'm.model'}"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert dev2.returncode == 0, dev2.stderr[-3000:]
    assert (tmp_path / "launch" / "m.model").read_bytes() == \
        (tmp_path / "dev2" / "m.model").read_bytes()
    # the bin sidecars hold equal edges (the processes' merged candidates
    # may carry 0.0 where the one ingest has -0.0)
    a, b = (json.loads((tmp_path / d / "m.model.bins.json").read_text())
            for d in ("launch", "dev2"))
    assert a == b


def _stub(tmp_path, rank_codes):
    """A stand-in interpreter: prints one line and exits with the code
    given for its --process-id."""
    stub = tmp_path / "stub.sh"
    cases = "\n".join(f"  {r}) echo '{{\"stub\": {r}}}'; exit {c} ;;"
                      for r, c in rank_codes.items())
    stub.write_text(
        "#!/usr/bin/env bash\n"
        "rank=''\n"
        "while (($#)); do\n"
        "  [[ $1 == --process-id ]] && rank=$2\n"
        "  shift\n"
        "done\n"
        f"case $rank in\n{cases}\nesac\n")
    stub.chmod(0o755)
    return str(stub)


def test_a_crashed_rank_fails_the_launch(tmp_path):
    env = _env(tmp_path, PYTHON=_stub(tmp_path, {0: 0, 1: 0, 2: 7}))
    out = subprocess.run(["bash", LAUNCHER, "gbdt", "x.conf", "3"],
                         capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 1, out.stderr
    master = (tmp_path / "master.log").read_text()
    assert '[rank 2] {"stub": 2}' in master
    assert '[rank 1] {"stub": 1}' in master
    assert out.stdout.strip().splitlines()[-1] == '{"stub": 0}'

    env = _env(tmp_path, PYTHON=_stub(tmp_path, {0: 5, 1: 0}))
    out = subprocess.run(["bash", LAUNCHER, "gbdt", "x.conf", "2"],
                         capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 5, out.stderr

    env = _env(tmp_path, PYTHON=_stub(tmp_path, {0: 0, 1: 0}))
    out = subprocess.run(["bash", LAUNCHER, "gbdt", "x.conf", "2"],
                         capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 0, out.stderr


def test_slave_hosts_with_a_loopback_coordinator_are_refused(tmp_path):
    env = _env(tmp_path, PYTHON=_stub(tmp_path, {0: 0, 1: 0}),
               YTK_SLAVE_HOSTS="worker-a worker-b")
    out = subprocess.run(["bash", LAUNCHER, "gbdt", "x.conf", "3"],
                         capture_output=True, text=True, env=env, timeout=60)
    assert out.returncode == 2
    assert "YTK_COORDINATOR_HOST" in out.stderr
    assert not (tmp_path / "master.log").exists()


def test_the_launcher_starts_the_port_cli():
    text = open(LAUNCHER).read()
    assert "-m ytklearn_tpu_torch.cli train" in text
    assert "ytklearn_tpu.cli" not in text
    assert 'REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)"' \
        in text
