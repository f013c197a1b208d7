"""Multi-process GBDT in the port (`cli train gbdt --coordinator`): two
processes, each ingesting its lines_avg shard, joined over gloo on the
CPU, against one process (tests/test_multiprocess.py::
test_two_process_gbdt_matches_single: the merged bins are approximate by
design, so the loss is held within rel 0.05) and against the JAX
package's two processes on the same shards (tests/mp_worker.py: equal
splits, the loss within rel 1e-5); only rank 0 writes the model, and it
reloads. The multi-process pieces underneath are held to the
JAX package's exactly, with the other processes' payloads fed through the
host gather: merge_quantile_candidates, merge_bins_multihost,
build_bins_global, the ingest's global missing-value fills, and
io/reader.py::shard_plan in every mode."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import ytklearn_tpu.parallel.collectives as jcoll
from ytklearn_tpu.config.params import ApproximateSpec as JSpec, \
    DataParams as JDataParams, GBDTParams as JParams
from ytklearn_tpu.gbdt import binning as jbin
from ytklearn_tpu.gbdt.data import GBDTIngest as JIngest
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.io.reader import shard_plan as jshard_plan

import ytklearn_tpu_torch.parallel.collectives as pcoll
import ytklearn_tpu_torch.parallel.mesh as pmesh
from ytklearn_tpu_torch import cli
from ytklearn_tpu_torch.config.params import ApproximateSpec, DataParams, \
    GBDTParams
from ytklearn_tpu_torch.gbdt import binning as pbin
from ytklearn_tpu_torch.gbdt.data import GBDTIngest
from ytklearn_tpu_torch.gbdt.tree import GBDTModel
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.io.reader import shard_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_case(tmp_path, n=240):
    """tests/test_multiprocess.py's lines and mp_worker.py's GBDT config."""
    rng = np.random.RandomState(5)
    lines = []
    for _ in range(n):
        x = rng.randn(4)
        y = int(x[0] * 1.2 - x[1] + 0.2 * rng.randn() > 0)
        feats = ",".join(f"f{j}:{x[j]:.5f}" for j in range(4))
        lines.append(f"1###{y}###{feats}")
    (tmp_path / "train.ytk").write_text("\n".join(lines) + "\n")
    cfg = {
        "data": {"train": {"data_path": str(tmp_path / "train.ytk")},
                 "test": {"data_path": ""}, "max_feature_dim": 8,
                 "assigned": False, "unassigned_mode": "lines_avg"},
        "model": {"data_path": "", "dump_freq": 0},
        "optimization": {"round_num": 3, "max_depth": 3, "max_leaf_cnt": 8,
                         "regularization": {"learning_rate": 0.3},
                         "min_child_hessian_sum": 1e-6,
                         "loss_function": "sigmoid", "eval_metric": []},
        "feature": {"approximate": [{"type": "sample_by_quantile",
                                     "max_cnt": 16}]},
    }
    conf = tmp_path / "gbdt.conf"
    conf.write_text(json.dumps(cfg))
    return conf


def _argv(conf, model):
    return ["train", "gbdt", str(conf), "--device", "cpu",
            "--set", f"model.data_path={model}"]


@pytest.fixture(scope="module")
def two_process(tmp_path_factory):
    """One `cli train gbdt` process and two `--coordinator` processes on the
    case (the JSON lines and the working directory)."""
    tmp_path = tmp_path_factory.mktemp("two_process")
    conf = _write_case(tmp_path)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(_argv(conf, tmp_path / "one" / "m.model")) == 0
    single = json.loads(buf.getvalue().strip().splitlines()[-1])
    # the rendezvous is a file: a port picked here could be taken by another
    # test's connection before rank 0 binds it
    rdv = "file://" + str(tmp_path / "rendezvous")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, errs = [], []
    for r in range(2):
        # stderr to files: a rank blocked on a full pipe while its peer waits
        # in a collective would hang the group
        ef = open(tmp_path / f"rank{r}.err", "w+")
        errs.append(ef)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.cli"]
            + _argv(conf, tmp_path / f"r{r}" / "m.model")
            + ["--coordinator", rdv, "--num-processes", "2",
               "--process-id", str(r), "--max-restarts", "1"],
            stdout=subprocess.PIPE, stderr=ef, env=env, text=True, cwd=REPO))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    err_text = []
    for r, (p, ef) in enumerate(zip(procs, errs)):
        ef.seek(0)
        err = ef.read()
        ef.close()
        assert p.returncode == 0, f"rank {r}:\n{err[-3000:]}"
        err_text.append(err)
    res = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    return single, res, err_text, tmp_path


def test_two_process_cli_matches_single(two_process):
    single, res, errs, tmp_path = two_process
    for err in errs:
        # --max-restarts is disabled under --coordinator, loudly
        assert "--max-restarts is per-process and unsafe" in err
    for r, rec in enumerate(res):
        assert rec["rank"]["rank"] == r and rec["rank"]["backend"] == "gloo"
        assert rec["trees"] == single["trees"] == 3
        # the global loss: every rank reports the same number
        assert rec["train_loss"] == res[0]["train_loss"]
        assert rec["rank"]["collectives"]["host_allgather"]["calls"] >= 4
        assert rec["rank"]["collectives"]["psum_scatter"]["calls"] > 0
    assert res[0]["train_loss"] == pytest.approx(single["train_loss"],
                                                 rel=0.05)
    assert (tmp_path / "r0" / "m.model").exists()
    assert not (tmp_path / "r1").exists()
    m = GBDTModel.loads((tmp_path / "r0" / "m.model").read_text())
    assert len(m.trees) == 3


def test_two_process_cli_matches_jax_two_process(two_process):
    """The port's two `--coordinator` processes against the JAX package's
    two processes (tests/mp_worker.py's gbdt mode, jax.distributed over
    the CPU) on the same lines and config: each process reads the same
    lines_avg shard and the bin merges are the reference's exactly, so the
    trees' split features, split values and children are equal; leaf
    values as the port's one-device trees are held to the JAX package's
    (rtol 1e-5 plus 1e-5 of the tree's largest value); the loss within
    rel 1e-5."""
    from test_multiprocess import _run

    _single, res, _errs, tmp_path = two_process
    want = _run("gbdt", tmp_path, 2)
    wm = JModel.loads(want["model_text"])
    gm = GBDTModel.loads((tmp_path / "r0" / "m.model").read_text())
    assert len(gm.trees) == len(wm.trees) == 3
    for a, b in zip(gm.trees, wm.trees):
        assert list(a.feat) == list(b.feat)
        assert list(a.left) == list(b.left)
        assert list(a.right) == list(b.right)
        np.testing.assert_array_equal(np.asarray(a.split, np.float64),
                                      np.asarray(b.split, np.float64))
        scale = max(float(np.abs(np.asarray(b.leaf_value)).max()), 1e-30)
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-5 * scale)
    assert res[0]["train_loss"] == pytest.approx(want["train_loss"],
                                                 rel=1e-5)


def test_non_gbdt_families_refuse_both_flags(tmp_path):
    """Every other family under --devices or --coordinator raises by ROADMAP
    item 1.7b before anything loads."""
    for name in ("linear", "fm", "gbmlr"):
        for extra in (["--devices", "2"],
                      ["--coordinator", "127.0.0.1:1"]):
            with pytest.raises(NotImplementedError, match="1.7b"):
                cli.main(["train", name, "no.conf"] + extra)


def test_merge_quantile_candidates_equal_reference():
    rng = np.random.RandomState(3)
    sets = [np.unique(rng.randn(n).astype(np.float32)) for n in (50, 80, 7)]
    masses = [50.0, 80.0, 7.0]
    for max_cnt in (4, 16, 255):
        np.testing.assert_array_equal(
            pbin.merge_quantile_candidates(sets, masses, max_cnt),
            jbin.merge_quantile_candidates(sets, masses, max_cnt))


def _shards(P, seed=9):
    """P processes' columns: discrete (no_sample), small-cardinality
    quantile (an exact union), wide quantile (GK summaries)."""
    rng = np.random.RandomState(seed)
    out = []
    for r in range(P):
        n = 300 + 40 * r
        X = np.stack([
            rng.randint(0, 6 + r, n).astype(np.float32),
            rng.randint(0, 5, n).astype(np.float32),
            rng.randn(n).astype(np.float32) * (1 + r),
            rng.exponential(size=n).astype(np.float32),
        ], axis=1)
        out.append((X, rng.rand(n).astype(np.float32) + 0.5))
    return out


def _gathered(monkeypatch, gather_mod, count_patch, fn, shards):
    """fn on every shard with the host gather fed every shard's payload:
    the payloads are taken from each shard alone first."""
    payloads = []
    count_patch()
    for X, w in shards:
        got = []

        def first(obj, got=got):
            got.append(obj)
            return [obj]

        monkeypatch.setattr(gather_mod, "host_allgather_objects", first)
        fn(X, w)
        payloads.append(got[0] if got else None)
    monkeypatch.setattr(gather_mod, "host_allgather_objects",
                        lambda obj: list(payloads))
    return [fn(X, w) for X, w in shards]


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_bins_global_equals_reference(monkeypatch, P, weighted):
    """build_bins on each shard, then merge_bins_multihost: the set union
    for discrete samplers, the exact union while it fits, the merged GK
    summaries past it; bit for bit the JAX package's."""
    names = ["d0", "q1", "q2", "q3"]
    kw = dict(max_cnt=8, use_sample_weight=weighted, alpha=0.5)
    pp = GBDTParams(approximate=[ApproximateSpec(cols="d*", type="no_sample"),
                                 ApproximateSpec(**kw)])
    jp = JParams(approximate=[JSpec(cols="d*", type="no_sample"),
                              JSpec(**kw)])
    shards = _shards(P)
    want = _gathered(
        monkeypatch, jcoll, lambda: monkeypatch.setattr(jax, "process_count",
                                                        lambda: P),
        lambda X, w: jbin.build_bins_global(X, w, jp, names), shards)
    got = _gathered(
        monkeypatch, pcoll, lambda: monkeypatch.setattr(pmesh,
                                                        "process_count",
                                                        lambda: P),
        lambda X, w: pbin.build_bins_global(X, w, pp, names), shards)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.values, b.values)
        np.testing.assert_array_equal(a.counts, b.counts)
        assert a.max_bins == b.max_bins
    # every process ends with the same bins
    for a in got[1:]:
        np.testing.assert_array_equal(a.values, got[0].values)


@pytest.mark.parametrize("spec", ["mean", "quantile@0.3", "value@2"])
def test_multiprocess_missing_fill_equals_reference(monkeypatch, spec):
    rng = np.random.RandomState(4)
    shards = []
    for r in range(3):
        X = rng.randn(200 + 30 * r, 5).astype(np.float32)
        X[rng.rand(*X.shape) < 0.2] = np.nan
        X[:, 4] = np.nan if r == 1 else X[:, 4]
        shards.append((X, None))
    pp, jp = GBDTParams(missing_value=spec), JParams(missing_value=spec)
    pp.data.max_feature_dim = jp.data.max_feature_dim = 5
    want = _gathered(
        monkeypatch, jcoll, lambda: monkeypatch.setattr(jax, "process_count",
                                                        lambda: 3),
        lambda X, w: JIngest(jp).compute_missing_fill(X), shards)
    got = _gathered(
        monkeypatch, pcoll, lambda: monkeypatch.setattr(pmesh,
                                                        "process_count",
                                                        lambda: 3),
        lambda X, w: GBDTIngest(pp).compute_missing_fill(X), shards)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("P", [1, 2, 3])
@pytest.mark.parametrize("assigned,mode", [(True, "lines_avg"),
                                           (False, "files_avg"),
                                           (False, "lines_avg")])
def test_shard_plan_equals_reference(tmp_path, monkeypatch, P, assigned,
                                     mode):
    for i in range(5):
        (tmp_path / f"part-{i}").write_text("1###0###a:1\n")
    paths = [str(tmp_path)]
    for r in range(P):
        monkeypatch.setattr(jax, "process_count", lambda: P)
        monkeypatch.setattr(jax, "process_index", lambda: r)
        want = jshard_plan(JFS(), JDataParams(assigned=assigned,
                                              unassigned_mode=mode), paths)
        monkeypatch.setattr(pmesh, "_CURRENT", pmesh.Mesh(
            rank=r, world=P, device=__import__("torch").device("cpu"),
            backend="gloo", shared_ingest=False))
        got = shard_plan(LocalFileSystem(), DataParams(
            assigned=assigned, unassigned_mode=mode), paths)
        assert (list(got[0]), got[1], got[2]) == (list(want[0]), want[1],
                                                  want[2])
    # one ingest (--devices) reads everything, whatever the world
    monkeypatch.setattr(pmesh, "_CURRENT", pmesh.Mesh(
        rank=1, world=4, device=__import__("torch").device("cpu"),
        backend="gloo", shared_ingest=True))
    assert shard_plan(LocalFileSystem(), DataParams(
        assigned=assigned, unassigned_mode=mode), paths) == (paths, 1, 0)
