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
io/reader.py::shard_plan in every mode.

The convex families and GBST the same way: `cli train linear|gbmlr
--coordinator` as two processes on tests/mp_worker.py's lines and config,
within rel 1e-3 of one process (tests/test_multiprocess.py's bound) and
of the JAX package's two processes; tests/torch_mp_worker.py's linear and
gbst modes (mp_worker.py's runs in the port) give the CLI's numbers; at
world size 1 `--coordinator` dumps the one-process text byte for byte;
and DataIngest's merges (the feature counts, the transform statistics,
process 0's choice of the dict's source) equal the JAX package's with
the host gather fed by hand."""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from torch_threads import ONE_THREAD_ENV
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

from torch_mp_worker import mp_params, run_ranks

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
    env.update(ONE_THREAD_ENV)
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
    """Every other family trains under --devices and --coordinator (where
    both raised before they were ported): two gloo ranks of one launcher,
    and a one-process gloo group; each JSON line carries the ranks'
    reports and rank 0's dump is there."""
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
        write_gbst_case

    for name in ("linear", "fm", "gbmlr"):
        d = tmp_path / name
        if name == "gbmlr":
            cfg = write_gbst_case(str(d), 300, 80, 3, K=2, tree_num=1,
                                  max_iter=3)
        else:
            cfg = write_convex_case(str(d), name, 300, 80, 3, max_iter=3)
        conf = d / "c.conf"
        conf.write_text(json.dumps(cfg))
        for tag, extra in (("devices", ["--devices", "2"]),
                           ("coordinator", [
                               "--coordinator", "file://" + str(d / "rdv"),
                               "--num-processes", "1", "--process-id",
                               "0"])):
            model = d / tag / "model"
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert cli.main(["train", name, str(conf), "--device", "cpu",
                                 "--set", f"model.data_path={model}"]
                                + extra) == 0
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            assert line["model"] == name and model.exists()
            if tag == "devices":
                assert [r["rank"] for r in line["ranks"]] == [0, 1]
                assert all(r["collectives"]["psum"]["calls"] > 0
                           for r in line["ranks"])
            else:
                assert line["rank"]["backend"] == "gloo"
                assert line["rank"]["collectives"]["psum"]["calls"] > 0


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


# -- the convex families and GBST across processes -------------------------

SPARSE = {"linear": "linear", "gbmlr": "gbst"}  # family -> mp_worker mode


def _sparse_conf(tmp_path, name):
    """mp_worker.py's CommonParams of the mode as a `cli train` config."""
    cfg = {
        "data": {"train": {"data_path": str(tmp_path / "train.ytk")},
                 "test": {"data_path": ""}, "assigned": False,
                 "unassigned_mode": "lines_avg"},
        "model": {"data_path": ""},
        "loss": {"loss_function": "sigmoid", "evaluate_metric": []},
        "optimization": {"line_search": {"lbfgs": {"convergence": {
            "max_iter": 10 if name == "linear" else 6}}}},
    }
    if name == "gbmlr":
        cfg.update({"k": 2, "tree_num": 2})
    conf = tmp_path / f"{name}.conf"
    conf.write_text(json.dumps(cfg))
    return conf


def _sparse_argv(conf, name, model):
    return ["train", name, str(conf), "--device", "cpu",
            "--set", f"model.data_path={model}"]


@pytest.fixture(scope="module")
def two_sparse(tmp_path_factory):
    """For linear and gbmlr: one `cli train` process (here), two
    `--coordinator` processes, one `--coordinator` process at world size 1,
    tests/torch_mp_worker.py's mode at two ranks, and the JAX package's two
    processes (tests/mp_worker.py), on test_multiprocess.py's lines."""
    from test_multiprocess import _run, _write_data

    tmp_path = tmp_path_factory.mktemp("two_sparse")
    _write_data(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(ONE_THREAD_ENV)
    out = {}
    procs = []
    for name in SPARSE:
        conf = _sparse_conf(tmp_path, name)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(_sparse_argv(conf, name,
                                         tmp_path / name / "one")) == 0
        out[name] = {"one": json.loads(
            buf.getvalue().strip().splitlines()[-1])}
        for world in (2, 1):
            rdv = "file://" + str(tmp_path / f"{name}.w{world}.rdv")
            for r in range(world):
                # stderr to files: a rank blocked on a full pipe while its
                # peer waits in a collective would hang the group
                ef = open(tmp_path / f"{name}.w{world}.r{r}.err", "w+")
                argv = _sparse_argv(conf, name,
                                    tmp_path / name / f"w{world}r{r}")
                procs.append((name, world, r, ef, subprocess.Popen(
                    [sys.executable, "-m", "ytklearn_tpu_torch.cli"] + argv
                    + ["--coordinator", rdv, "--num-processes", str(world),
                       "--process-id", str(r)],
                    stdout=subprocess.PIPE, stderr=ef, env=env, text=True,
                    cwd=REPO)))
    try:
        # the JAX processes run while the port's do
        for name, mode in SPARSE.items():
            out[name]["jax2"] = _run(mode, tmp_path, 2)
        for name, world, r, ef, p in procs:
            o, _ = p.communicate(timeout=300)
            ef.seek(0)
            err = ef.read()
            assert p.returncode == 0, f"{name} w{world} r{r}:\n{err[-3000:]}"
            out[name][f"w{world}r{r}"] = json.loads(
                o.strip().splitlines()[-1])
    finally:
        for *_, ef, p in procs:
            ef.close()
            if p.poll() is None:
                p.kill()
    for name, mode in SPARSE.items():
        d = tmp_path_factory.mktemp(f"worker_{mode}")
        (d / "train.ytk").write_text((tmp_path / "train.ytk").read_text())
        out[name]["worker"] = run_ranks(mode, 2, str(d))
    return out, tmp_path


def _loss(rec):
    return rec["avg_loss"] if "avg_loss" in rec else rec["train_loss"]


@pytest.mark.parametrize("name", list(SPARSE))
def test_two_process_sparse_cli_matches_single(two_sparse, name):
    """Two processes on their lines_avg shards within rel 1e-3 of one
    process (test_multiprocess.py's bound); the ranks report the same
    global numbers; rank 0 dumps, rank 1 does not."""
    out, tmp_path = two_sparse
    r0, r1 = out[name]["w2r0"], out[name]["w2r1"]
    assert _loss(r0) == _loss(r1)
    assert [r0["rank"]["rank"], r1["rank"]["rank"]] == [0, 1]
    assert r0["rank"]["collectives"]["host_allgather"]["calls"] >= 2
    assert _loss(r0) == pytest.approx(_loss(out[name]["one"]), rel=1e-3)
    if name == "linear":
        assert r0["n_iter"] == out[name]["one"]["n_iter"] == 10
    else:
        assert r0["trees"] == out[name]["one"]["trees"] == 2
    assert (tmp_path / name / "w2r0").exists()
    assert not (tmp_path / name / "w2r1").exists()


@pytest.mark.parametrize("name", list(SPARSE))
def test_two_process_sparse_cli_matches_jax_two_process(two_sparse, name):
    out, _ = two_sparse
    want = out[name]["jax2"]
    key = "avg_loss" if name == "linear" else "train_loss"
    assert _loss(out[name]["w2r0"]) == pytest.approx(want[key], rel=1e-3)


@pytest.mark.parametrize("name", list(SPARSE))
def test_torch_mp_worker_modes_match_cli(two_sparse, name):
    """torch_mp_worker.py's linear and gbst modes are mp_worker.py's runs:
    the CLI config above parses to their params, and their two ranks give
    the two CLI processes' numbers."""
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.config.params import CommonParams

    out, tmp = two_sparse
    want = mp_params(CommonParams, str(tmp), SPARSE[name], 2)
    cfg = hocon.set_path(json.loads((tmp / f"{name}.conf").read_text()),
                         "model.data_path", want.model.data_path)
    got = CommonParams.from_config(cfg)
    got.raw = want.raw = None
    assert got == want
    for rec in out[name]["worker"]:
        assert _loss(rec) == _loss(out[name]["w2r0"])


@pytest.mark.parametrize("name", list(SPARSE))
def test_coordinator_world1_dumps_one_process_text(two_sparse, name):
    """A one-rank group's psums return their input and its chunking is
    one process's: the dump is the one-process dump byte for byte."""
    out, tmp_path = two_sparse
    one, w1 = tmp_path / name / "one", tmp_path / name / "w1r0"
    files = sorted(p.relative_to(one) for p in one.rglob("*") if p.is_file())
    assert files
    for rel in files:
        assert (w1 / rel).read_bytes() == (one / rel).read_bytes(), rel
    assert _loss(out[name]["w1r0"]) == _loss(out[name]["one"])


# -- DataIngest's merges against the JAX package's -------------------------


def _ingest_shards(tmp_path, P):
    """P processes' lines: overlapping feature names, values to
    standardise."""
    rng = np.random.RandomState(12)
    paths = []
    for r in range(P):
        lines = []
        for _ in range(60 + 15 * r):
            names = rng.choice(12 + 4 * r, 4, replace=False)
            feats = ",".join(f"g{j}:{rng.randn() * (1 + r):.4f}"
                             for j in names)
            lines.append(f"1###{rng.randint(2)}###{feats}")
        path = tmp_path / f"shard{r}.txt"
        path.write_text("\n".join(lines) + "\n")
        paths.append(str(path))
    return paths


def _ingest_cfg(tmp_path, path, dict_path=""):
    # assigned: each process reads the whole file it is given
    return {"data": {"train": {"data_path": path},
                     "test": {"data_path": ""}, "assigned": True},
            "model": {"data_path": str(tmp_path / "m"),
                      "need_dict": bool(dict_path), "dict_path": dict_path},
            "feature": {"filter_threshold": 2,
                        "transform": {"switch_on": True,
                                      "mode": "standardization"}}}


def _processes(monkeypatch, P, r):
    """This process is r of P, for the mesh and the collectives."""
    for mod in (pmesh, pcoll):
        monkeypatch.setattr(mod, "process_count", lambda: P)
        monkeypatch.setattr(mod, "process_index", lambda: r)


def _fed_ingests(monkeypatch, gather_mod, P, make, load):
    """Each process's DataIngest `load` (_load_python or _load_fast) with
    the host gather fed by hand:
    a first pass records each process's payloads in call order, then the
    k-th gather of every process returns every process's k-th payload."""
    payloads = []
    for r in range(P):
        rec = []

        def first(obj, rec=rec):
            rec.append(obj)
            return [obj]

        monkeypatch.setattr(gather_mod, "host_allgather_objects", first)
        getattr(make(r), load)()
        payloads.append(rec)
    out = []
    for r in range(P):
        k = iter(range(len(payloads[0])))

        def every(obj, k=k):
            i = next(k)
            return [pl[i] for pl in payloads]

        monkeypatch.setattr(gather_mod, "host_allgather_objects", every)
        out.append(getattr(make(r), load)())
    return out, payloads


@pytest.mark.parametrize("P", [2, 3])
@pytest.mark.parametrize("native", [False, True])
def test_ingest_merges_equal_reference(tmp_path, monkeypatch, P, native):
    """The feature dict from every process's counts and the transform
    nodes from every process's statistics (the reference's _merge_counts
    and nodes_from_stats union) equal the JAX package's, both parsers; so
    do the ELL rows; every process ends with the same dict. Only process 0
    writes the transform sidecar."""
    from ytklearn_tpu.config.params import CommonParams as JCommon
    from ytklearn_tpu.io import reader as jreader
    from ytklearn_tpu_torch.config.params import CommonParams
    from ytklearn_tpu_torch.io import reader as preader

    load = "_load_fast" if native else "_load_python"
    paths = _ingest_shards(tmp_path, P)
    monkeypatch.setattr(jax, "process_count", lambda: P)
    want, wpay = _fed_ingests(monkeypatch, jcoll, P, lambda r: (
        jreader.DataIngest(JCommon.from_config(_ingest_cfg(tmp_path / "j",
                                                           paths[r])))),
        load)
    _processes(monkeypatch, P, 0)
    got, gpay = _fed_ingests(monkeypatch, pcoll, P, lambda r: (
        _processes(monkeypatch, P, r)
        or preader.DataIngest(CommonParams.from_config(_ingest_cfg(
            tmp_path / f"p{r}", paths[r])))), load)
    # process 0's dict-source choice, the counts, the statistics: the
    # payloads themselves agree
    assert len(gpay[0]) == len(wpay[0]) == 3
    for g, w in zip(gpay, wpay):
        assert g[:2] == w[:2]
        assert set(g[2]) == set(w[2])
    for g, w in zip(got, want):
        assert g.feature_map == w.feature_map
        assert set(g.transform_nodes) == set(w.transform_nodes)
        for i, node in w.transform_nodes.items():
            assert str(g.transform_nodes[i]) == str(node)
        np.testing.assert_array_equal(g.train.idx, w.train.idx)
        np.testing.assert_array_equal(g.train.val, w.train.val)
    for g in got[1:]:
        assert g.feature_map == got[0].feature_map
    side = [(tmp_path / f"p{r}" / "m_feature_transform_stat").exists()
            for r in range(P)]
    assert side == [True] + [False] * (P - 1)


def test_dict_source_is_process0s_choice(tmp_path, monkeypatch):
    """need_dict with a dict file only process 0's storage holds: process 0
    picks the branch and reads the names, every process takes them (the
    reference's load_on_rank0), and the dict equals the JAX package's."""
    from ytklearn_tpu.config.params import CommonParams as JCommon
    from ytklearn_tpu.io import reader as jreader
    from ytklearn_tpu_torch.config.params import CommonParams
    from ytklearn_tpu_torch.io import reader as preader

    paths = _ingest_shards(tmp_path, 2)
    dict_file = tmp_path / "names.dict"
    dict_file.write_text("g3\ng1\ng7\n")
    jres = jreader.DataIngest(JCommon.from_config(_ingest_cfg(
        tmp_path / "j", paths[0], str(dict_file)))).load()
    # process 1: the gather hands it process 0's values (the branch, then
    # the names); its own storage has no dict file
    sent = [[str(dict_file)], ["g3", "g1", "g7"]]
    calls = []

    def from_rank0(obj):
        calls.append(obj)
        i = len(calls) - 1
        # later gathers (the transform statistics) see two equal processes
        return [sent[i], obj] if i < len(sent) else [obj, obj]

    _processes(monkeypatch, 2, 1)
    monkeypatch.setattr(pcoll, "host_allgather_objects", from_rank0)
    cfg = _ingest_cfg(tmp_path / "p1", paths[1], str(tmp_path / "absent"))
    pres = preader.DataIngest(CommonParams.from_config(cfg)).load()
    assert calls[:2] == [None, None]  # process 1 read nothing itself
    assert pres.feature_map == jres.feature_map
