"""One gloo rank of the port's multi-rank CPU tests (tests/test_torch_
collectives.py, test_torch_mesh_gbdt.py, test_torch_mesh_convex.py,
test_torch_mesh_gbst.py, test_torch_multiprocess.py): the reference's mp_worker.py pattern, one
python process a rank.

    python tests/torch_mp_worker.py <rank> <world> <rendezvous> <mode> <dir>

joins a gloo group of `world` ranks at the rendezvous (a file:// URL in
<workdir>: no port to race for while other tests start groups), runs every
case of `mode` and pickles its results to <workdir>/<mode>.rank<r>.pkl.
It imports the port only; the data makers below are shared with the tests,
which feed the same arrays to the JAX package.

Modes: `collectives`, `gbdt` and `convex` (every case of
<workdir>/cases.json, the convex families and GBST) run the reference's
one-process mesh: each rank sees every row and keeps its block. `linear`
and `gbst` mirror the reference's tests/mp_worker.py: each rank is a
process that ingests its lines_avg shard of <workdir>/train.ytk.
"""

from __future__ import annotations

import os
import pickle
import sys
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# -- inputs shared with the tests ------------------------------------------


def coll_inputs(world: int, seed: int = 7):
    """Per-rank inputs of the collective cases, (world, ...) stacked."""
    rng = np.random.RandomState(seed + world)
    scores = np.array([1.0, 5.0, 3.0, 5.0, 2.0, 0.0, 5.0, 4.0],
                      np.float32)[:world]
    return {
        "f": rng.randn(world, 5).astype(np.float32),
        "i": rng.randint(-1000, 1000, size=(world, 5)).astype(np.int32),
        "sc0": rng.randn(world, world * 2, 3).astype(np.float32),
        "sc1": rng.randint(-50, 50, size=(world, 2, world * 3, 4)).astype(
            np.int32),
        "sc1f": rng.randn(world, 2, world * 3, 4).astype(np.float32),
        "ag": rng.randn(world, 3, 2).astype(np.float32),
        # (world, 4) scores per node: ties at the max, NaNs, all-NaN nodes
        "tie": np.stack([scores] * 4, axis=1),
        "nan_all": np.full((world, 4), np.nan, np.float32),
        "nan_part": np.where(np.arange(world)[:, None] % 2 == 0, np.nan,
                             rng.randn(world, 4)).astype(np.float32),
        "pay_f": (np.arange(world * 4, dtype=np.float32).reshape(world, 4)
                  * 10 + 7),
        "pay_i": np.arange(world * 4, dtype=np.int32).reshape(world, 4),
        "inf_score": np.array([1.0, 9.0, 2.0, 3.0, 0.5, 1.5, 2.5, 3.5],
                              np.float32)[:world, None].repeat(4, 1),
        "inf_pay": np.where(np.arange(world)[:, None] == 1, 42.0,
                            -np.inf).astype(np.float32).repeat(4, 1),
    }


EVAL_METRICS = ["auc", "rmse", "mae", "mape", "smape", "confusion_matrix"]


def eval_inputs(n=1003, K=5, seed=9):
    """Metric inputs of n rows: binary predictions and labels with unit
    and integer weights, positive regression labels (mape divides by
    them), and (n, K) class probabilities with one-hot labels."""
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, K).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    return {
        "pred": rng.rand(n).astype(np.float32),
        "y": (rng.rand(n) < 0.4).astype(np.float32),
        "y_reg": (1.0 + rng.rand(n)).astype(np.float32),
        "w_unit": np.ones(n, np.float32),
        "w_int": rng.randint(1, 4, n).astype(np.float32),
        "prob": prob.astype(np.float32),
        "onehot": np.eye(K, dtype=np.float32)[rng.randint(0, K, n)],
    }


def eval_block(arr, rank: int, world: int):
    """This rank's contiguous block of the rows padded with zeros (weight
    0, label 0) to a multiple of the world."""
    n = len(arr)
    k = -(-n // world)
    out = np.zeros((k * world,) + arr.shape[1:], arr.dtype)
    out[:n] = arr
    return out[rank * k:(rank + 1) * k]


def engine_data(n=1600, F=6, seed=5):
    """tests/test_gbdt_engine.py::_data."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    logit = X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) + 0.5 * (X[:, 3] > 0)
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def sparse_data(n=1600, F_dense=3, F_excl=5, seed=5):
    """tests/test_goss_efb.py::_sparse_data."""
    rng = np.random.RandomState(seed)
    Xd = rng.randn(n, F_dense).astype(np.float32)
    grp = rng.randint(0, F_excl, n)
    Xs = np.zeros((n, F_excl), np.float32)
    Xs[np.arange(n), grp] = rng.rand(n).astype(np.float32) + 0.25
    X = np.concatenate([Xd, Xs], axis=1)
    logit = (X[:, 0] * X[:, 1] + 1.5 * X[:, F_dense]
             - 1.2 * X[:, F_dense + 2] + 0.8 * X[:, F_dense + 3])
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def fp_data(n=3000, F=10, seed=3):
    """tests/test_feature_parallel.py::_data."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 12, size=(n, F)).astype(np.float32)
    logit = 1.2 * (X[:, 0] > 6) - 0.9 * (X[:, 1] < 4) + 0.4 * (X[:, 2] > 8)
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y


def goss_case(world: int):
    """tests/test_goss_efb.py::test_goss_mesh8_matches_manual_union's case
    at `world` shards: bins, g, h and the hand-computed union of each
    contiguous shard's top ceil(n_loc / 2) rows by |g|."""
    rng = np.random.RandomState(11)
    n, F, B = 2048, 8, 16
    n_loc = n // world
    bins = rng.randint(0, B, size=(F, n)).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = np.ones((n,), np.float32)
    keep = np.zeros((n,), bool)
    k = int(np.ceil(0.5 * n_loc))
    for s in range(world):
        sl = np.arange(s * n_loc, (s + 1) * n_loc)
        top = np.argsort(-np.abs(g[sl]), kind="stable")[:k]
        keep[sl[top]] = True
    return bins, g, h, keep, F, B


# kwargs of the trainer cases: (data, params overrides, trainer kwargs, env)
ENGINE_PARAMS = dict(round_num=3, max_leaf_cnt=12, learning_rate=0.3,
                     min_child_hessian_sum=1.0, loss_function="sigmoid",
                     eval_metric=["auc"])
GBDT_CASES = {
    "int8_loss": ("engine", dict(tree_grow_policy="loss", max_depth=20),
                  dict(wave=4, hist_precision="int8"), {}),
    "int8_part": ("engine2560", dict(tree_grow_policy="loss", max_depth=20,
                                     round_num=2, max_leaf_cnt=16),
                  dict(wave=4, hist_precision="int8"),
                  {"YTK_PARTITION": "1"}),
    "f32_level": ("engine", dict(tree_grow_policy="level", max_depth=4),
                  dict(wave=4, hist_precision="f32"), {}),
    "f32_loss": ("engine", dict(tree_grow_policy="loss", max_depth=20),
                 dict(wave=4, hist_precision="f32"), {}),
    "efb": ("sparse", dict(tree_grow_policy="loss", max_depth=20,
                           round_num=2),
            dict(wave=4, hist_precision="int8", efb=True), {}),
    "feature": ("fp", dict(tree_grow_policy="level", max_depth=4,
                           max_leaf_cnt=0, tree_maker="feature"),
                dict(), {}),
}


def case_data(kind: str):
    if kind == "engine":
        return engine_data()
    if kind == "engine2560":
        return engine_data(n=2560)
    if kind == "sparse":
        return sparse_data()
    return fp_data()


def case_params(cls_params, approx_cls, model_cls, kind: str, over: dict,
                path: str):
    """GBDTParams of a case for either package (the classes passed in)."""
    kw = dict(ENGINE_PARAMS)
    kw["approximate"] = ([approx_cls(type="no_sample")] if kind == "fp"
                         else [approx_cls(max_cnt=32)])
    kw["model"] = model_cls(data_path=path, dump_freq=0)
    kw.update(over)
    return cls_params(**kw)


def tree_fields(model) -> list:
    return [{k: list(getattr(t, k)) for k in (
        "feat", "left", "right", "split", "leaf_value", "sample_cnt", "gain",
        "hess_sum")} for t in model.trees]


# -- the rank's side --------------------------------------------------------


def _collectives(rank, world, mesh):
    import torch

    from ytklearn_tpu_torch.obs import collective_census, \
        reset_collective_census
    from ytklearn_tpu_torch.parallel import collectives as coll
    from ytklearn_tpu_torch.parallel.mesh import Mesh, equal_row_target

    inp = coll_inputs(world)
    t = {k: torch.from_numpy(np.ascontiguousarray(v[rank]))
         for k, v in inp.items()}
    reset_collective_census()
    out = {
        "psum_f": coll.psum(t["f"], mesh),
        "psum_i": coll.psum(t["i"], mesh),
        "pmax_f": coll.pmax(t["f"], mesh),
        "pmin_i": coll.pmin(t["i"], mesh),
        "scatter0": coll.psum_scatter(t["sc0"], mesh, scatter_dimension=0),
        "scatter1": coll.psum_scatter(t["sc1"], mesh, scatter_dimension=1),
        "scatter1f": coll.psum_scatter(t["sc1f"], mesh, scatter_dimension=1),
        "gather": coll.all_gather(t["ag"], mesh),
    }
    for name, sc in (("tie", "tie"), ("nan_all", "nan_all"),
                     ("nan_part", "nan_part")):
        best, (pf, pi) = coll.pargmax_tuple(t[sc], (t["pay_f"], t["pay_i"]),
                                            mesh)
        out[f"pargmax_{name}"] = (best, pf, pi)
    best, (pf,) = coll.pargmax_tuple(t["inf_score"], (t["inf_pay"],), mesh)
    out["pargmax_inf"] = (best, pf)
    out["census"] = collective_census()
    out.update(_eval(rank, world, mesh))
    # the host verbs, as --coordinator ranks run them
    own = Mesh(rank=rank, world=world, device=torch.device("cpu"),
               backend=mesh.backend, shared_ingest=False)
    import ytklearn_tpu_torch.parallel.mesh as pm

    pm._CURRENT = own
    out["allgather_objects"] = coll.host_allgather_objects(
        {"rank": rank, "s": "x" * rank})
    out["load_on_rank0"] = coll.load_on_rank0(lambda: f"read by {rank}")
    out["census_host"] = collective_census().get("host_allgather")
    out["equal_row_target"] = equal_row_target(100 + 37 * rank, own, 8)
    out["equal_row_target_shared"] = equal_row_target(1000, mesh, 8)
    from ytklearn_tpu_torch.resilience import ChaosError, reset_chaos

    os.environ["YTK_CHAOS"] = "collective.host:error:1:0"
    reset_chaos()
    try:
        coll.host_allgather_objects(rank)
        out["chaos"] = None
    except ChaosError as e:
        out["chaos"] = str(e)
    finally:
        os.environ.pop("YTK_CHAOS", None)
        reset_chaos()
    pm._CURRENT = mesh
    return {k: _np(v) for k, v in out.items()}


def _eval(rank, world, mesh):
    """The metrics over every rank's block of eval_inputs: the psummed AUC
    histograms and EvalSet(mesh=...)."""
    import torch

    from ytklearn_tpu_torch.eval import EvalSet, auc_histogram
    from ytklearn_tpu_torch.parallel import collectives as coll

    t = {k: torch.from_numpy(eval_block(v, rank, world))
         for k, v in eval_inputs().items()}
    out = {}
    for w in ("w_unit", "w_int"):
        out[f"auc_hist_{w}"] = coll.psum(
            auc_histogram(t["pred"], t["y"], t[w]), mesh)
    ev = EvalSet(EVAL_METRICS)
    out["eval_binary"] = ev.evaluate(t["pred"], t["y"], t["w_int"],
                                     mesh=mesh)
    out["eval_reg"] = ev.evaluate(t["pred"], t["y_reg"], t["w_unit"],
                                  mesh=mesh)
    out["eval_multi"] = EvalSet(["auc", "confusion_matrix"], K=5).evaluate(
        t["prob"], t["onehot"], t["w_int"], mesh=mesh)
    return out


def _np(v):
    import torch

    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, tuple):
        return tuple(_np(x) for x in v)
    return v


def _gbdt(rank, world, mesh, workdir):
    import torch

    from ytklearn_tpu_torch.config.params import ApproximateSpec, \
        GBDTParams, ModelParams
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.engine import GrowSpec, grow
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    out = {}
    for name, (kind, over, tkw, env) in GBDT_CASES.items():
        X, y = case_data(kind)
        path = os.path.join(workdir, f"{name}.w{world}.r{rank}", "m.model")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        p = case_params(GBDTParams, ApproximateSpec, ModelParams, kind, over,
                        path)
        data = GBDTData(X=X, y=y, weight=np.ones(len(y), np.float32),
                        n_real=len(y),
                        feature_names=[f"f{i}" for i in range(X.shape[1])])
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            res = GBDTTrainer(p, device="cpu", mesh=mesh, **tkw).train(
                train=data)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        out[name] = {"trees": tree_fields(res.model),
                     "train_loss": res.train_loss,
                     "auc": res.train_metrics.get("auc"),
                     "dumped": os.path.exists(path)}
    # GOSS at the engine: this rank's shard of goss_case
    bins, g, h, _keep, F, B = goss_case(world)
    n_loc = len(g) // world
    sl = slice(rank * n_loc, (rank + 1) * n_loc)
    spec = GrowSpec(F=F, B=B, max_nodes=15, wave=2, policy="loss",
                    max_depth=10, max_leaves=8, lr=0.3, l1=0.0, l2=1.0,
                    min_h=1.0, max_abs=0.0, min_split_loss=0.0,
                    min_split_samples=0.0, hist_mode="int8", bm=128,
                    goss_a=0.5, goss_b=0.0)
    tr, _pos, aux_pos, _w = grow(
        spec, torch.from_numpy(np.ascontiguousarray(bins[:, sl])),
        torch.ones(n_loc, dtype=torch.bool), torch.from_numpy(g[sl]),
        torch.from_numpy(h[sl]), torch.ones(F, dtype=torch.bool),
        mesh=mesh)
    out["goss"] = {k: getattr(tr, k).numpy() for k in (
        "feat", "slot", "slot_r", "left", "right", "leaf", "cnt")}
    out["goss"]["n_nodes"] = int(tr.n_nodes)
    out["goss"]["pos"] = aux_pos[0].numpy()
    return out


def train_record(res) -> dict:
    """What the tests compare of a TrainResult or a BoostResult."""
    out = {k: getattr(res, k) for k in (
        "n_iter", "status", "avg_loss", "test_loss", "n_trees",
        "train_loss", "train_metrics", "test_metrics") if hasattr(res, k)}
    if hasattr(res, "history"):
        out["history"] = [r["avg_loss"] for r in res.history]
    return out


def _convex(rank, world, mesh, workdir):
    """Every case of cases.json ({name: [family, cfg]}) trained on this
    rank's block of the rows, each rank pointed at <name>.w<world>.r<rank>
    (only rank 0 dumps)."""
    import json

    from ytklearn_tpu_torch.train_launch import make_trainer

    with open(os.path.join(workdir, "cases.json")) as f:
        cases = json.load(f)
    out = {}
    for name, (family, cfg) in cases.items():
        cfg["model"]["data_path"] = os.path.join(
            workdir, f"{name}.w{world}.r{rank}", "model")
        out[name] = train_record(make_trainer(family, cfg, device="cpu",
                                              mesh=mesh).train())
    # a SIGTERM that reaches the last rank alone stops every rank at the
    # same boundary (after iteration 2; before tree 1)
    for name, marker in (("linear", "[iter=2]"), ("gbmlr", "[tree=0]")):
        if name not in cases:
            continue
        family, cfg = cases[name]
        out[f"preempt_{name}"] = _preempted(
            rank, world, mesh, workdir, f"preempt_{name}", family,
            json.loads(json.dumps(cfg)), marker)
    return out


def _preempted(rank, world, mesh, workdir, name, family, cfg, marker):
    """`name` trained with a SIGTERM sent to the last rank alone when its
    trainer logs `marker` -> (its Preempted exit code or None, the
    iteration or tree the guard stopped at)."""
    import logging
    import signal

    from ytklearn_tpu_torch.resilience import Preempted
    from ytklearn_tpu_torch.train_launch import make_trainer

    class Kill(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith(marker):
                os.kill(os.getpid(), signal.SIGTERM)

    cfg["model"]["data_path"] = os.path.join(
        workdir, f"{name}.w{world}.r{rank}", "model")
    handler = Kill()
    logger = logging.getLogger("ytklearn_tpu_torch")
    logger.setLevel(logging.INFO)
    if rank == world - 1:
        logger.addHandler(handler)
    stops = []

    class Stops(logging.Handler):
        def emit(self, record):
            if record.getMessage().startswith("preempted (signal"):
                stops.append(record.getMessage())

    seen = Stops()
    logger.addHandler(seen)
    try:
        make_trainer(family, cfg, device="cpu", mesh=mesh).train()
        return None, stops
    except Preempted as e:
        return e.exit_code, stops
    finally:
        logger.removeHandler(handler)
        logger.removeHandler(seen)


def mp_params(cls, workdir: str, mode: str, world: int):
    """tests/mp_worker.py's CommonParams of `mode` (linear or gbst) for
    either package (the class passed in)."""
    p = cls()
    p.data.train_paths = [os.path.join(workdir, "train.ytk")]
    p.data.test_paths = []
    p.data.assigned = False
    p.data.unassigned_mode = "lines_avg"
    p.model.data_path = os.path.join(workdir, f"{mode}_torch_mp{world}")
    p.loss.loss_function = "sigmoid"
    p.loss.evaluate_metric = []
    if mode == "linear":
        p.line_search.lbfgs_max_iter = 10
    else:
        p.line_search.lbfgs_max_iter = 6
        p.k = 2
        p.tree_num = 2
    return p


def _mp(mode, world, mesh, workdir):
    """tests/mp_worker.py's linear or gbst run on this process's shard."""
    from ytklearn_tpu_torch.boost import GBSTTrainer
    from ytklearn_tpu_torch.config.params import CommonParams
    from ytklearn_tpu_torch.train import HoagTrainer

    p = mp_params(CommonParams, workdir, mode, world)
    if mode == "linear":
        res = HoagTrainer(p, "linear", device="cpu", mesh=mesh).train()
    else:
        res = GBSTTrainer(p, "gbmlr", device="cpu", mesh=mesh).train()
    return train_record(res)


def main(argv):
    rank, world, rdv, mode, workdir = (int(argv[0]), int(argv[1]), argv[2],
                                       argv[3], argv[4])
    sys.path.insert(0, REPO)
    from ytklearn_tpu_torch.parallel.mesh import \
        distributed_initialize_if_needed, make_mesh, release_mesh

    # one thread a rank keeps the ranks off each other's cores
    import torch

    torch.set_num_threads(1)
    distributed_initialize_if_needed(coordinator=rdv,
                                     world_size=world, rank=rank,
                                     device="cpu", backend="gloo")
    try:
        mesh = make_mesh("cpu", shared_ingest=mode not in ("linear", "gbst"))
        if mode == "collectives":
            res = _collectives(rank, world, mesh)
        elif mode == "convex":
            res = _convex(rank, world, mesh, workdir)
        elif mode in ("linear", "gbst"):
            res = _mp(mode, world, mesh, workdir)
        else:
            res = _gbdt(rank, world, mesh, workdir)
        with open(os.path.join(workdir, f"{mode}.rank{rank}.pkl"),
                  "wb") as f:
            pickle.dump(res, f)
    finally:
        release_mesh()
    return 0


def run_ranks(mode: str, world: int, workdir: str, timeout: float = 300):
    """Start `world` ranks of `mode` (stderr to files: a rank blocked on a
    full pipe while its peer waits in a collective would hang the group)
    and return their results in rank order; the first rank that fails
    stops the others."""
    import subprocess
    import time

    rdv = "file://" + os.path.join(workdir, f"{mode}.rendezvous")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs, errs = [], []
    for r in range(world):
        ef = open(os.path.join(workdir, f"{mode}.rank{r}.err"), "w+")
        errs.append(ef)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), str(world),
             rdv, mode, workdir],
            stdout=subprocess.DEVNULL, stderr=ef, env=env))
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            assert time.monotonic() - t0 < timeout, f"{mode} ranks hung"
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for ef in errs:
            ef.close()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(workdir, f"{mode}.rank{r}.err")) as f:
                raise AssertionError(f"rank {r} rc {p.returncode}:\n"
                                     + f.read()[-4000:])
    out = []
    for r in range(world):
        with open(os.path.join(workdir, f"{mode}.rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:
        traceback.print_exc()
        sys.exit(1)
