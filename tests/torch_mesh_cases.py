"""The cases and comparisons of tests/test_torch_mesh_convex.py and
test_torch_mesh_gbst.py: seeded convex_synth configs, the ranks' runs
(tests/torch_mp_worker.py's `convex` mode), the port's one-rank runs and
the JAX package's runs on a mesh of N devices, and the tolerances they
are held to."""

import copy
import json

import jax
import numpy as np

from ytklearn_tpu.boost import GBSTTrainer as JGBST
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.parallel import make_mesh
from ytklearn_tpu.train import HoagTrainer as JHoag

from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
    write_gbst_case
from ytklearn_tpu_torch.train_launch import make_trainer

from torch_mp_worker import run_ranks, train_record

WORLDS = (2, 4)
RTOL = 1e-4
GBST_HELD_ITERS = 6  # chip_smoke.py's; test_torch_gbst.py's iterations
GBST_VARIANTS = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")
CONVEX_NAMES = ("linear", "linear_l1", "multiclass_linear", "fm", "ffm",
                "grid", "hoag")


def _convex(d, family, max_iter=8, **kw):
    cfg = write_convex_case(str(d / family), family, 1201, 301, 17,
                            max_iter=max_iter, **kw)
    cfg["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-7
    if family != "multiclass_linear":
        cfg["loss"]["evaluate_metric"] = ["auc", "rmse"]
    return cfg


def convex_cases(d):
    """{name: (family, config)} of the convex runs."""
    out = {
        "linear": ("linear", _convex(d, "linear", vocab=2000, nnz=10,
                                     l2=1e-3)),
        "linear_l1": ("linear", _convex(d, "linear", vocab=2000, nnz=10,
                                        l1=5e-5, l2=1e-3)),
        "multiclass_linear": ("multiclass_linear",
                              _convex(d, "multiclass_linear", vocab=60, K=5,
                                      l2=0.01)),
        "fm": ("fm", _convex(d, "fm", vocab=200, k=4, l2=1e-4)),
        "ffm": ("ffm", _convex(d, "ffm", vocab=120, n_fields=6, k=3,
                               l2=0.01)),
    }
    base = _convex(d, "linear", max_iter=6, vocab=300, l2=0.01)
    grid = copy.deepcopy(base)
    grid["hyper"] = {"switch_on": True, "mode": "grid",
                     "grid": {"l2": [0.001, 0.03, 0.3]}}
    out["grid"] = ("linear", grid)
    hoag = copy.deepcopy(base)
    hoag["hyper"] = {"switch_on": True, "mode": "hoag",
                     "hoag": {"l2": [0.05], "outer_iter": 3}}
    out["hoag"] = ("linear", hoag)
    return out


def gbst_cases(d):
    """{name: (variant, config)} of the GBST runs (gbhsdt as a
    random_forest)."""
    out = {}
    for v in GBST_VARIANTS:
        cfg = write_gbst_case(str(d / "gbst"), 1200, 301, 17, K=4,
                              tree_num=2, instance_sample_rate=0.8,
                              feature_sample_rate=0.8, vocab=300, nnz=8,
                              l2=1e-3, max_iter=GBST_HELD_ITERS,
                              gbst_type=("random_forest" if v == "gbhsdt"
                                         else "gradient_boosting"))
        cfg["loss"]["evaluate_metric"] = ["auc"]
        cfg["optimization"]["line_search"]["lbfgs"]["convergence"][
            "eps"] = 1e-7
        out[v] = (v, cfg)
    return out


class Runs:
    """A module's cases: the ranks' runs at each world size (every case in
    one rank process), then the port's one-rank runs and the JAX
    package's mesh runs on demand, cached."""

    def __init__(self, cases, tmp_path_factory, tag):
        self.cases, self.tpf = cases, tmp_path_factory
        self.ranks, self.dirs = {}, {}
        self._one, self._jax, self.one_paths = {}, {}, {}
        for w in WORLDS:
            d = tmp_path_factory.mktemp(f"{tag}{w}")
            (d / "cases.json").write_text(json.dumps(cases))
            self.dirs[w] = d
            self.ranks[w] = run_ranks("convex", w, str(d), timeout=300)

    def one(self, name):
        if name not in self._one:
            family, cfg = copy.deepcopy(self.cases[name])
            cfg["model"]["data_path"] = self.one_paths[name] = str(
                self.tpf.mktemp(f"one_{name}") / "model")
            self._one[name] = train_record(make_trainer(
                family, cfg, device="cpu").train())
        return self._one[name]

    def jax(self, name, world):
        """The JAX package's run on a mesh of `world` devices, in float32
        as its CLI runs."""
        if (name, world) not in self._jax:
            family, cfg = copy.deepcopy(self.cases[name])
            cfg["model"]["data_path"] = str(
                self.tpf.mktemp(f"jax_{name}_{world}") / "model")
            p = JParams.from_config(cfg)
            with jax.enable_x64(False):
                cls = JGBST if family in GBST_VARIANTS else JHoag
                res = cls(p, family, mesh=make_mesh(world)).train()
            self._jax[(name, world)] = train_record(res)
        return self._jax[(name, world)]


def agree(got, want):
    """Convex: the same iterations and status, the average train loss at
    RTOL; GBST: the same trees, the train loss at RTOL; both: the test
    loss at RTOL and each metric within RTOL."""
    if "n_iter" in want:
        assert (got["status"], got["n_iter"]) == (want["status"],
                                                  want["n_iter"])
        np.testing.assert_allclose(got["avg_loss"], want["avg_loss"],
                                   rtol=RTOL)
    else:
        assert got["n_trees"] == want["n_trees"]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                                   rtol=RTOL)
    if want["test_loss"] is not None:
        np.testing.assert_allclose(got["test_loss"], want["test_loss"],
                                   rtol=RTOL)
    for split in ("train_metrics", "test_metrics"):
        assert set(got[split]) == set(want[split])
        for k, v in want[split].items():
            assert abs(got[split][k] - v) <= RTOL, (split, k, got[split][k],
                                                    v)


def check_preempted(runs, world, name, where):
    """Every rank stopped by the same boundary with SIGTERM's exit code;
    rank 0 dumped, no other rank did."""
    for r, rec in enumerate(runs.ranks[world]):
        code, stops = rec[f"preempt_{name}"]
        assert code == 143, (r, code)
        assert len(stops) == 1 and where in stops[0], stops
    base = runs.dirs[world]
    assert (base / f"preempt_{name}.w{world}.r0" / "model").exists()
    for r in range(1, world):
        assert not (base / f"preempt_{name}.w{world}.r{r}").exists()
