"""The GBDT cell of bench.py as the reference runs it, on the port: the
counterpart of bench.py::bench_gbdt (:302-364).

    python -m ytklearn_tpu_torch.scripts.bench_gbdt [--repeats N]
        [--rows N] [--test-rows N] [--trees T] [--out PATH] [--device cpu]

Trains the Higgs-shaped synthetic (28 features, a planted nonlinear
signal, `gen_higgs_like`: bench.py's formula drawn from a seeded torch
generator on the device) with bench.py's GBDT parameters (loss policy,
255 leaves, depth 60, lr 0.1, min_child_hessian_sum 100, sigmoid, 255
bins, int8 histograms, wave 64) and its GOSS default (a, b) = (0.2,
0.125): `BENCH_GOSS=0|off` turns it off, `BENCH_GOSS=a,b` sets it, and
with BENCH_GOSS unset a set `YTK_GOSS_A` wins (`resolve_goss`). The
defaults are bench.py's (10,500,000 + 500,000 rows, 40 trees); rows, test
rows and trees come from the options, else from bench.py's `BENCH_ROWS`,
`BENCH_TEST_ROWS` and `BENCH_TREES`, and the histogram precision and wave
from `BENCH_HIST` and `BENCH_WAVE`, as bench.py reads them.

Prints one JSON object a run: steady trees/s from the trainer's sync log
(bench.py:346-352: from the first sync at round >= 3 to the last), test
AUC and logloss, trees, source, GOSS and its kept rows a tree, the
synthetic quality band's verdict (`quality_band`: "ok", a message, or
null where a knob moved the cell off its default) and the card's name and
power limit. `--repeats N` runs the cell N times, each in a fresh process,
and prints after their lines one object with every run and the medians.
`--out PATH` writes the last object to PATH. With `--device cpu` the run
trains on the plain versions and trees/s reads "not measured (cpu)".
bench.py's `roofline` field (TPU MXU/HBM peaks through its obs registry)
is left out.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile

import numpy as np
import torch

from ..config import knobs
from ..config.params import ApproximateSpec, GBDTParams, ModelParams
from ..gbdt.data import GBDTData
from ..gbdt.trainer import GBDTTrainer
from ._common import NOT_MEASURED, setup

#: bench.py:85, pinned from the reference's r4 hardware run of the default
#: configuration (10.5M rows, 40 trees, wave 64, int8)
SYNTH_BAND = {"auc": (0.9489, 0.005), "logloss": (0.3118, 0.02)}
#: bench.py:94: one-sided headroom for GOSS's better early quality (the
#: real-Higgs band's GOSS_IMPROVE_HEADROOM waits for the Higgs files)
SYNTH_AUC_HEADROOM = 0.005
#: bench.py:286
BENCH_GOSS_DEFAULT = (0.2, 0.125)
F = 28
SEED = 20261016
DEFAULTS = {"rows": 10_500_000, "test_rows": 500_000, "trees": 40}
#: environment variables that move the cell off its default and so turn
#: the band off (bench.py:444-447)
QUALITY_KNOBS = ("BENCH_ROWS", "BENCH_TEST_ROWS", "BENCH_TREES",
                 "BENCH_WAVE", "BENCH_HIST", "BENCH_GOSS", "YTK_GOSS_A",
                 "YTK_GOSS_B")


def gen_higgs_like(n: int, n_test: int, F: int, seed: int, device="cuda"):
    """Torch twin of bench.py::_gen_gbdt: a Higgs-shaped synthetic with a
    planted nonlinear signal, drawn on `device` from a seeded generator.
    Returns (train, test) GBDTData."""
    gen = torch.Generator(device=device).manual_seed(seed)
    n_all = n + n_test
    X = torch.randn((n_all, F), generator=gen, device=device)
    logit = (1.5 * X[:, 0] * X[:, 1] + torch.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2
             + 0.3 * X[:, 5] * X[:, 6])
    noise = torch.randn((n_all,), generator=gen, device=device)
    y = (logit + noise * 0.5 > 0).to(torch.float32)
    names = [f"f{i}" for i in range(F)]

    def mk(lo, hi):
        return GBDTData(X=X[lo:hi], y=y[lo:hi],
                        weight=np.ones(hi - lo, np.float32), n_real=hi - lo,
                        feature_names=names)

    return mk(0, n), mk(n, n_all)


def bench_params(rounds: int, data_path: str) -> GBDTParams:
    """bench.py::bench_gbdt's configuration (bench.py:320-339)."""
    return GBDTParams(
        round_num=rounds, max_depth=60, max_leaf_cnt=255,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid",
        eval_metric=["auc", "logloss"],
        approximate=[ApproximateSpec(type="sample_by_quantile", max_cnt=255)],
        model=ModelParams(data_path=data_path, dump_freq=0),
    )


def resolve_goss():
    """bench.py::resolve_goss (:289-299): BENCH_GOSS, else a set
    YTK_GOSS_A, else (0.2, 0.125)."""
    raw = os.environ.get("BENCH_GOSS")
    if raw is None:
        if knobs.get_raw("YTK_GOSS_A") is not None:
            return (knobs.get_float("YTK_GOSS_A"),
                    knobs.get_float("YTK_GOSS_B"))
        return BENCH_GOSS_DEFAULT
    raw = raw.strip().lower()
    if raw in ("0", "off", "false", "no"):
        return (1.0, 0.0)
    a, _, b = raw.partition(",")
    return (float(a), float(b) if b else 0.0)


def quality_band(auc: float, logloss: float, knobs_set: bool):
    """The synthetic half of bench.py::quality_band (:176-215): None when
    no band applies, "ok", or the message."""
    if knobs_set:
        return None
    auc_c, auc_tol = SYNTH_BAND["auc"]
    ll_c, ll_tol = SYNTH_BAND["logloss"]
    if ((auc_c - auc) > auc_tol
            or (auc - auc_c) > auc_tol + SYNTH_AUC_HEADROOM
            or abs(logloss - ll_c) > ll_tol):
        return (f"auc {auc:.4f} / logloss {logloss:.4f} outside "
                f"band {auc_c}±{auc_tol}(+{SYNTH_AUC_HEADROOM} GOSS headroom)"
                f" / {ll_c}±{ll_tol}")
    return "ok"


def steady_trees_per_sec(sync, n_trees: int) -> float:
    """bench.py:346-352: the window from the first sync at round >= 3 to
    the last, else the whole run's average."""
    tail = [(r, t) for r, t in sync if r >= 3]
    if len(tail) >= 2:
        (r0, t0), (r1, t1) = tail[0], tail[-1]
        return (r1 - r0) / (t1 - t0)
    return n_trees / sync[-1][1]


def resolve_cell(args) -> dict:
    """The cell: each option, else its BENCH_* variable, else bench.py's
    default; `knobs_set` when any of them moved it."""
    cell = {}
    for key, env in (("rows", "BENCH_ROWS"), ("test_rows", "BENCH_TEST_ROWS"),
                     ("trees", "BENCH_TREES")):
        v = getattr(args, key)
        if v is None:
            v = int(os.environ.get(env, DEFAULTS[key]))
        cell[key] = v
    cell["hist"] = os.environ.get("BENCH_HIST", "int8")
    wave = os.environ.get("BENCH_WAVE")
    cell["wave"] = int(wave) if wave else None  # None: the trainer's 64
    cell["goss"] = resolve_goss()
    cell["knobs_set"] = (
        any(os.environ.get(k) is not None for k in QUALITY_KNOBS)
        or any(getattr(args, k) is not None
               for k in ("rows", "test_rows", "trees")))
    return cell


def run_cell(args) -> dict:
    dev, card = setup(args)
    cell = resolve_cell(args)
    goss = cell["goss"]
    train, test = gen_higgs_like(cell["rows"], cell["test_rows"], F, SEED,
                                 dev)
    with tempfile.TemporaryDirectory(prefix="ytk_bench_gbdt_") as tmp:
        trainer = GBDTTrainer(
            bench_params(cell["trees"], os.path.join(tmp, "model")),
            device=dev, hist_precision=cell["hist"], wave=cell["wave"],
            goss=goss)
        res = trainer.train(train=train, test=test)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if not (math.isfinite(res.train_loss) and res.train_loss < 0.65):
        raise RuntimeError(f"bench_gbdt: train loss {res.train_loss} is not "
                           "below 0.65 (bench.py:341)")
    if len(res.model.trees) != cell["trees"]:
        raise RuntimeError(f"bench_gbdt: {len(res.model.trees)} trees, "
                           f"expected {cell['trees']}")
    tps = steady_trees_per_sec(trainer.sync_log, cell["trees"])
    auc = float(res.test_metrics["auc"])
    logloss = float(res.test_loss)
    ts = trainer.time_stats
    return {
        "trees_per_sec": tps if dev.type == "cuda" else NOT_MEASURED,
        "auc": auc,
        "logloss": logloss,
        "trees": cell["trees"],
        "source": "synthetic",
        "goss": f"a={goss[0]:g},b={goss[1]:g}" if goss[0] < 1.0 else "off",
        "goss_rows_per_tree": ts.get("goss_rows_per_tree"),
        "band": quality_band(auc, logloss, cell["knobs_set"]),
        "card": card,
        "hist": cell["hist"],
        "rows": cell["rows"],
        "test_rows": cell["test_rows"],
        "seed": SEED,
        "train_loss": float(res.train_loss),
    }


def _median(runs, key):
    vals = [r[key] for r in runs]
    return statistics.median(vals) if all(
        isinstance(v, (int, float)) for v in vals) else vals[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--test-rows", dest="test_rows", type=int, default=None)
    ap.add_argument("--trees", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of the cell, each in a fresh process")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if args.repeats <= 1:
        out = run_cell(args)
        print(json.dumps(out), flush=True)
    else:
        child = list(argv if argv is not None else sys.argv[1:])
        child = _drop_option(_drop_option(child, "--repeats"), "--out")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        runs = []
        for _ in range(args.repeats):
            proc = subprocess.run(
                [sys.executable, "-m", "ytklearn_tpu_torch.scripts.bench_gbdt",
                 *child], capture_output=True, text=True, cwd=root, env=env)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"bench_gbdt: a run exited "
                                   f"{proc.returncode}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
        out = {"runs": runs, "repeats": args.repeats,
               "card": runs[0]["card"],
               "median": {k: _median(runs, k) for k in
                          ("trees_per_sec", "auc", "logloss")}}
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


def _drop_option(argv, name):
    """argv without `name` and its value (`name v` or `name=v`)."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == name:
            skip = True
        elif not a.startswith(name + "="):
            out.append(a)
    return out


if __name__ == "__main__":
    sys.exit(main())
