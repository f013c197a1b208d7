"""Sweep the trainer's wave width x histogram precision at the Higgs shape
in steady trees/s: the port's counterpart of scripts/tune_gbdt.py. One
process: the data once, then one short training run per configuration.

The data is the reference's synthetic formula (scripts/tune_gbdt.py:35-44)
drawn from a seeded torch.Generator on the device; the parameters are its
own (:61-72: depth 60, 255 leaves, loss policy, lr 0.1,
min_child_hessian_sum 100, sigmoid, 255 bins). The configurations are its
seven: waves 32, 42, 48, 64, 96 in int8 and 32, 42 in bf16.

    python -m ytklearn_tpu_torch.scripts.tune_gbdt [--trees T] [--rows N]
        [--configs 32:int8,64:int8,...] [--device cpu]

Prints per configuration the steady trees/s (the trainer's sync log, the
first window skipped), the train loss and the wall time of the run, with
the card's name and power limit; then the best three. With --device cpu
the runs train on the plain versions and trees/s and wall read "not
measured (cpu)".
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..config.params import ApproximateSpec, GBDTParams, ModelParams
from ..gbdt.data import GBDTData
from ..gbdt.trainer import GBDTTrainer
from ._common import NOT_MEASURED, setup, parser

F = 28
SEED = 0
CONFIGS = "32:int8,42:int8,48:int8,64:int8,96:int8,32:bf16,42:bf16"


def make_data(n: int, dev: torch.device, seed: int) -> GBDTData:
    gen = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn((n, F), generator=gen, device=dev)
    logit = (1.5 * X[:, 0] * X[:, 1] + torch.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2
             + 0.3 * X[:, 5] * X[:, 6])
    noise = torch.randn((n,), generator=gen, device=dev)
    y = (logit + noise * 0.5 > 0).to(torch.float32)
    return GBDTData(X=X, y=y, weight=np.ones(n, np.float32), n_real=n,
                    feature_names=[f"f{i}" for i in range(F)])


def params(trees: int, data_path: str) -> GBDTParams:
    return GBDTParams(
        round_num=trees, max_depth=60, max_leaf_cnt=255,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid", eval_metric=[],
        approximate=[ApproximateSpec(type="sample_by_quantile", max_cnt=255)],
        model=ModelParams(data_path=data_path, dump_freq=0),
    )


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], 10_500_000)
    ap.add_argument("--trees", type=int, default=12)
    ap.add_argument("--configs", default=CONFIGS,
                    help="wave:precision pairs, comma separated")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    configs = [(int(w), p) for w, p in
               (c.split(":") for c in args.configs.split(","))]
    train = make_data(args.rows, dev, SEED)
    print(f"tune_gbdt: {args.rows} rows x {F} features, {args.trees} trees "
          f"a run, device {dev} [{card}]", flush=True)
    results = []
    with tempfile.TemporaryDirectory(prefix="ytk_tune_gbdt_") as tmp:
        for wave, prec in configs:
            t0 = time.perf_counter()
            tr = GBDTTrainer(params(args.trees, os.path.join(tmp, "model")),
                             device=dev, hist_precision=prec, wave=wave)
            res = tr.train(train=train)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            tps = tr.time_stats.get("trees_per_sec_steady", float("nan"))
            if dev.type != "cuda":
                tps_s, wall_s = NOT_MEASURED, NOT_MEASURED
            else:
                tps_s, wall_s = f"{tps:.4f}", f"{wall:.3f}s"
                if math.isfinite(tps):
                    results.append((tps, wave, prec))
            print(f"RESULT wave={wave} prec={prec} trees/s={tps_s} "
                  f"loss={res.train_loss:.6f} wall={wall_s} [{card}]",
                  flush=True)
    results.sort(reverse=True)
    best = (", ".join(f"wave={w} prec={p} {t:.4f} trees/s"
                      for t, w, p in results[:3])
            if dev.type == "cuda" else NOT_MEASURED)
    print(f"BEST: {best} [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
