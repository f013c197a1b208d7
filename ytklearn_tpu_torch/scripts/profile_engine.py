"""Profile and quality-check the device GBDT engine on the card: the
port's counterpart of scripts/profile_engine.py.

Trains on the reference's synthetic Higgs-shaped data (its seeded numpy
draws, the same arrays: train seed 0, test seed 1 at a tenth of the rows,
10,000 at least) with the device engine at the given wave width, growth
policy, leaf cap and histogram precision, then prints trees/s and the
final train and test quality, the trees' sizes and depths, and the
profiling plane's report (obs/profiler.py) of the trainer's phases.

    python -m ytklearn_tpu_torch.scripts.profile_engine [n_rows]
        [n_trees] [wave] [policy] [leaves] [prec] [--device cpu]

On the CPU the run trains on the plain versions, and its total and
trees/s read "not measured (cpu)".
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

F = 28


def make_data(n: int, seed: int):
    """The reference's rows (scripts/profile_engine.py:35-50): RandomState
    (seed), a planted nonlinear signal with one more interaction."""
    from ytklearn_tpu_torch.gbdt.data import GBDTData

    r = np.random.RandomState(seed)
    X = r.randn(n, F).astype(np.float32)
    logit = (1.5 * X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2
             + 0.3 * X[:, 5] * X[:, 6])
    y = (logit + r.randn(n) * 0.5 > 0).astype(np.float32)
    return GBDTData(X=X, y=y, weight=np.ones(n, np.float32), n_real=n,
                    feature_names=[f"f{i}" for i in range(F)])


def make_params(n_trees: int, policy: str, leaves: int, data_path: str):
    from ytklearn_tpu_torch.config.params import (ApproximateSpec,
                                                  GBDTParams, ModelParams)

    return GBDTParams(
        round_num=n_trees, max_depth=60 if policy == "loss" else 8,
        max_leaf_cnt=leaves, tree_grow_policy=policy, learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid",
        eval_metric=["auc"], approximate=[ApproximateSpec(max_cnt=255)],
        model=ModelParams(data_path=data_path, dump_freq=0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=1_000_000)
    ap.add_argument("n_trees", nargs="?", type=int, default=5)
    ap.add_argument("wave", nargs="?", type=int, default=16)
    ap.add_argument("policy", nargs="?", default="loss")
    ap.add_argument("leaves", nargs="?", type=int, default=255)
    ap.add_argument("prec", nargs="?", default="bf16")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.obs import profiler
    from ytklearn_tpu_torch.scripts._common import (NOT_MEASURED,
                                                  launch_line, setup)

    dev, card = setup(args)
    n, wave, policy, prec = args.n_rows, args.wave, args.policy, args.prec
    train = make_data(n, 0)
    test = make_data(max(n // 10, 10000), 1)
    profiler.configure_profiler(on=True)
    with tempfile.TemporaryDirectory(prefix="ytk_profile_engine_") as tmp:
        trainer = GBDTTrainer(
            make_params(args.n_trees, policy, args.leaves,
                        os.path.join(tmp, "model")),
            device=dev, engine="device", wave=wave, hist_precision=prec)
        with profiler.phase("profile.run"):
            res = trainer.train(train=train, test=test)
    dt = profiler.phases_snapshot()["profile.run"]["wall_s"]
    nb = len(res.model.trees)
    on_card = dev.type == "cuda"
    total = f"{dt:.1f}s" if on_card else NOT_MEASURED
    tps = f"{nb / dt:.3f}" if on_card else NOT_MEASURED
    print(f"policy={policy} wave={wave} prec={prec} rows={n} trees={nb} "
          f"total={total} trees/s={tps} train_loss={res.train_loss:.5f} "
          f"test_loss={res.test_loss:.5f} "
          f"test_auc={res.test_metrics.get('auc'):.5f} [{card}]", flush=True)
    sizes = [t.n_nodes() for t in res.model.trees]
    depths = [t.max_depth() for t in res.model.trees]
    print(f"tree nodes min/med/max: {min(sizes)}/"
          f"{sorted(sizes)[len(sizes) // 2]}/{max(sizes)}"
          f"  depth max: {max(depths)}")
    print(profiler.format_report(profiler.report(wall_s=dt)), flush=True)
    print(launch_line(card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
