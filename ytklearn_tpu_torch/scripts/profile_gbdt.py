"""Profile the GBDT trainer at Higgs-like scale on the card: the port's
counterpart of scripts/profile_gbdt.py.

Measures trees/s for level-wise and loss-wise growth at the acceptance
config (255 bins, 255 leaves loss-wise / depth-8 level-wise) on the
reference's synthetic data (its seeded numpy draw, the same arrays), so
the time can be placed before it is optimized. The timing rides the
profiling plane (obs/profiler.py): the run is one phase, and the plane's
report of the trainer's own phases follows.

    python -m ytklearn_tpu_torch.scripts.profile_gbdt [n_rows] [n_trees]
        [policy] [--device cpu]

On the CPU the run trains on the plain versions, and its total and
trees/s read "not measured (cpu)".
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

F = 28


def make_data(n: int):
    """The reference's (n, 28) rows and labels: RandomState(0), a planted
    nonlinear signal (scripts/profile_gbdt.py:32-41)."""
    from ytklearn_tpu_torch.gbdt.data import GBDTData

    rng = np.random.RandomState(0)
    X = rng.randn(n, F).astype(np.float32)
    logit = (1.5 * X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2)
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    return GBDTData(X=X, y=y, weight=np.ones(n, np.float32), n_real=n,
                    feature_names=[f"f{i}" for i in range(F)])


def make_params(n_trees: int, policy: str, data_path: str):
    from ytklearn_tpu_torch.config.params import (ApproximateSpec,
                                                  GBDTParams, ModelParams)

    return GBDTParams(
        round_num=n_trees, max_depth=8 if policy == "level" else 100,
        max_leaf_cnt=255, tree_grow_policy=policy, learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid",
        eval_metric=[], watch_train=False, watch_test=False,
        approximate=[ApproximateSpec(max_cnt=255)],
        model=ModelParams(data_path=data_path, dump_freq=0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=1_000_000)
    ap.add_argument("n_trees", nargs="?", type=int, default=5)
    ap.add_argument("policy", nargs="?", default="loss")
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.obs import profiler
    from ytklearn_tpu_torch.scripts._common import (NOT_MEASURED,
                                                  launch_line, setup)

    dev, card = setup(args)
    n, policy = args.n_rows, args.policy
    data = make_data(n)
    profiler.configure_profiler(on=True)
    with tempfile.TemporaryDirectory(prefix="ytk_profile_gbdt_") as tmp:
        trainer = GBDTTrainer(
            make_params(args.n_trees, policy, os.path.join(tmp, "model")),
            device=dev)
        with profiler.phase("profile.run"):
            res = trainer.train(train=data, test=None)
    dt = profiler.phases_snapshot()["profile.run"]["wall_s"]
    n_built = len(res.model.trees)
    on_card = dev.type == "cuda"
    total = f"{dt:.1f}s" if on_card else NOT_MEASURED
    tps = f"{n_built / dt:.3f}" if on_card else NOT_MEASURED
    print(f"policy={policy} rows={n} trees={n_built} total={total} "
          f"trees/s={tps} train_loss={res.train_loss:.5f} [{card}]",
          flush=True)
    for rec in res.round_log:
        if "elapsed" in rec:
            cum = f"{rec['elapsed']:.1f}s" if on_card else NOT_MEASURED
            print(f"  round {rec['round']}: cum {cum}")
    print(profiler.format_report(profiler.report(wall_s=dt)), flush=True)
    print(launch_line(card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
