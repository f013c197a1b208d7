"""Cost-decomposition ablations for the device GBDT engine at Higgs scale:
the port's counterpart of scripts/ablate_engine.py.

Trains a few trees per configuration on one data set and reports the
steady trees/s from trainer.time_stats, and the engine's per-wave
histogram log: every histogram pass records [rows_scanned, rows_needed,
splits, width, rows_sampled], so the record shows whether late-tree waves
cost O(wave rows) (partitioned budgets engaged) or O(n) (full scans all
the way down).

    python -m ytklearn_tpu_torch.scripts.ablate_engine [n_rows]
        [config ...] [--device cpu]

  configs: b256 (default), b64 (4x fewer histogram bins), wave32, wave42,
           wave64, part / nopart (leaf-partitioned phases on/off A/B),
           fused / nofused (the fused gather kernels K3/K4 or a gather
           and the full scan), goss / efb / goss+efb (GOSS row sampling
           and exclusive feature bundling, alone and combined; `part` is
           the both-off baseline arm)

The data (make_data) has the reference's shapes: 28 dense normal
features, an 8-column mutually exclusive sparse block (one of 8 columns
a row, uniform + 0.25) so the efb arms bundle something real, a tenth of
the rows (1024 at least) held out for test AUC. The reference draws them
with jax.random on the device; the port draws the same shapes and formula
from a seeded numpy generator. Every arm trains on the same data and
records test AUC; when a goss arm and the baseline ran, the run fails
(exit 1, after writing the record) if a GOSS arm's AUC falls more than
ABLATE_AUC_TOL below the baseline arm's (one-sided: sampling that reads
high is no failure).

Env: ABLATE_TREES (default 10), ABLATE_RECORD=path to also write the
record as JSON, ABLATE_BASELINE=path to a BENCH_*.json (any schema
generation: read_bench_record normalizes) to print a vs-baseline line per
config, ABLATE_AUC_TOL (default 0.005), ABLATE_GOSS=a,b (default
0.2,0.125). The YTK_* knobs each arm sets are config/knobs.py's.

On the CPU the arms train on the plain versions, and steady trees/s
reads "not measured (cpu)" (the record holds null).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

F_DENSE, F_EXCL = 28, 8
WAVE_COLUMNS = ["rows_scanned", "rows_needed", "splits", "hist_width",
                "rows_sampled"]

_AB_VARS = (
    "YTK_PARTITION", "YTK_NO_PARTITION", "YTK_FUSED",
    "YTK_GOSS_A", "YTK_GOSS_B", "YTK_EFB", "YTK_EFB_CONFLICT",
)


def _goss_env():
    a, _, b = os.environ.get("ABLATE_GOSS", "0.2,0.125").partition(",")
    return {"YTK_GOSS_A": a.strip(), "YTK_GOSS_B": b.strip() or "0.125"}


_ENV_OVERRIDES = {
    # config name -> knob settings applied for that run
    "nopart": {"YTK_NO_PARTITION": "1"},
    "fused": {"YTK_FUSED": "1"},
    "nofused": {"YTK_FUSED": "0"},
    "goss": _goss_env,
    "efb": {"YTK_EFB": "1"},
    "goss+efb": lambda: dict(_goss_env(), YTK_EFB="1"),
}


def apply_env(cfg: str) -> None:
    """Every config starts from the defaults, so an earlier config's
    override never leaks into (and mislabels) the next run's record. EFB
    is pinned off for every arm that does not opt in (the library's
    default is on), so the other arms stay both-off baselines on the
    exclusive-block data."""
    for k in _AB_VARS:
        os.environ.pop(k, None)
    over = _ENV_OVERRIDES.get(cfg, {})
    if callable(over):
        over = over()
    for k, v in dict({"YTK_EFB": "0"}, **over).items():
        os.environ[k] = v


def read_bench_record(path: str) -> dict:
    """A BENCH_*.json artifact of any schema generation (v1 flat fields,
    v2+ with schema_version and the obs block, v3 health_events, or the
    CI runner's wrapper {"cmd", "rc", "tail", "parsed"}), normalized; absent
    fields come back as None or empty."""
    from ytklearn_tpu_torch.obs.health import total_sentinel_hits

    with open(path) as f:
        rec = json.load(f)
    if "parsed" in rec and "cmd" in rec:  # the CI runner's wrapper
        rec = rec["parsed"] or {}
    obs_block = rec.get("obs") or {}
    counters = obs_block.get("counters") or {}
    return {
        "schema_version": int(rec.get("schema_version", 1)),
        "metric": rec.get("metric"),
        "trees_per_sec": rec.get("value"),
        "auc": rec.get("auc"),
        "logloss": rec.get("logloss"),
        "trees": rec.get("trees"),
        "mxu_pct_peak": rec.get("mxu_pct_peak"),
        "hbm_pct_peak": rec.get("hbm_pct_peak"),
        "downgrades": rec.get(
            "downgrades", int(counters.get("gbdt.downgrade.total", 0))),
        "health_events": int(rec.get("health_events",
                                     total_sentinel_hits(counters))),
        "obs": obs_block,
        "raw": rec,
    }


def wave_table(wave_log: np.ndarray, tree: int = -1):
    """[(rows_scanned, rows_needed, splits, width, rows_sampled)] for one
    tree: the O(wave rows) / O(sampled wave rows) evidence table."""
    wl = wave_log[tree]
    used = wl[:, 3] > 0
    return [[int(v) for v in row] for row in wl[used].tolist()]


def make_data(n: int, seed: int = 0):
    """(train, test) GBDTData: n training rows and max(n // 10, 1024)
    test rows of 28 dense normal features and the exclusive block, with
    the reference's label formula (scripts/ablate_engine.py:166-187), from
    one seeded numpy generator."""
    from ytklearn_tpu_torch.gbdt.data import GBDTData

    F = F_DENSE + F_EXCL
    n_test = max(n // 10, 1024)
    n_all = n + n_test
    rng = np.random.RandomState(seed)
    Xd = rng.randn(n_all, F_DENSE).astype(np.float32)
    grp = rng.randint(0, F_EXCL, size=n_all)
    vals = rng.rand(n_all).astype(np.float32) + np.float32(0.25)
    X = np.zeros((n_all, F), np.float32)
    X[:, :F_DENSE] = Xd
    X[np.arange(n_all), F_DENSE + grp] = vals
    logit = (1.5 * X[:, 0] * X[:, 1] + np.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2
             + 1.2 * X[:, F_DENSE] - 0.9 * X[:, F_DENSE + 3])
    noise = rng.randn(n_all).astype(np.float32)
    y = (logit + noise * 0.5 > 0).astype(np.float32)
    names = [f"f{i}" for i in range(F)]

    def mk(lo, hi):
        return GBDTData(X=X[lo:hi], y=y[lo:hi],
                        weight=np.ones(hi - lo, np.float32), n_real=hi - lo,
                        feature_names=names)

    return mk(0, n), mk(n, n_all)


def make_params(cfg: str, n_trees: int, data_path: str):
    from ytklearn_tpu_torch.config.params import (ApproximateSpec,
                                                  GBDTParams, ModelParams)

    return GBDTParams(
        round_num=n_trees, max_depth=60, max_leaf_cnt=255,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid",
        eval_metric=["auc"],
        approximate=[ApproximateSpec(type="sample_by_quantile",
                                     max_cnt=63 if cfg == "b64" else 255)],
        model=ModelParams(data_path=data_path, dump_freq=0))


def wave_of(cfg: str) -> int:
    return {"wave32": 32, "wave42": 42, "wave64": 64}.get(cfg, 16)


def run_config(cfg: str, train, test, n_trees: int, dev, data_path: str):
    """One arm: its knobs, its trainer, its (trainer, result)."""
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    apply_env(cfg)
    tr = GBDTTrainer(make_params(cfg, n_trees, data_path), device=dev,
                     engine="device", wave=wave_of(cfg))
    return tr, tr.train(train=train, test=test)


def band_failures(configs: dict, auc_tol: float):
    """Every goss arm whose AUC fell more than auc_tol below the both-off
    baseline arm's (part, else b256, else nopart); NaN fails."""
    fails = []
    base_arm = next((c for c in ("part", "b256", "nopart") if c in configs),
                    None)
    if base_arm is None:
        return fails
    base_auc = configs[base_arm]["auc"]
    for cfg, entry in configs.items():
        if cfg.startswith("goss") and not entry["auc"] >= base_auc - auc_tol:
            fails.append(f"{cfg} AUC {entry['auc']:.4f} fell below "
                         f"{base_arm} {base_auc:.4f} - tol {auc_tol}")
    return fails


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=10_500_000)
    ap.add_argument("configs", nargs="*", default=["b256"])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)

    from ytklearn_tpu_torch.scripts._common import (NOT_MEASURED,
                                                  launch_line, setup)

    dev, card = setup(args)
    on_card = dev.type == "cuda"
    n = args.n_rows
    configs = args.configs or ["b256"]
    n_trees = int(os.environ.get("ABLATE_TREES", 10))
    record_path = os.environ.get("ABLATE_RECORD")
    auc_tol = float(os.environ.get("ABLATE_AUC_TOL", "0.005"))
    baseline = None
    if os.environ.get("ABLATE_BASELINE"):
        baseline = read_bench_record(os.environ["ABLATE_BASELINE"])
        print(f"baseline {os.environ['ABLATE_BASELINE']} "
              f"(schema v{baseline['schema_version']}): "
              f"{baseline['trees_per_sec']} trees/s", flush=True)
    train, test = make_data(n)

    record = {"n_rows": n, "device": card, "configs": {}}
    saved = {k: os.environ.get(k) for k in _AB_VARS}
    with tempfile.TemporaryDirectory(prefix="ytk_ablate_") as tmp:
        for cfg in configs:
            tr, res = run_config(cfg, train, test, n_trees, dev,
                                 os.path.join(tmp, "model"))
            stats = {k: round(v, 1) for k, v in tr.time_stats.items()
                     if isinstance(v, float)}
            steady = (tr.time_stats.get("trees_per_sec_steady", 0.0)
                      if on_card else None)
            auc = float(res.test_metrics.get("auc", float("nan")))
            print(f"CONFIG {cfg}: steady="
                  f"{NOT_MEASURED if steady is None else f'{steady:.3f}'} "
                  f"trees/s auc={auc:.4f} stats={stats} [{card}]",
                  flush=True)
            if baseline and baseline.get("trees_per_sec") and on_card:
                print(f"CONFIG {cfg}: vs baseline "
                      f"{steady / baseline['trees_per_sec']:.2f}x",
                      flush=True)
            entry = {
                "steady_trees_per_sec": steady,
                "auc": auc,
                "train_loss": float(res.train_loss),
                "test_loss": (float(res.test_loss)
                              if res.test_loss is not None else None),
                "time_stats": {k: (round(v, 2) if isinstance(v, float)
                                   else v)
                               for k, v in tr.time_stats.items()},
            }
            if tr._efb_plan is not None:
                entry["efb_plan"] = tr._efb_plan.summary()
            if getattr(tr, "wave_log", None) is not None:
                # the last tree: the representative late-boosting shape
                entry["last_tree_waves"] = wave_table(tr.wave_log, tree=-1)
                entry["wave_columns"] = list(WAVE_COLUMNS)
                wl = tr.wave_log
                used = wl[..., 3] > 0
                entry["hist_rows_scanned_total"] = float(
                    (wl[..., 0] * used).sum())
                entry["hist_rows_needed_total"] = float(
                    (wl[..., 1] * used).sum())
                # 1.0: perfectly leaf-partitioned histogram cost
                need = max(entry["hist_rows_needed_total"], 1.0)
                entry["scan_over_need"] = round(
                    entry["hist_rows_scanned_total"] / need, 2)
            record["configs"][cfg] = entry
    for k, v in saved.items():  # the arms' knobs end with the run
        os.environ.pop(k, None)
        if v is not None:
            os.environ[k] = v

    # the quality band: sampling must not buy its speed with AUC; it
    # fails after the record is written (the artifact is kept)
    fails = band_failures(record["configs"], auc_tol)
    if record_path:
        with open(record_path, "w") as f:
            json.dump(record, f, indent=1)
        print(f"ablation record written: {record_path}", flush=True)
    print(launch_line(card), flush=True)
    for msg in fails:
        print(f"QUALITY BAND FAIL: {msg}", file=sys.stderr, flush=True)
    return 1 if fails else 0


if __name__ == "__main__":
    sys.exit(main())
