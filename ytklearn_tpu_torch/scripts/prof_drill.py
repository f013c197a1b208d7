#!/usr/bin/env python
"""Profiling drill: prove the ytkprof plane (obs/profiler.py) end to end,
and write one JSON record (the JAX package's scripts/prof_drill.py, on
`--device`, default cuda).

Runs a real GBDT training pass with the plane armed, from seeded text
through the native parser (bf16 histograms: the kernels K1, K3 and K5 on
the card), then serves the dumped model in-process across the ladder's
rungs on the fused rung (kernel K6), and records the evidence as schema
`ytkprof_drill`:

  train    the phase accountant decomposes >= 90% of the training wall
           time into named depth-0 buckets (gbdt.load / preprocess /
           train / finalize); the capture of gbdt.train parses into a
           non-empty kernel table (on the card: device time, with the
           port's kernels by name); the build ledger lists every library
           load or build and the kernels' first instantiations; the
           memory sampler attributes watermarks to the phase they peaked
           under
  serve    metrics_payload(prof=True) carries per-rung execute-time
           attribution whose rows equal the rows sent, and the ledger
  steady   post-warmup retraces are zero

Usage:
  python -m ytklearn_tpu_torch.scripts.prof_drill --record out.json
      [--device cpu] [--rows 40000] [--trees 10] [--features 20]

Exit 1 when any check fails (the record says which), 2 without a CUDA
device for `--device cuda`.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

log = logging.getLogger("prof_drill")
COVERAGE_FLOOR = 0.9
#: requests of one row, then of 48: the 1-row and 64-row rungs
SINGLES, BATCHES, BATCH_ROWS = 24, 6, 48
#: rows of the kernel table: torch's own kernels outnumber the port's
TOPK = 64


def _write_text(path: str, n: int, n_features: int, seed: int) -> None:
    """n seeded ytklearn text lines `1###label###f0:v,...`: a logit with
    interactions, a threshold and a square, plus noise."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, n_features).astype(np.float32)
    logit = (
        1.5 * X[:, 0] * X[:, 1]
        + np.sin(X[:, 2] * 2)
        + 0.8 * (X[:, 3] > 0.5)
        - 0.5 * X[:, 4] ** 2
    )
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.int64)
    fmt = "1###%d###" + ",".join(f"f{j}:%.7g" for j in range(n_features))
    with open(path, "w") as f:
        for i in range(n):
            f.write(fmt % (y[i], *X[i].tolist()) + "\n")


def train_step(args, tmp_dir: str, model_path: str) -> dict:
    """Profiled training pass from text (gbdt.load: the native parser's
    library load lands in the build ledger on any device). The drill does
    NOT wrap the call in an outer phase: the trainer's own gbdt.* phases
    must cover the wall time at depth 0 — that IS the decomposition
    claim."""
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.obs import profiler

    train_path = os.path.join(tmp_dir, "drill.train")
    _write_text(train_path, args.rows, args.features, seed=0)
    cfg = hocon.loads(
        f'data {{ train {{ data_path = "{train_path}" }} '
        f"max_feature_dim = {args.features} }}\n"
        f'model {{ data_path = "{model_path}", dump_freq = 0 }}\n'
        f"optimization {{ round_num = {args.trees}, max_depth = 6, "
        "max_leaf_cnt = 63, tree_grow_policy = loss, "
        "min_child_hessian_sum = 50, loss_function = sigmoid, "
        "regularization { learning_rate = 0.1 } }\n")
    params = GBDTParams.from_config(cfg)
    params.eval_metric = []
    params.approximate = [ApproximateSpec(max_cnt=255)]
    trainer = GBDTTrainer(params, device=args.device)
    t0 = time.perf_counter()
    res = trainer.train()
    wall = time.perf_counter() - t0
    rep = profiler.report(wall_s=wall)
    return {
        "trees_built": len(res.model.trees),
        "train_loss": round(res.train_loss, 5),
        "wall_s": round(wall, 3),
        "report": rep,
    }


def serve_step(args, model_path: str) -> dict:
    """Serve the just-dumped model in-process and pull the ?prof=1
    payload: per-rung attribution + the ledger, post-warmup."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    cfg = {"model": {"data_path": model_path},
           "optimization": {"loss_function": "sigmoid",
                            "round_num": args.trees}}
    reg = ModelRegistry(watch_interval_s=0, device=args.device)
    with compile_credit():
        entry = reg.load("default", "gbdt", cfg)
    app = ServeApp(reg, BatchPolicy(max_batch=64, max_wait_ms=0.2))
    rng = np.random.RandomState(3)
    counters = obs.snapshot()["counters"]
    retrace_before = counters.get("health.retrace", 0.0)
    unexpected_before = counters.get("compile.retraces.unexpected", 0.0)
    sent = 0
    try:
        # small singles and near-full batches land on different ladder
        # rungs — the attribution table must keep them apart
        for _ in range(SINGLES):
            app.predict(
                [{f"f{j}": float(rng.randn()) for j in range(args.features)}],
                timeout=60.0,
            )
            sent += 1
        for _ in range(BATCHES):
            rows = [
                {f"f{j}": float(rng.randn()) for j in range(args.features)}
                for _ in range(BATCH_ROWS)
            ]
            app.predict(rows, timeout=60.0)
            sent += len(rows)
        m = app.metrics_payload(prof=True)
        prof = m.get("prof") or {}
        rungs = ((prof.get("models") or {}).get("default") or {}).get(
            "rungs"
        ) or {}
        counters = obs.snapshot()["counters"]
        return {
            "requests": SINGLES + BATCHES,
            "rows_sent": sent,
            "rung": entry.scorer.rung_info(),
            "prof_block": bool(prof),
            "prof_enabled": prof.get("enabled"),
            "rungs": rungs,
            "ledger_compiles": (prof.get("compile") or {}).get("compiles"),
            "retraces_during_serve": (
                counters.get("health.retrace", 0.0) - retrace_before),
            "unexpected_retraces": (
                counters.get("compile.retraces.unexpected", 0.0)
                - unexpected_before),
        }
    finally:
        for b in app._batchers.values():
            b.close(drain=True)
        reg.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--record", required=True,
                    help="path of the JSON record to write")
    ap.add_argument("--device", default="cuda",
                    help="device to train and serve on: cuda (default) or "
                    "cpu")
    ap.add_argument("--rows", type=int, default=40000)
    ap.add_argument("--trees", type=int, default=10)
    ap.add_argument("--features", type=int, default=20)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            log.error("--device cuda without a CUDA device")
            return 2
    # the serving rung is a process-wide knob, read at each scorer build
    os.environ.pop("YTK_SERVE_BINNED", None)
    os.environ["YTK_SERVE_FUSED"] = "1"

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import profiler

    fails = []
    with tempfile.TemporaryDirectory() as tmp_dir:
        # arm the whole plane: phases, span annotations, trace capture
        # into the tempdir, ledger, fast memory sampling (the drill run is
        # short — the default 0.5 s tick would miss early phases)
        profiler.configure_profiler(
            on=True, capture_dir=os.path.join(tmp_dir, "prof"),
            mem_interval=0.05, topk=TOPK,
        )
        model_path = os.path.join(tmp_dir, "gbdt.model")

        log.info("== step 1: profiled training (%d rows x %d trees, %s) ==",
                 args.rows, args.trees, args.device)
        tr = train_step(args, tmp_dir, model_path)
        rep = tr["report"]
        coverage = rep.get("phase_coverage") or 0.0
        kern = rep.get("kernels") or {}
        comp = rep.get("compile") or {}
        log.info("wall %.2fs coverage %.1f%% compiles %s loads %s device "
                 "%.1f ms", tr["wall_s"], 100 * coverage,
                 comp.get("compiles"), comp.get("loads"),
                 kern.get("device_total_ms", 0.0))
        if coverage < COVERAGE_FLOOR:
            fails.append(
                f"phase coverage {100 * coverage:.1f}% of "
                f"{tr['wall_s']}s wall is below the "
                f"{100 * COVERAGE_FLOOR:.0f}% floor (phases: "
                f"{list((rep.get('phases') or {}))})"
            )
        if not kern.get("top_kernels"):
            fails.append("trace capture produced no kernel table")
        if args.device == "cuda":
            windows = kern.get("windows") or []
            if not windows or not all(w.get("device") for w in windows):
                fails.append(f"a capture traced no device event: {windows}")
            names = {k["name"] for k in kern.get("top_kernels") or []}
            for k in ("hist", "route"):
                if k not in names:
                    fails.append(f"kernel {k!r} missing from the kernel "
                                 f"table {sorted(names)}")
        kinds = {e.get("kind") for e in comp.get("entries") or []}
        want = {"instantiate"} if args.device == "cuda" else set()
        if not comp.get("compiles") or not want <= kinds:
            # the parser's library loads (or builds) on any device; on the
            # card the kernel libraries too, and each kernel's first
            # launch is an instantiation
            fails.append(f"build ledger lacks builds or loads{sorted(want)}: "
                         f"{comp}")
        if not (rep.get("mem") or {}).get("phase_peaks"):
            fails.append("memory sampler attributed no phase peaks")

        log.info("== step 2: serve the dumped model (?prof=1) ==")
        srv = serve_step(args, model_path)
        if not srv.get("prof_block"):
            fails.append("metrics_payload(prof=True) carried no prof block")
        rows = sum(v.get("rows", 0) for v in srv.get("rungs", {}).values())
        if len(srv.get("rungs") or {}) < 2 or rows != srv["rows_sent"]:
            fails.append(f"serve prof rungs {srv.get('rungs')} do not hold "
                         f"the {srv['rows_sent']} rows sent on two rungs")
        if srv.get("retraces_during_serve") or srv.get("unexpected_retraces"):
            fails.append(
                f"{srv['retraces_during_serve']:g} retrace(s) during the "
                "serve leg"
            )

        retraces = obs.snapshot()["counters"].get("health.retrace", 0.0)
        if retraces:
            fails.append(f"steady-state retraces: {retraces:g} != 0")

        out = {
            "schema": "ytkprof_drill",
            "schema_version": 1,
            "metric": "phase_coverage",
            "value": round(coverage, 4),
            "unit": "fraction",
            "device": args.device,
            "train": {
                "shape": {
                    "rows": args.rows,
                    "features": args.features,
                    "trees": args.trees,
                },
                "trees_built": tr["trees_built"],
                "train_loss": tr["train_loss"],
            },
            "wall_s": tr["wall_s"],
            "phase_coverage": round(coverage, 4),
            "compile": {
                "compiles": comp.get("compiles"),
                "loads": comp.get("loads"),
                "total_ms": comp.get("total_ms"),
                "by_program": comp.get("by_program"),
            },
            "retraces": retraces,
            "serve": srv,
            "prof": rep,
            # the whole run's build ledger: training's and serving's
            "ledger": profiler.LEDGER.snapshot(limit=64),
            "failures": fails,
            "ok": not fails,
        }
        profiler.configure_profiler(on=False, capture_dir=None)

    print(json.dumps({k: out[k] for k in
                      ("schema", "metric", "value", "wall_s", "retraces",
                       "ok", "failures")}), flush=True)
    print(profiler.format_report(rep), flush=True)
    with open(args.record, "w") as f:
        json.dump(out, f, indent=1)
    for msg in fails:
        log.error("FAIL: %s", msg)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
