"""Serving bench: compiled micro-batched scorer against the per-request
loop, on `--device` (the port's counterpart of scripts/serve_bench.py).

Measures, in one process:

  baseline   `predictor.score(row)` per request: the host tree walk
  rungs      CompiledScorer behind a MicroBatcher, driven by a bounded
             in-flight window of single-row requests (the /predict hot
             path minus HTTP framing), once per GBDT scoring rung in the
             same run:
               default  stacked torch walk, the bit-identity contract
               fused    the heap walk, K6 on the card (the plain version
                        on the CPU, backend "fused-plain")
               binned   u8/u16 bin indices walked by K7 on the card (the
                        native C++ walk on the CPU, "binned-native")

and reports each rung's req/s and p50/p99 (queue wait included), the bit
identity against `batch_scores`, the builds counted after warmup over a
mixed-size sweep (must be 0: in the port a build is a library build or a
kernel instantiation's first launch, obs/health.py), the binned rung's
quality band, the bf16 band of linear, FM and FFM, and the tracing,
quality and transform overhead arms through the full ServeApp path.

Model: the agaricus GBDT (trained on the spot) when the reference's demo
tree is present under REF, else a synthetic ensemble of
SERVE_BENCH_TREES x SERVE_BENCH_DEPTH (RandomState(0), 30 features), the
same model text as the JAX package's bench writes. Emits one JSON line,
schema "serve_rungs" v3, and writes it to --record when given.
`--rungs-fleet N` also boots an N-replica fleet whose workers inherit the
binned rung and embeds its run and the front's raw-splice / general-parse
ingress pair.

`--fleet` (schema "serve_fleet" v2): scaling over 1..--replicas replicas,
the hot-cache run and the mixed run (a reload and an overload burst
mid-load). Its floor is SERVE_FLEET_MIN_X times the single-process
default rung measured in the same invocation on the same device (the
record's `baseline`), not a record of another machine.

`--ramp` (schema "serve_scale" v1): a 1-replica fleet with an
autoscaling ceiling of --replicas under a rising then falling load.

Every record adds `device`, `card` (nvidia-smi's name and power limit),
`floors` (each speed floor's name, value, limit and met) and
`kernel_launches` (the process's launches of each kernel wrapper).
Floors, env: SERVE_BENCH_MIN_SPEEDUP (10), SERVE_RUNG_MIN_X (1.5, with
the best rung's p99 at most 1.05x the default's), SERVE_FLEET_MIN_X
(2.5), SCALE_MIN_PEAK (3), BENCH_REGRESS_TOL (0.15); bands
SERVE_BINNED_BAND (1e-9), SERVE_BF16_BAND (0.1). A fused or binned rung downgraded on the
card is a failure. Failures exit non-zero after the JSON line.

Usage:
    python -m ytklearn_tpu_torch.scripts.serve_bench [--seconds 2.0]
        [--record PATH] [--rungs-fleet N] [--device cpu]
    python -m ytklearn_tpu_torch.scripts.serve_bench --fleet --replicas 4
    python -m ytklearn_tpu_torch.scripts.serve_bench --ramp --replicas 4
"""

from __future__ import annotations

import argparse
import collections
import json
import logging
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from ytklearn_tpu_torch.config import knobs  # noqa: E402

REF = "/root/reference"


def _build_model(tmp_dir: str, device="cuda"):
    """-> (predictor, feature names, request generator, source tag)."""
    from ytklearn_tpu_torch.predict import create_predictor

    if os.path.exists(f"{REF}/demo/data/libsvm/agaricus.train.libsvm"):
        from ytklearn_tpu_torch.cli import convert_main, train_main

        train_ytk = os.path.join(tmp_dir, "agaricus.ytk")
        convert_main([
            "binary_classification@0,1",
            f"{REF}/demo/data/libsvm/agaricus.train.libsvm",
            train_ytk,
        ])
        model_path = os.path.join(tmp_dir, "gbdt.model")
        trees = int(os.environ.get("SERVE_BENCH_TREES", "500"))
        depth = int(os.environ.get("SERVE_BENCH_DEPTH", "6"))
        rc = train_main([
            "gbdt",
            f"{REF}/demo/gbdt/binary_classification/local_gbdt.conf",
            "--set", f"data.train.data_path={train_ytk}",
            "--set", "data.test.data_path=",
            "--set", f"model.data_path={model_path}",
            "--set", f"model.feature_importance_path={tmp_dir}/gbdt.fimp",
            "--set", "data.max_feature_dim=127",
            "--set", f"optimization.round_num={trees}",
            "--set", f"optimization.max_depth={depth}",
            "--set", "optimization.watch_train=false",
            "--set", "optimization.watch_test=false",
            "--device", str(device),
        ])
        if rc != 0:
            raise RuntimeError("agaricus gbdt training failed")
        # round_num defaults to 50 and caps use_rounds
        cfg = {"model": {"data_path": model_path},
               "optimization": {"loss_function": "sigmoid",
                                "round_num": trees}}
        pred = create_predictor("gbdt", cfg)
        names = sorted(
            {nm for t in pred.model.trees
             for i, nm in enumerate(t.feat_name) if not t.is_leaf(i)}
        )

        def gen_rows(rng, n):
            return [
                {nm: 1.0 for nm in rng.choice(names, size=22, replace=False)}
                for _ in range(n)
            ]

        return pred, names, gen_rows, "agaricus"

    # no reference tree: a synthetic ensemble in the reference dump format
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel, Tree

    rng = np.random.RandomState(0)
    names = [f"c{i}" for i in range(30)]

    def rand_tree(depth):
        t = Tree()

        def grow(nid, d):
            if d >= depth:
                t.leaf_value[nid] = float(rng.randn() * 0.3)
                return
            t.feat[nid] = 0
            t.feat_name[nid] = str(names[rng.randint(len(names))])
            t.split[nid] = float(rng.randn() * 0.5)
            t.default_left[nid] = bool(rng.rand() < 0.5)
            left, right = t.add_children(nid)
            grow(left, d + 1)
            grow(right, d + 1)

        grow(0, 0)
        return t

    trees = int(os.environ.get("SERVE_BENCH_TREES", "500"))
    depth = int(os.environ.get("SERVE_BENCH_DEPTH", "6"))
    model = GBDTModel(base_prediction=0.5, num_tree_in_group=1,
                      obj_name="sigmoid",
                      trees=[rand_tree(depth) for _ in range(trees)])
    model_path = os.path.join(tmp_dir, "gbdt.model")
    with open(model_path, "w") as f:
        f.write(model.dumps())
    cfg = {"model": {"data_path": model_path},
           "optimization": {"loss_function": "sigmoid",
                            "round_num": trees}}
    pred = create_predictor("gbdt", cfg)

    def gen_rows(rng, n):
        return [
            {nm: float(rng.randn()) for nm in names if rng.rand() > 0.3}
            for _ in range(n)
        ]

    return pred, names, gen_rows, "synthetic"


def resolve(device):
    """The bench's torch device (cuda unless asked for the CPU; raises
    without a GPU) and its card line."""
    from ytklearn_tpu_torch.device import resolve_device
    from ytklearn_tpu_torch.scripts._common import card_line

    dev = resolve_device(device)
    return dev, card_line(dev)


def floor(name: str, value, limit, met) -> dict:
    """One speed floor of a record: its measured value beside its limit."""
    return {"name": name, "value": value, "limit": limit, "met": bool(met)}


def kernel_launches() -> dict:
    """The process's launches of each kernel wrapper: K6 (heap_walk), K7
    (binned_walk) and, where it trains (the drift drill), K1-K5; 0 on the
    CPU, where the plain versions run."""
    from ytklearn_tpu_torch.gbdt import hist, route
    from ytklearn_tpu_torch.serve import kernels

    return {"heap_walk": kernels.heap_walk.launches,
            "binned_walk": kernels.binned_walk.launches,
            "hist_wave": hist.hist_wave.launches,
            "hist_wave_q": hist.hist_wave_q.launches,
            "hist_wave_gather_mxu": hist.hist_wave_gather_mxu.launches,
            "hist_wave_gather": hist.hist_wave_gather.launches,
            "route_wave": route.route_wave.launches}


def stamp(out: dict, dev, card: str, floors) -> dict:
    """The fields every record of the port adds to the reference's."""
    out["device"] = str(dev)
    out["card"] = card
    out["floors"] = floors
    out["kernel_launches"] = kernel_launches()
    return out


def bench_baseline(pred, rows, seconds: float) -> float:
    """Per-request score() loop -> req/s."""
    n, i, t0 = 0, 0, time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        pred.score(rows[i % len(rows)])
        i += 1
        n += 1
    return n / (time.perf_counter() - t0)


def bench_serve(scorer, rows, seconds: float, window: int = 512):
    """Bounded-in-flight single-row load through the MicroBatcher ->
    (req/s, latency list ms)."""
    from ytklearn_tpu_torch.serve import BatchPolicy, MicroBatcher

    batcher = MicroBatcher(
        scorer.score_and_predict,
        BatchPolicy(max_batch=scorer.ladder[-1], max_wait_ms=1.0,
                    max_queue=window * 4),
    )
    latencies = []
    inflight = collections.deque()
    n, i = 0, 0
    t0 = time.perf_counter()
    end = t0 + seconds
    try:
        while True:
            now = time.perf_counter()
            if now >= end and not inflight:
                break
            if now < end and len(inflight) < window:
                inflight.append((batcher.submit([rows[i % len(rows)]]),
                                 time.perf_counter()))
                i += 1
                continue
            pending, t_sub = inflight.popleft()
            pending.get(timeout=30.0)
            latencies.append((time.perf_counter() - t_sub) * 1e3)
            n += 1
    finally:
        batcher.close(drain=True)
    return n / (time.perf_counter() - t0), latencies


# ---------------------------------------------------------------------------
# Rung measurement (single process): default / fused / binned in one run
# ---------------------------------------------------------------------------

#: request sizes of the mixed sweep after warmup (every ladder rung)
SWEEP_SIZES = (1, 2, 3, 5, 7, 8, 13, 64, 65, 200, 512, 700)


def _rung_config(info: dict) -> dict:
    """The identity a rung record is comparable under."""
    return {
        "fused": info["mode"] == "fused",
        "binned": info["mode"] == "binned",
        "precision": info["precision"],
    }


def _builds() -> float:
    from ytklearn_tpu_torch import obs

    return obs.REGISTRY.counters.get("compile.traces.backend_compile", 0.0)


def measure_rung(pred, rows, gen_rows, rng, mode, seconds, log,
                 device="cuda"):
    """One scorer rung end to end -> (record, scorer, sample scores)."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.serve import CompiledScorer

    sample = rows[:512]
    want = pred.batch_scores(sample)
    d0 = obs.REGISTRY.counters.get("serve.downgrade.total", 0.0)
    scorer = CompiledScorer(pred, mode=None if mode == "default" else mode,
                            device=device)
    downgrades = obs.REGISTRY.counters.get("serve.downgrade.total", 0.0) - d0
    got = scorer.score_batch(sample)
    bit_identical = bool(np.array_equal(got, want))
    compiles0 = _builds()
    qps, lat = bench_serve(scorer, rows, seconds)
    # mixed request sizes straight into the scorer: the ladder must absorb
    # every shape without a new build or kernel instantiation
    for size in SWEEP_SIZES:
        scorer.score_batch(gen_rows(rng, size))
    retraces = _builds() - compiles0
    p50, p99 = _lat_stats(lat)
    info = scorer.rung_info()
    rec = {
        "rung": mode,
        **_rung_config(info),
        "backend": info["backend"],
        "requested": info["requested"],
        "downgraded": info["downgraded"],
        "downgrade_count": downgrades,
        "req_per_sec": round(qps, 1),
        "p50_ms": p50,
        "p99_ms": p99,
        "requests": len(lat),
        "bit_identical": bit_identical,
        # GBDT scores in f64 on every rung of the port
        "x64": True,
        "retraces_after_warmup": int(retraces),
    }
    if "bin_mode" in info:
        rec["bin_mode"] = info["bin_mode"]
        rec["bin_dtype"] = info["bin_dtype"]
    log.info(
        "rung %-7s %-24s %8.0f req/s p99=%6.1fms bit=%s retraces=%d%s",
        mode, rec["backend"], qps, p99, bit_identical, retraces,
        " DOWNGRADED" if rec["downgraded"] else "",
    )
    return rec, scorer, got


def binned_quality(pred, scorer, rows, default_scores, log) -> dict:
    """Quality band of the binned rung: the random request stream must
    match the default rung; rows planted exactly on split values may
    legally diverge (training rounds boundary ties up): their fraction is
    reported, not gated."""
    from ytklearn_tpu_torch.predict.base import numpy_activation

    sample = rows[:512]
    got = scorer.score_batch(sample)
    act = numpy_activation(pred.loss) or (lambda s: s)
    p_def = act(np.asarray(default_scores))
    p_bin = act(np.asarray(got))
    diverged = int(np.sum(got != np.asarray(default_scores)))
    # boundary probe: one row per (feature, split value), value == split
    probe = []
    for t in pred.model.trees[: pred.use_rounds]:
        for nid in range(t.n_nodes()):
            if not t.is_leaf(nid):
                probe.append({t.feat_name[nid]: float(t.split[nid])})
            if len(probe) >= 256:
                break
        if len(probe) >= 256:
            break
    b_def = np.asarray([pred.score(r) for r in probe])
    b_bin = scorer.score_batch(probe)
    frac = float(np.mean(b_bin != b_def)) if len(probe) else 0.0
    out = {
        "stream_rows": len(sample),
        "stream_diverged_rows": diverged,
        "max_abs_score_diff": float(np.max(np.abs(got - default_scores))),
        "max_abs_pred_diff": float(np.max(np.abs(p_bin - p_def))),
        "boundary_rows": len(probe),
        "boundary_diverged_fraction": round(frac, 4),
    }
    log.info("binned quality: %s", out)
    return out


def measure_bf16_bands(tmp_dir, log, device="cuda") -> dict:
    """Per-family bf16 precision-rung band: max |prediction diff| against
    the f64 lowering on one request stream (linear / FM / FFM)."""
    from ytklearn_tpu_torch.serve import CompiledScorer
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    rng = np.random.RandomState(11)
    out = {}
    # compile_credit: these builds happen next to armed GBDT-rung scorers,
    # whose sentinels must not count them as steady-state retraces
    with compile_credit():
        for family, build in (
            ("linear", _build_linear_model),
            ("fm", _build_fm_model),
            ("ffm", _build_ffm_model),
        ):
            pred, names = build(tmp_dir, rng)
            rows = [
                {nm: float(rng.randn()) for nm in names if rng.rand() > 0.3}
                for _ in range(256)
            ]
            s64 = CompiledScorer(pred, ladder=(256,), device=device)
            s16 = CompiledScorer(pred, ladder=(256,), precision="bf16",
                                 device=device)
            p64 = np.asarray(s64.predict_batch(rows), np.float64)
            p16 = np.asarray(s16.predict_batch(rows), np.float64)
            band = float(np.max(np.abs(p64 - p16)))
            out[family] = round(band, 6)
            log.info("bf16 band %-6s max |pred diff| = %.3g", family, band)
    return out


def _build_linear_model(tmp_dir, rng, n=24):
    from ytklearn_tpu_torch.predict import create_predictor

    names = [f"c{i}" for i in range(n)]
    path = os.path.join(tmp_dir, "bench_linear.model")
    lines = [f"{nm},{rng.randn():.6f},1.0" for nm in names]
    lines.append(f"_bias_,{rng.randn():.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = {"model": {"data_path": path},
           "loss": {"loss_function": "sigmoid"}}
    return create_predictor("linear", cfg), names


def _build_fm_model(tmp_dir, rng, n=24, k=8):
    from ytklearn_tpu_torch.predict import create_predictor

    names = [f"c{i}" for i in range(n)]
    path = os.path.join(tmp_dir, "bench_fm.model")
    lines = [
        nm + "," + ",".join(f"{v:.6f}" for v in rng.randn(1 + k))
        for nm in names
    ]
    lines.append("_bias_," + ",".join(f"{v:.6f}" for v in rng.randn(1 + k)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = {"model": {"data_path": path},
           "loss": {"loss_function": "sigmoid"}, "k": [1, k]}
    return create_predictor("fm", cfg), names


def _build_ffm_model(tmp_dir, rng, n_fields=4, per_field=4, k=4):
    from ytklearn_tpu_torch.predict import create_predictor

    fields = [f"fld{i}" for i in range(n_fields)]
    names = [f"{f}@x{j}" for f in fields for j in range(per_field)]
    fd = os.path.join(tmp_dir, "bench_field.dict")
    with open(fd, "w") as f:
        f.write("\n".join(fields) + "\n")
    path = os.path.join(tmp_dir, "bench_ffm.model")
    stride = n_fields * k
    lines = [
        nm + "," + ",".join(f"{v:.6f}" for v in rng.randn(1 + stride))
        for nm in names
    ]
    lines.append(
        "_bias_," + ",".join(f"{v:.6f}" for v in rng.randn(1 + stride))
    )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    cfg = {"model": {"data_path": path, "field_dict_path": fd},
           "loss": {"loss_function": "sigmoid"}, "k": [1, k]}
    return create_predictor("ffm", cfg), names


# ---------------------------------------------------------------------------
# Tracing, quality and transform overhead (through the ServeApp path)
# ---------------------------------------------------------------------------


def _drive_app_threads(app, rows, seconds, threads=16):
    """Synchronous app.predict() from N client threads -> completed req/s.
    The same harness for every arm, so the ratio isolates the plane's
    cost, not the load loop's noise."""
    import threading as _threading

    from ytklearn_tpu_torch.obs.recorder import thread_guard

    stop = [False]
    counts = [0] * threads

    @thread_guard
    def worker(k):
        i = k
        while not stop[0]:
            try:
                app.predict([rows[i % len(rows)]], timeout=30.0)
                counts[k] += 1
            # an overload shed or timeout mid-arm is expected under the
            # driving load; only completed requests count
            except Exception:  # noqa: BLE001
                pass
            i += threads

    ts = [_threading.Thread(target=worker, args=(k,), daemon=True)
          for k in range(threads)]
    t0 = time.perf_counter()
    for t in ts:
        t.start()
    time.sleep(seconds)
    stop[0] = True
    for t in ts:
        t.join(timeout=30.0)
    return sum(counts) / (time.perf_counter() - t0)


def _gbdt_app(tmp_dir, trees, device):
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    cfg = {"model": {"data_path": os.path.join(tmp_dir, "gbdt.model")},
           "optimization": {"loss_function": "sigmoid", "round_num": trees}}
    reg = ModelRegistry(watch_interval_s=0, device=device)
    with compile_credit():
        reg.load("default", "gbdt", cfg)
    app = ServeApp(reg, BatchPolicy(max_batch=512, max_wait_ms=1.0,
                                    max_queue=1 << 15))
    return reg, app


def _close_app(reg, app) -> None:
    for b in app._batchers.values():
        b.close(drain=True)
    reg.close()


def measure_tracing_overhead(tmp_dir, trees, rows, seconds, log,
                             device="cuda") -> dict:
    """The default rung driven through ServeApp.predict with the trace
    plane off, head-sampled at 1% and always on; the sampled rate (the
    production default) is held within BENCH_REGRESS_TOL of off."""
    from ytklearn_tpu_torch.obs import trace as obs_trace

    reg, app = _gbdt_app(tmp_dir, trees, device)
    out = {"sample_rate": 0.01, "threads": 16}
    try:
        _drive_app_threads(app, rows, min(seconds, 1.0))  # warm the path
        for label, rate in (("off", 0.0), ("sampled", 0.01),
                            ("always", 1.0)):
            obs_trace.configure_tracing(sample=rate, reset=True)
            qps = _drive_app_threads(app, rows, seconds)
            out[f"{label}_req_per_sec"] = round(qps, 1)
            if label != "off":
                out[f"{label}_exemplars"] = len(obs_trace.exemplars())
            log.info("tracing overhead arm %-8s %8.0f req/s", label, qps)
    finally:
        # restore the env-configured plane for whatever runs next
        obs_trace.configure_tracing(
            sample=knobs.get_float("YTK_TRACE_SAMPLE") or 0.0, reset=True
        )
        _close_app(reg, app)
    off = out.get("off_req_per_sec") or 0.0
    if off > 0:
        out["sampled_over_off"] = round(out["sampled_req_per_sec"] / off, 4)
        out["always_over_off"] = round(out["always_req_per_sec"] / off, 4)
    log.info("tracing overhead: %s", out)
    return out


def _ensure_quality_sidecar(tmp_dir, pred, rows) -> None:
    """A quality baseline for the bench model: a trained model has one of
    its trainer's; the synthetic model gets one built from the request
    stream, so the arms measure the real sketching path."""
    from ytklearn_tpu_torch.obs import quality as obs_quality

    side = obs_quality.quality_sidecar_path(
        os.path.join(tmp_dir, "gbdt.model"))
    if os.path.exists(side):
        return
    names = sorted({nm for r in rows for nm in r})
    X = np.full((len(rows), len(names)), np.nan)
    col = {nm: j for j, nm in enumerate(names)}
    for i, r in enumerate(rows):
        for nm, v in r.items():
            X[i, col[nm]] = float(v)
    payload = obs_quality.build_training_sketch(
        X, names, preds=np.asarray(pred.batch_predicts(rows[:512])),
    )
    obs_quality.dump_quality_sidecar(pred.fs, side, payload)


def measure_quality_overhead(tmp_dir, pred, trees, rows, seconds, log,
                             device="cuda") -> dict:
    """The default rung through ServeApp.predict with the model-quality
    row sampler off, at the default YTK_QUALITY_SAMPLE and always on, the
    evaluator thread running; the default rate is held within
    BENCH_REGRESS_TOL of off."""
    from ytklearn_tpu_torch.obs import quality as obs_quality

    _ensure_quality_sidecar(tmp_dir, pred, rows)
    default_rate = knobs.KNOBS["YTK_QUALITY_SAMPLE"].default
    reg, app = _gbdt_app(tmp_dir, trees, device)
    out = {"sample_rate": default_rate, "threads": 16}
    obs_quality.start_quality_evaluator(interval_s=1.0)
    try:
        _drive_app_threads(app, rows, min(seconds, 1.0))  # warm the path
        for label, rate in (("off", 0.0), ("sampled", default_rate),
                            ("always", 1.0)):
            obs_quality.configure_quality(sample=rate, seed=0, reset=True)
            qps = _drive_app_threads(app, rows, seconds)
            out[f"{label}_req_per_sec"] = round(qps, 1)
            if label != "off":
                snap = app.quality.evaluate(feed_sentinels=False)
                out[f"{label}_rows_sampled"] = sum(
                    int(m.get("rows_sampled") or 0) for m in snap.values()
                )
            log.info("quality overhead arm %-8s %8.0f req/s", label, qps)
    finally:
        obs_quality.stop_quality_evaluator()
        # restore the env-configured plane for whatever runs next
        obs_quality.configure_quality(
            sample=knobs.get_float("YTK_QUALITY_SAMPLE") or 0.0,
            seed=knobs.get_int("YTK_QUALITY_SEED") or 0, reset=True,
        )
        _close_app(reg, app)
    off = out.get("off_req_per_sec") or 0.0
    if off > 0:
        out["sampled_over_off"] = round(out["sampled_req_per_sec"] / off, 4)
        out["always_over_off"] = round(out["always_req_per_sec"] / off, 4)
    log.info("quality overhead: %s", out)
    return out


def measure_transform_overhead(tmp_dir, rows_n, seconds, log,
                               device="cuda") -> dict:
    """A hashed + transform-stat linear model served raw feature dicts
    against the same model fed pre-assembled vectors: the per-row cost of
    the feature pipeline inside the replica, bit identity across the two
    paths and no build after warmup on the raw path."""
    from ytklearn_tpu_torch.io.feature_hash import FeatureHash
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import (
        BatchPolicy, CompiledScorer, ModelRegistry, ServeApp,
    )
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    rng = np.random.RandomState(23)
    prefix, hseed, buckets, n_raw = "fh", 17, 4096, 96
    raw_names = [f"raw{i}" for i in range(n_raw)]
    fh = FeatureHash(buckets, hseed, prefix)
    hashed = sorted({fh.hash_name(nm)[0] for nm in raw_names})
    path = os.path.join(tmp_dir, "bench_transform.model")
    with open(path, "w") as f:
        for nm in hashed:
            f.write(f"{nm},{rng.randn():.6f},1.0\n")
        f.write(f"_bias_,{rng.randn():.6f}\n")
    with open(path + "_feature_transform_stat", "w") as f:
        for nm in hashed:
            f.write(
                f"{nm}###mode=standardization, mean={rng.randn():.4f}, "
                f"stdvar={0.5 + rng.rand():.4f}, max=10.0, min=-10.0, "
                "rangeMax=1.0, rangeMin=-1.0\n"
            )
    raw_cfg = {
        "model": {"data_path": path},
        "loss": {"loss_function": "sigmoid"},
        "feature": {
            "feature_hash": {
                "need_feature_hash": True, "bucket_size": buckets,
                "seed": hseed, "feature_prefix": prefix,
            },
            "transform": {"switch_on": True},
        },
    }
    plain_cfg = {"model": {"data_path": path},
                 "loss": {"loss_function": "sigmoid"}}
    raw_rows = [
        {nm: float(rng.randn()) for nm in raw_names if rng.rand() > 0.3}
        for _ in range(rows_n)
    ]
    # what a client doing the pipeline itself sends: hashed names, stats
    # replayed (prep_row's output is that contract)
    raw_pred = create_predictor("linear", raw_cfg)
    assembled_rows = [dict(raw_pred.pipeline.prep_row(r)) for r in raw_rows]

    out = {"threads": 16, "raw_features": n_raw, "hash_buckets": buckets}
    with compile_credit():
        s_raw = CompiledScorer(raw_pred, ladder=(256,), device=device)
        s_pre = CompiledScorer(
            create_predictor("linear", plain_cfg), ladder=(256,),
            device=device,
        )
        out["assembled_bit_identical"] = bool(np.array_equal(
            s_raw.score_batch(raw_rows[:256]),
            s_pre.score_batch(assembled_rows[:256]),
        ))
    for label, cfg, arm_rows in (
        ("raw", raw_cfg, raw_rows),
        ("assembled", plain_cfg, assembled_rows),
    ):
        reg = ModelRegistry(watch_interval_s=0, device=device)
        with compile_credit():
            reg.load("default", "linear", cfg)
        app = ServeApp(reg, BatchPolicy(max_batch=512, max_wait_ms=1.0,
                                        max_queue=1 << 15))
        try:
            _drive_app_threads(app, arm_rows, min(seconds, 1.0))  # warm
            c0 = _builds()
            qps = _drive_app_threads(app, arm_rows, seconds)
            retraces = _builds() - c0
        finally:
            _close_app(reg, app)
        out[f"{label}_req_per_sec"] = round(qps, 1)
        out[f"{label}_us_per_row"] = (
            round(1e6 / qps, 2) if qps > 0 else None
        )
        out[f"{label}_retraces"] = int(retraces)
        log.info("transform overhead arm %-10s %8.0f req/s retraces=%d",
                 label, qps, int(retraces))
    a = out.get("assembled_req_per_sec") or 0.0
    r = out.get("raw_req_per_sec") or 0.0
    if a > 0 and r > 0:
        out["raw_over_assembled"] = round(r / a, 4)
        out["transform_us_per_row"] = round(1e6 / r - 1e6 / a, 2)
    log.info("transform overhead: %s", out)
    return out


# ---------------------------------------------------------------------------
# Front HTTP ingress overhead (raw-splice vs general parse)
# ---------------------------------------------------------------------------


def bench_front_http(front, frags, rows_per_body, seconds, threads, log):
    """POST pre-encoded bodies at the front's own HTTP listener over
    persistent connections. Strict `{"rows":[...]}` bodies ride the
    raw-splice path; the same bodies with one extra key force the general
    parse: the pair isolates the handler's decode + re-encode cost."""
    import http.client
    import threading as _threading

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs.recorder import thread_guard

    if front.port == 0 or front._httpd is None:
        front.serve_http()

    def bodies_for(extra_key: bool):
        out = []
        for i in range(0, max(len(frags) - rows_per_body, 1), rows_per_body):
            body = '{"rows":[' + ",".join(frags[i: i + rows_per_body]) + "]"
            if extra_key:
                body += ',"client":"bench"'  # any extra key defeats splice
            out.append((body + "}").encode())
        return out

    def drive(bodies):
        stop = [False]
        counts = [0] * threads
        errors = [0] * threads

        @thread_guard
        def worker(k):
            conn = http.client.HTTPConnection(
                "127.0.0.1", front.port, timeout=60)
            i = k
            while not stop[0]:
                try:
                    conn.request(
                        "POST", "/predict", bodies[i % len(bodies)],
                        {"Content-Type": "application/json"},
                    )
                    r = conn.getresponse()
                    r.read()
                    if r.status == 200:
                        counts[k] += 1
                    else:
                        errors[k] += 1
                except OSError:
                    errors[k] += 1
                    conn.close()
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", front.port, timeout=60)
                i += threads
            conn.close()

        ts = [
            _threading.Thread(target=worker, args=(k,), daemon=True)
            for k in range(threads)
        ]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        time.sleep(seconds)
        stop[0] = True
        for t in ts:
            t.join(timeout=30.0)
        dt = time.perf_counter() - t0
        return sum(counts) / dt, sum(errors)

    splice0 = obs.REGISTRY.counters.get("serve.front.raw_splice", 0.0)
    qps_splice, err_s = drive(bodies_for(extra_key=False))
    spliced = obs.REGISTRY.counters.get(
        "serve.front.raw_splice", 0.0) - splice0
    qps_general, err_g = drive(bodies_for(extra_key=True))
    rps_splice = qps_splice * rows_per_body
    rps_general = qps_general * rows_per_body
    overhead_us = (
        (1e6 / rps_general - 1e6 / rps_splice) if rps_general and rps_splice
        else None
    )
    out = {
        "rows_per_body": rows_per_body,
        "threads": threads,
        "raw_splice": {"req_per_sec": round(qps_splice, 1),
                       "rows_per_sec": round(rps_splice, 1),
                       "errors": err_s},
        "general_parse": {"req_per_sec": round(qps_general, 1),
                          "rows_per_sec": round(rps_general, 1),
                          "errors": err_g},
        "raw_splice_requests": spliced,
        "parse_overhead_us_per_row": (
            round(overhead_us, 3) if overhead_us is not None else None
        ),
    }
    log.info("front http ingress: %s", out)
    return out


# ---------------------------------------------------------------------------
# Fleet scenario matrix (--fleet): scaling 1..N replicas, hot-cache, mixed
# ---------------------------------------------------------------------------


def _write_serve_conf(tmp_dir: str, trees: int) -> str:
    conf_path = os.path.join(tmp_dir, "serve.conf")
    with open(conf_path, "w") as f:
        json.dump({
            "model": {"data_path": os.path.join(tmp_dir, "gbdt.model")},
            "optimization": {"loss_function": "sigmoid",
                             "round_num": trees},
        }, f)
    return conf_path


def _boot_front(conf_path, replicas, slo_ms, cache_rows, watch_s,
                front_queue, replicas_min=None, replicas_max=None,
                autoscale=None, front_slo_ms=None, device="cuda"):
    from ytklearn_tpu_torch.serve import (BatchPolicy, FleetFront,
                                          serve_worker_argv)

    flags = [
        "--watch-interval", str(watch_s),
        "--slo-ms", str(slo_ms),
        "--cache-rows", str(cache_rows),
        "--max-queue", "16384",
        "--max-batch", "512",
    ]
    front = FleetFront(
        serve_worker_argv(conf_path, "gbdt", flags, device=str(device)),
        replicas,
        policy=BatchPolicy(max_batch=512, max_wait_ms=0.5,
                           max_queue=front_queue),
        ready_timeout_s=600.0,
        # ramp mode arms the front's SLO (burn sentinel and the policy's
        # p99-vs-SLO up signal); workers get --slo-ms for AIMD either way
        slo_ms=front_slo_ms,
        replicas_min=replicas_min,
        replicas_max=replicas_max,
        autoscale=autoscale,
    )
    return front.start()


def drive_front(front, rows, seconds: float, window: int, row_picker=None):
    """Bounded-in-flight single-row load against front.submit ->
    (req/s, latency list ms): the /predict hot path minus client HTTP."""
    if row_picker is None:
        def row_picker(i):
            return rows[i % len(rows)]

    inflight = collections.deque()
    latencies = []
    n, i = 0, 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end and not inflight:
            break
        if now < end and len(inflight) < window:
            inflight.append((front.submit([row_picker(i)]),
                             time.perf_counter()))
            i += 1
            continue
        pending, t_sub = inflight.popleft()
        pending.get(timeout=300.0)
        latencies.append((time.perf_counter() - t_sub) * 1e3)
        n += 1
    return n / (time.perf_counter() - t0), latencies


FLEET_KEYS = ("health.retrace", "serve.reload", "serve.cache.hit",
              "serve.cache.miss", "serve.cache.evict", "serve.shed",
              "serve.batches", "serve.batch_rows")


def _fleet_counters(front):
    """Scrape every replica's /metrics -> (aggregated counters, per id)."""
    from ytklearn_tpu_torch.serve.fleet import http_json

    agg = {k: 0.0 for k in FLEET_KEYS}
    per = {}
    for rid, h in sorted(front.handles.items()):
        try:
            status, m = http_json("GET", h.port, "/metrics", timeout=15.0)
        except OSError:
            per[str(rid)] = {"scrape_failed": True}
            continue
        c = (m.get("counters") or {}) if status == 200 else {}
        per[str(rid)] = {k: c.get(k, 0.0) for k in FLEET_KEYS}
        per[str(rid)]["pid"] = (m.get("replica") or {}).get("pid")
        per[str(rid)]["batching"] = m.get("batching")
        for k in FLEET_KEYS:
            agg[k] += c.get(k, 0.0)
    return agg, per


def _lat_stats(latencies):
    lat = np.asarray(latencies) if latencies else np.asarray([0.0])
    return (round(float(np.percentile(lat, 50)), 3),
            round(float(np.percentile(lat, 99)), 3))


def fleet_mixed(conf_path, tmp_dir, replicas, slo_ms, rows, seconds, log,
                device="cuda"):
    """Hot reload and an overload shed mid-load -> the scenario record."""
    from ytklearn_tpu_torch.serve.batcher import OverloadError

    model_path = os.path.join(tmp_dir, "gbdt.model")
    # a small front queue, so the burst provably sheds
    front = _boot_front(conf_path, replicas, slo_ms, cache_rows=0,
                        watch_s=0.5, front_queue=512, device=device)
    versions = collections.Counter()
    sheds = 0
    failures = []
    inflight = collections.deque()
    window = 256 * replicas
    n = i = 0
    try:
        t0 = time.perf_counter()
        end = t0 + seconds
        reload_t, burst_t = t0 + seconds * 0.25, t0 + seconds * 0.6
        reload_done = burst_done = False
        while True:
            now = time.perf_counter()
            if now >= end and not inflight:
                break
            if not reload_done and now >= reload_t:
                # a re-dump lands mid-traffic: mtime bump + version
                # sidecar -> every worker's watcher warms the new scorer
                # to the side and swaps (one version a batch throughout)
                os.utime(model_path)
                with open(model_path + ".version.json", "w") as f:
                    json.dump({"version": 2}, f)
                reload_done = True
                log.info("fleet mixed: model re-dump landed")
                continue
            if not burst_done and now >= burst_t:
                # overload burst: far past the front queue bound in one go
                burst = 0
                for k in range(4096):
                    try:
                        inflight.append(
                            (front.submit([rows[(i + k) % len(rows)]]),
                             time.perf_counter()))
                        burst += 1
                    except OverloadError:
                        sheds += 1
                i += burst
                burst_done = True
                log.info("fleet mixed: burst enqueued=%d shed=%d",
                         burst, sheds)
                continue
            if now < end and len(inflight) < window:
                try:
                    inflight.append(
                        (front.submit([rows[i % len(rows)]]),
                         time.perf_counter()))
                    i += 1
                except OverloadError:
                    sheds += 1
                continue
            pending, _ts = inflight.popleft()
            try:
                pending.get(timeout=300.0)
                meta = pending.meta or {}
                versions[meta.get("version")] += 1
                n += 1
            except Exception as e:  # noqa: BLE001 (a failed request is the finding)
                failures.append(f"{type(e).__name__}: {e}"[:200])
        agg, _per = _fleet_counters(front)
    finally:
        front.stop(drain=True, timeout=60.0)
    return {
        "completed": True,
        "requests": n,
        "shed_429": sheds,
        "failures": len(failures),
        "failure_samples": failures[:3],
        "versions_seen": sorted(int(v) for v in versions if v is not None),
        "responses_per_version": {str(k): v for k, v in sorted(
            versions.items(), key=lambda kv: str(kv[0]))},
        "reloads_fleet": agg["serve.reload"],
        "retraces_fleet": agg["health.retrace"],
    }


def _obs_on() -> None:
    """Obs collection on (unless YTK_OBS=0), in this process and, through
    the environment, in every replica worker it spawns."""
    from ytklearn_tpu_torch import obs

    # an env write for the spawned workers; the read stays in knobs.py
    os.environ.setdefault("YTK_OBS", "1")
    if knobs.get_raw("YTK_OBS") != "0":
        obs.configure(enabled=True)


def ramp_main(args, log) -> int:
    """--ramp: rising -> falling offered load against a 1-replica fleet
    with an autoscaling band up to --replicas; records the grow 1 -> N and
    the shrink N -> 1 with the scale events, the shed window and fleet
    p99 (schema serve_scale)."""
    import tempfile
    import threading

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs.recorder import thread_guard
    from ytklearn_tpu_torch.serve.batcher import OverloadError

    dev, card = resolve(args.device)
    _obs_on()
    min_peak = int(os.environ.get("SCALE_MIN_PEAK", "3"))
    rmin, rmax = 1, args.replicas
    # fast-tick policy: the ramp must resolve in bench time, not ops time
    autoscale = dict(
        interval_s=0.5,
        up_backlog=192.0, down_backlog=16.0,
        up_windows=2, down_windows=6,
        up_cooldown_s=2.0, down_cooldown_s=5.0,
    )
    peak_window = args.window * rmax
    with tempfile.TemporaryDirectory() as tmp_dir:
        pred, _names, gen_rows, source = _build_model(tmp_dir, dev)
        trees = len(pred.model.trees)
        conf_path = _write_serve_conf(tmp_dir, trees)
        rng = np.random.RandomState(7)
        frags = [json.dumps(r) for r in gen_rows(rng, args.requests)]
        log.info("ramp bench: model=%s trees=%d band=[%d, %d] "
                 "peak window=%d device=%s", source, trees, rmin, rmax,
                 peak_window, dev)
        front = _boot_front(
            conf_path, rmin, args.slo_ms, 0, 0,
            # queue bound below the peak offered in-flight: the pre-scale
            # spike must provably shed, and stop once capacity lands
            front_queue=max(256, peak_window // 2),
            replicas_min=rmin, replicas_max=rmax, autoscale=autoscale,
            front_slo_ms=args.slo_ms, device=dev,
        )
        samples = []  # (t, ready, slots, backlog)
        sampler_stop = threading.Event()

        @thread_guard
        def sampler():
            t0s = time.perf_counter()
            while not sampler_stop.wait(0.25):
                ready_ids = front._ready_ids()
                samples.append((
                    round(time.perf_counter() - t0s, 2),
                    len(ready_ids),
                    len(front.handles),
                    sum(front._load_of(r) for r in ready_ids),
                ))

        sampler_thread = threading.Thread(target=sampler, daemon=True)
        sampler_thread.start()

        phases = []
        state = {"phase": "warm", "t0": 0.0}

        def enter(phase, t):
            state["phase"], state["t0"] = phase, t
            phases.append({"phase": phase, "t_s": round(t, 2),
                           "ready": len(front._ready_ids())})
            log.info("ramp phase -> %s at t=%.1fs (ready=%d)",
                     phase, t, len(front._ready_ids()))

        def window_at(t):
            ph = state["phase"]
            ready = len(front._ready_ids())
            if ph == "warm":
                if t - state["t0"] >= 3.0:
                    enter("rise", t)
                return 16
            if ph == "rise":
                if ready >= rmax:
                    enter("sustain", t)
                elif t - state["t0"] > args.ramp_grow_timeout:
                    enter("sustain", t)  # the checks judge the peak
                return peak_window
            if ph == "sustain":
                if t - state["t0"] >= 3.0:
                    enter("fall", t)
                return peak_window
            if ph == "fall":
                if ready <= rmin or t - state["t0"] > args.ramp_shrink_timeout:
                    enter("done", t)
                    return None
                return 8
            return None

        inflight = collections.deque()
        latencies = []  # (latency_ms, t_submitted)
        sheds = []
        failures = []
        n = i = 0
        enter("warm", 0.0)
        t0 = time.perf_counter()
        try:
            while True:
                now = time.perf_counter()
                t = now - t0
                w = window_at(t)
                if w is None and not inflight:
                    break
                if w is not None and len(inflight) < w:
                    try:
                        submitted = front.submit([frags[i % len(frags)]])
                    except OverloadError:
                        submitted = None
                        sheds.append(round(t, 3))
                    if submitted is None:
                        time.sleep(0.002)  # shed storm: a client backoff
                        continue
                    inflight.append((submitted, now))
                    i += 1
                    continue
                if not inflight:
                    time.sleep(0.005)
                    continue
                pending, t_sub = inflight.popleft()
                try:
                    pending.get(timeout=300.0)
                    latencies.append(
                        ((time.perf_counter() - t_sub) * 1e3,
                         round(t_sub - t0, 3)))
                    n += 1
                except Exception as e:  # noqa: BLE001 (a failed request is the finding)
                    failures.append(f"{type(e).__name__}: {e}"[:200])
            # "done" fires on the fence (ready drops the moment the victim
            # is fenced); the drain may still be in flight, and the history
            # ring samples once a second: wait for the topology to settle
            # at the floor and the ring to record it
            settle = time.perf_counter() + 60.0
            while time.perf_counter() < settle and (
                len(front.handles) > rmin
                or len(front._ready_ids()) != rmin
            ):
                time.sleep(0.1)
            time.sleep(2.5)  # >= 2 history samples at the floor
            metrics = front.metrics_payload(history=True)
        finally:
            sampler_stop.set()
            sampler_thread.join(timeout=5.0)
            front.stop(drain=True, timeout=60.0)

    peak = max((s[1] for s in samples), default=rmin)
    end = samples[-1][1] if samples else 0
    # sheds after the fleet first held its peak mean capacity arrived and
    # the queues still overflowed: a real failure
    t_peak = next((s[0] for s in samples if s[1] >= peak), 0.0)
    sheds_after_peak = [s for s in sheds if s > t_peak]
    lat_all = [m for m, _t in latencies]
    lat_at_peak = [m for m, t in latencies if t > t_peak]
    p50, p99 = _lat_stats(lat_all)
    _p50_pk, p99_pk = _lat_stats(lat_at_peak)
    scale_events = [
        {"name": e.get("name"), "ts": round(e.get("ts", 0.0), 3),
         "args": e.get("args", {})}
        for e in obs.REGISTRY.events
        if str(e.get("name", "")).startswith("serve.scale.")
    ]
    hist = ((metrics.get("history") or {}).get("series") or {}).get(
        "serve.fleet.replicas") or []
    counters = obs.snapshot()["counters"]
    hist_vals = [v for _ts, v in hist]
    floors = [floor("SCALE_MIN_PEAK", peak, min_peak, peak >= min_peak)]
    out = {
        "schema_version": 1,
        "schema": "serve_scale",
        "metric": f"serve_scale_ramp_{source}_gbdt",
        "value": peak,
        "unit": "replicas",
        "replicas_min": rmin,
        "replicas_max": rmax,
        "slo_ms": args.slo_ms,
        "autoscale": autoscale,
        "data_source": source,
        "trees": trees,
        "requests": n,
        "failures": len(failures),
        "failure_samples": failures[:3],
        "shed_429": len(sheds),
        "shed_window_s": ([round(min(sheds), 2), round(max(sheds), 2)]
                          if sheds else None),
        "t_peak_s": round(t_peak, 2),
        "sheds_after_peak": len(sheds_after_peak),
        "peak_replicas": peak,
        "end_replicas": end,
        "p50_ms": p50,
        "p99_ms": p99,
        "p99_at_peak_ms": p99_pk,
        "phases": phases,
        "scale_counters": {
            k: counters.get(k, 0.0)
            for k in ("serve.scale.up", "serve.scale.down",
                      "serve.scale.deferred", "serve.scale.blocked")
        },
        "scale_events": scale_events,
        # the /metrics?history=1 replica-count ring an operator's scrape
        # shows the ramp as
        "history_replicas": [[round(ts, 2), v] for ts, v in hist],
        "timeline": [list(s) for s in samples[:: max(1, len(samples) // 120)]],
    }
    stamp(out, dev, card, floors)
    print(json.dumps(out), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)

    fails = []
    if failures:
        fails.append(
            f"{len(failures)} request failure(s) across the ramp: "
            f"{failures[:3]} (sheds are expected; failures are not)"
        )
    if peak < min_peak:
        fails.append(
            f"fleet only reached {peak} replica(s) under the rising load "
            f"(want >= {min_peak}; env SCALE_MIN_PEAK)"
        )
    if end != rmin:
        fails.append(
            f"fleet ended at {end} replica(s), not the {rmin} floor "
            "(scale-down never completed)"
        )
    if sheds_after_peak:
        fails.append(
            f"{len(sheds_after_peak)} shed(s) after the fleet reached its "
            f"peak at t={t_peak:.1f}s: sheds must be confined to the "
            "pre-scale window"
        )
    ev_names = {e["name"] for e in scale_events}
    if "serve.scale.up" not in ev_names or "serve.scale.down" not in ev_names:
        fails.append(
            f"scale decisions missing from the flight ring: {sorted(ev_names)}"
        )
    if not hist_vals or max(hist_vals) < min_peak or hist_vals[-1] != rmin:
        fails.append(
            "the /metrics?history=1 serve.fleet.replicas ring does not "
            f"show the ramp (series tail: {hist_vals[-8:]})"
        )
    for msg in fails:
        log.error("FAIL: %s", msg)
    return 1 if fails else 0


def fleet_main(args, log) -> int:
    """--fleet: scaling over 1..--replicas, hot cache, mixed traffic; the
    floor is the single-process default rung measured here first."""
    import tempfile

    dev, card = resolve(args.device)
    _obs_on()
    from ytklearn_tpu_torch.obs import health

    health.install_trace_counters()

    with tempfile.TemporaryDirectory() as tmp_dir:
        pred, _names, gen_rows, source = _build_model(tmp_dir, dev)
        trees = len(pred.model.trees)
        conf_path = _write_serve_conf(tmp_dir, trees)
        rng = np.random.RandomState(7)
        rows = gen_rows(rng, args.requests)
        # pre-serialized row fragments: the front's raw-splice forward path
        frags = [json.dumps(r) for r in rows]
        # the fleet's yardstick: one process's default rung on this device,
        # in this invocation, driven as the rung matrix drives it
        base_rec, _scorer, _got = measure_rung(
            pred, rows, gen_rows, np.random.RandomState(8), "default",
            args.seconds, log, device=dev)
        del _scorer
        single = base_rec["req_per_sec"]
        log.info("fleet bench: model=%s trees=%d replicas up to %d "
                 "device=%s single-process default rung %.0f req/s",
                 source, trees, args.replicas, dev, single)

        scaling = []
        front_http = None
        for n_rep in range(1, args.replicas + 1):
            window = args.window * n_rep
            front = _boot_front(conf_path, n_rep, args.slo_ms, 0, 0,
                                front_queue=window * 4, device=dev)
            try:
                drive_front(front, frags, 1.0, window)  # settle AIMD first
                qps, lat = drive_front(front, frags, args.seconds, window)
                agg, _per = _fleet_counters(front)
                if n_rep == args.replicas:
                    # front-overhead line: raw-splice HTTP ingress against
                    # the general parse, on the full-size fleet
                    front_http = bench_front_http(
                        front, frags, rows_per_body=64,
                        seconds=min(args.seconds, 3.0), threads=16, log=log,
                    )
            finally:
                front.stop(drain=True, timeout=60.0)
            p50, p99 = _lat_stats(lat)
            rec = {"replicas": n_rep, "req_per_sec": round(qps, 1),
                   "p50_ms": p50, "p99_ms": p99, "window": window,
                   "retraces": agg["health.retrace"],
                   "batches": agg["serve.batches"]}
            scaling.append(rec)
            log.info("fleet scaling: %d replica(s) %.0f req/s p99=%.1fms "
                     "retraces=%.0f", n_rep, qps, p99, agg["health.retrace"])

        headline = scaling[-1]

        # hot-cache scenario: the prediction cache armed, the same request
        # pool re-visited
        front = _boot_front(conf_path, args.replicas, args.slo_ms,
                            args.hot_cache_rows, 0,
                            front_queue=args.window * args.replicas * 4,
                            device=dev)
        try:
            window = args.window * args.replicas
            drive_front(front, frags, 1.0, window)
            qps, lat = drive_front(front, frags, args.seconds, window)
            agg, _per = _fleet_counters(front)
        finally:
            front.stop(drain=True, timeout=60.0)
        p50, p99 = _lat_stats(lat)
        hits, misses = agg["serve.cache.hit"], agg["serve.cache.miss"]
        hot = {"replicas": args.replicas, "req_per_sec": round(qps, 1),
               "p50_ms": p50, "p99_ms": p99,
               "cache_rows": args.hot_cache_rows,
               "hit_rate": round(hits / max(hits + misses, 1.0), 4),
               "evictions": agg["serve.cache.evict"],
               "retraces": agg["health.retrace"]}
        log.info("fleet hot-cache: %.0f req/s p99=%.1fms hit_rate=%.2f",
                 qps, p99, hot["hit_rate"])

        mixed = fleet_mixed(conf_path, tmp_dir, args.replicas, args.slo_ms,
                            frags, args.mixed_seconds, log, device=dev)
        log.info("fleet mixed: %s", mixed)

    min_x = float(os.environ.get("SERVE_FLEET_MIN_X", "2.5"))
    x = round(headline["req_per_sec"] / single, 2) if single else None
    floors = [
        floor("SERVE_FLEET_MIN_X", x, min_x,
              x is not None and headline["req_per_sec"] >= min_x * single),
        floor("slo_ms", headline["p99_ms"], args.slo_ms,
              headline["p99_ms"] <= args.slo_ms),
    ]
    out = {
        "schema_version": 2,
        "schema": "serve_fleet",
        "metric": f"serve_fleet_req_per_sec_{source}_gbdt",
        "value": headline["req_per_sec"],
        "unit": "req/s",
        "replicas": args.replicas,
        "slo_ms": args.slo_ms,
        "p50_ms": headline["p50_ms"],
        "p99_ms": headline["p99_ms"],
        "retraces_fleet": headline["retraces"],
        "scaling": scaling,
        "hot_cache": hot,
        "mixed_traffic": mixed,
        # the single-process default rung of this invocation, not a
        # checked-in record of another machine
        "baseline": {"measured": "this run", "rung": "default",
                     "req_per_sec": single, "p50_ms": base_rec["p50_ms"],
                     "p99_ms": base_rec["p99_ms"]},
        "speedup_vs_r9_single": None,
        "speedup_vs_single": x,
        "front_http": front_http,
        "data_source": source,
        "trees": trees,
    }
    stamp(out, dev, card, floors)
    print(json.dumps(out), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)

    fails = []
    if single and headline["req_per_sec"] < min_x * single:
        fails.append(
            f"fleet headline {headline['req_per_sec']:.0f} req/s < "
            f"{min_x}x the single-process default rung ({single:.0f})"
        )
    if headline["p99_ms"] > args.slo_ms:
        fails.append(
            f"fleet p99 {headline['p99_ms']:.1f} ms > SLO {args.slo_ms} ms"
        )
    for rec in scaling:
        if rec["retraces"] > 0:
            fails.append(
                f"{rec['retraces']:.0f} steady-state retrace(s) at "
                f"{rec['replicas']} replica(s)"
            )
    if mixed["failures"] > 0:
        fails.append(
            f"mixed-traffic run had {mixed['failures']} failed request(s): "
            f"{mixed['failure_samples']}"
        )
    if mixed["shed_429"] < 1:
        fails.append("mixed-traffic burst shed nothing (queue bound inert)")
    if mixed["versions_seen"] != [1, 2]:
        fails.append(
            f"mixed-traffic versions_seen {mixed['versions_seen']} != [1, 2] "
            "(hot reload did not land mid-load)"
        )
    if mixed["retraces_fleet"] > 0:
        fails.append(
            f"mixed-traffic run retraced {mixed['retraces_fleet']:.0f}x "
            "(reload warmup leaked into steady state)"
        )
    for msg in fails:
        log.error("FAIL: %s", msg)
    return 1 if fails else 0


def rungs_fleet(tmp_dir, pred, gen_rows, args, source, log,
                device="cuda") -> dict:
    """N-replica fleet whose workers inherit the binned rung
    (YTK_SERVE_BINNED in their environment), driven like the scaling
    matrix, plus the front's raw-splice HTTP ingress line."""
    from ytklearn_tpu_torch.serve.fleet import http_json

    trees = len(pred.model.trees)
    conf_path = _write_serve_conf(tmp_dir, trees)
    rng = np.random.RandomState(17)
    rows = gen_rows(rng, args.requests)
    frags = [json.dumps(r) for r in rows]
    n_rep = args.rungs_fleet
    # the replicas' counters are the run's evidence (retraces, batches)
    _obs_on()
    # an env write, so the spawned workers inherit the rung; each reads it
    # back through config/knobs.py
    os.environ["YTK_SERVE_BINNED"] = "1"
    try:
        front = _boot_front(conf_path, n_rep, args.slo_ms, 0, 0,
                            front_queue=args.window * n_rep * 4,
                            device=device)
        try:
            window = args.window * n_rep
            drive_front(front, frags, 1.0, window)  # settle AIMD first
            qps, lat = drive_front(front, frags, args.seconds, window)
            agg, _per = _fleet_counters(front)
            rung_by_replica = {}
            for rid, h in sorted(front.handles.items()):
                try:
                    status, m = http_json("GET", h.port, "/metrics",
                                          timeout=15.0)
                except OSError:
                    continue
                models = m.get("models") or {}
                for info in models.values():
                    rung_by_replica[str(rid)] = info.get("rung")
                    break
            front_http = bench_front_http(
                front, frags, rows_per_body=64,
                seconds=min(args.seconds, 3.0), threads=16, log=log,
            )
        finally:
            front.stop(drain=True, timeout=60.0)
    finally:
        os.environ.pop("YTK_SERVE_BINNED", None)
    p50, p99 = _lat_stats(lat)
    rec = {
        "metric": f"serve_fleet_req_per_sec_{source}_gbdt",
        "replicas": n_rep,
        "rung": "binned",
        "fused": False,
        "binned": True,
        "precision": "f64",
        "req_per_sec": round(qps, 1),
        "p50_ms": p50,
        "p99_ms": p99,
        "retraces_fleet": agg["health.retrace"],
        "batches_fleet": agg["serve.batches"],
        "rung_by_replica": rung_by_replica,
        "front_http": front_http,
    }
    log.info("rungs-fleet (%d replicas, binned): %.0f req/s p99=%.1fms",
             n_rep, qps, p99)
    return rec


def rungs_main(args, log) -> int:
    """The single-process rung matrix (schema serve_rungs)."""
    import tempfile

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import health

    dev, card = resolve(args.device)
    if knobs.get_raw("YTK_OBS") != "0":
        obs.configure(enabled=True)
        health.install_trace_counters()

    with tempfile.TemporaryDirectory() as tmp_dir:
        pred, _names, gen_rows, source = _build_model(tmp_dir, dev)
        rng = np.random.RandomState(7)
        rows = gen_rows(rng, args.requests)
        x64 = True  # the port scores GBDT in f64 on every rung
        log.info("model=%s trees=%d device=%s", source,
                 len(pred.model.trees), dev)

        baseline_qps = bench_baseline(pred, rows, args.seconds)
        log.info("baseline score() loop: %.0f req/s", baseline_qps)

        # every rung measured in the same run, under the same load loop
        rungs = []
        default_rec = default_scores = None
        quality = None
        for mode in ("default", "fused", "binned"):
            rec, scorer, got = measure_rung(
                pred, rows, gen_rows, rng, mode, args.seconds, log,
                device=dev,
            )
            if mode == "default":
                default_rec, default_scores = rec, got
            rec["speedup_vs_default"] = (
                round(rec["req_per_sec"] / default_rec["req_per_sec"], 2)
                if default_rec["req_per_sec"] > 0 else None
            )
            if mode == "binned" and not rec["downgraded"]:
                quality = binned_quality(
                    pred, scorer, rows, default_scores, log
                )
            rungs.append(rec)
        ladder = list(scorer.ladder)
        del scorer

        bands = measure_bf16_bands(tmp_dir, log, device=dev)
        tracing = measure_tracing_overhead(
            tmp_dir, len(pred.model.trees), rows, args.seconds, log,
            device=dev,
        )
        quality_overhead = measure_quality_overhead(
            tmp_dir, pred, len(pred.model.trees), rows, args.seconds, log,
            device=dev,
        )
        transform_overhead = measure_transform_overhead(
            tmp_dir, min(args.requests, 1024), args.seconds, log,
            device=dev,
        )

        best = max(
            (r for r in rungs if r["rung"] != "default"),
            key=lambda r: r["req_per_sec"],
        )
        speedup = (
            default_rec["req_per_sec"] / baseline_qps
            if baseline_qps > 0 else 0.0
        )

        fleet_rec = None
        if args.rungs_fleet > 0:
            fleet_rec = rungs_fleet(tmp_dir, pred, gen_rows, args, source,
                                    log, device=dev)

        min_speedup = float(os.environ.get("SERVE_BENCH_MIN_SPEEDUP", "10"))
        min_rung_x = float(os.environ.get("SERVE_RUNG_MIN_X", "1.5"))
        binned_band = float(os.environ.get("SERVE_BINNED_BAND", "1e-9"))
        bf16_band = float(os.environ.get("SERVE_BF16_BAND", "0.1"))
        tol = float(os.environ.get("BENCH_REGRESS_TOL", "0.15"))
        p99_x = (round(best["p99_ms"] / default_rec["p99_ms"], 4)
                 if default_rec["p99_ms"] > 0 else None)
        floors = [
            floor("SERVE_BENCH_MIN_SPEEDUP", round(speedup, 2), min_speedup,
                  speedup >= min_speedup),
            floor("SERVE_RUNG_MIN_X", best["speedup_vs_default"], min_rung_x,
                  best["speedup_vs_default"] is not None
                  and best["speedup_vs_default"] >= min_rung_x),
            floor("best_rung_p99_over_default", p99_x, 1.05,
                  best["p99_ms"] <= default_rec["p99_ms"] * 1.05),
            floor("BENCH_REGRESS_TOL tracing", tracing.get("sampled_over_off"),
                  round(1.0 - tol, 4),
                  (tracing.get("sampled_req_per_sec") or 0.0)
                  >= (tracing.get("off_req_per_sec") or 0.0) * (1.0 - tol)),
            floor("BENCH_REGRESS_TOL quality",
                  quality_overhead.get("sampled_over_off"),
                  round(1.0 - tol, 4),
                  (quality_overhead.get("sampled_req_per_sec") or 0.0)
                  >= (quality_overhead.get("off_req_per_sec") or 0.0)
                  * (1.0 - tol)),
        ]
        snap = obs.snapshot()
        out = {
            "schema_version": 3,
            "schema": "serve_rungs",
            "metric": f"serve_req_per_sec_{source}_gbdt",
            # the headline stays the default rung
            "value": default_rec["req_per_sec"],
            "unit": "req/s",
            "baseline_req_per_sec": round(baseline_qps, 1),
            "speedup_vs_score_loop": round(speedup, 2),
            "p50_ms": default_rec["p50_ms"],
            "p99_ms": default_rec["p99_ms"],
            "bit_identical": default_rec["bit_identical"],
            "x64": x64,
            "retraces_after_warmup": default_rec["retraces_after_warmup"],
            "ladder": ladder,
            "rungs": rungs,
            "best_rung": best["rung"],
            "best_rung_speedup": best["speedup_vs_default"],
            "binned_quality": quality,
            "precision_bands": bands,
            "tracing_overhead": tracing,
            "quality_overhead": quality_overhead,
            "transform_overhead": transform_overhead,
            "data_source": source,
            "trees": len(pred.model.trees),
            # throughput compares only on the same hardware
            "cpu_count": os.cpu_count(),
            "obs": {
                "counters": {k: round(v, 3)
                             for k, v in sorted(snap["counters"].items())
                             if k.startswith(("serve.", "compile.",
                                              "health."))},
            },
        }
        if fleet_rec is not None:
            out["fleet"] = fleet_rec
        stamp(out, dev, card, floors)
        print(json.dumps(out), flush=True)
        if args.record:
            with open(args.record, "w") as f:
                json.dump(out, f, indent=1)

        fails = []
        if speedup < min_speedup:
            fails.append(f"speedup {speedup:.2f}x < {min_speedup}x")
        if x64 and not default_rec["bit_identical"]:
            fails.append("serve scores not bit-identical to batch_scores")
        for rec in rungs:
            if rec["retraces_after_warmup"] > 0:
                fails.append(
                    f"{rec['retraces_after_warmup']} steady-state "
                    f"retrace(s) on the {rec['rung']} rung"
                )
            if dev.type == "cuda" and rec["downgraded"]:
                # on a CUDA tensor a kernel rung launches or raises
                fails.append(f"the {rec['rung']} rung served downgraded "
                             f"({rec['backend']}) on {dev}")
        if best["speedup_vs_default"] is None or (
            best["speedup_vs_default"] < min_rung_x
        ):
            fails.append(
                f"best rung ({best['rung']}) speedup "
                f"{best['speedup_vs_default']}x < {min_rung_x}x the default "
                "rung (env SERVE_RUNG_MIN_X)"
            )
        elif best["p99_ms"] > default_rec["p99_ms"] * 1.05:
            fails.append(
                f"best rung p99 {best['p99_ms']}ms worse than default "
                f"{default_rec['p99_ms']}ms"
            )
        if quality is not None and quality["max_abs_pred_diff"] > binned_band:
            fails.append(
                f"binned quality band {quality['max_abs_pred_diff']:.3g} > "
                f"{binned_band:.3g} on the request stream "
                "(env SERVE_BINNED_BAND)"
            )
        for family, band in bands.items():
            if band > bf16_band:
                fails.append(
                    f"bf16 band {band:.3g} > {bf16_band:.3g} for {family} "
                    "(env SERVE_BF16_BAND)"
                )
        # sampled tracing (the production default) must cost less than the
        # regress band against tracing off
        t_off = tracing.get("off_req_per_sec") or 0.0
        t_sam = tracing.get("sampled_req_per_sec") or 0.0
        if t_off > 0 and t_sam < t_off * (1.0 - tol):
            fails.append(
                f"sampled tracing overhead: {t_sam:.0f} req/s < "
                f"{t_off:.0f} * (1 - {tol}) with 1% head sampling "
                "(env BENCH_REGRESS_TOL)"
            )
        q_off = quality_overhead.get("off_req_per_sec") or 0.0
        q_sam = quality_overhead.get("sampled_req_per_sec") or 0.0
        if q_off > 0 and q_sam < q_off * (1.0 - tol):
            fails.append(
                f"quality-sampler overhead: {q_sam:.0f} req/s < "
                f"{q_off:.0f} * (1 - {tol}) at the default "
                "YTK_QUALITY_SAMPLE (env BENCH_REGRESS_TOL)"
            )
        if not transform_overhead.get("assembled_bit_identical", True):
            fails.append(
                "raw-dict transform path not bit-identical to "
                "pre-assembled vectors"
            )
        if transform_overhead.get("raw_retraces"):
            fails.append(
                f"{transform_overhead['raw_retraces']} steady-state "
                "retrace(s) on the raw-dict transform path"
            )
        if fleet_rec is not None and fleet_rec.get("retraces_fleet"):
            fails.append(
                f"rungs-fleet run retraced "
                f"{fleet_rec['retraces_fleet']:.0f}x"
            )
        for msg in fails:
            log.error("FAIL: %s", msg)
        return 1 if fails else 0


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--seconds", type=float,
                    default=float(os.environ.get("SERVE_BENCH_SECONDS", "2.0")))
    ap.add_argument("--requests", type=int, default=2048,
                    help="distinct request rows cycled through")
    ap.add_argument("--record", default="",
                    help="also write the JSON record to this path")
    ap.add_argument("--fleet", action="store_true",
                    help="run the fleet scenario matrix instead of the "
                    "single-process bench (schema serve_fleet)")
    ap.add_argument("--ramp", action="store_true",
                    help="run the autoscaler ramp: rising -> falling "
                    "offered load against a 1-replica fleet with "
                    "--replicas as the autoscaling ceiling (schema "
                    "serve_scale)")
    ap.add_argument("--ramp-grow-timeout", type=float, default=300.0,
                    help="max seconds to wait for the fleet to reach the "
                    "ceiling under the rising load")
    ap.add_argument("--ramp-shrink-timeout", type=float, default=180.0,
                    help="max seconds to wait for the fleet to drain back "
                    "to the floor after the load falls")
    ap.add_argument("--rungs-fleet", type=int, default=0,
                    help="after the rung matrix, boot an N-replica fleet "
                    "inheriting the binned rung and embed its run (plus "
                    "the front raw-splice HTTP overhead line)")
    ap.add_argument("--replicas", type=int, default=4,
                    help="fleet size for the scaling matrix (1..N)")
    ap.add_argument("--slo-ms", type=float, default=100.0,
                    help="p99 SLO the AIMD controller targets and the "
                    "check enforces")
    ap.add_argument("--window", type=int, default=512,
                    help="in-flight request window per replica")
    ap.add_argument("--mixed-seconds", type=float, default=12.0,
                    help="mixed-traffic (reload + shed) scenario duration")
    ap.add_argument("--hot-cache-rows", type=int, default=65536,
                    help="prediction-cache rows for the hot-cache scenario")
    ap.add_argument("--device", default="cuda",
                    help="device of the scorers and of every replica: cuda "
                    "(the default; raises without a GPU) or cpu, where the "
                    "plain versions and the native binned walk run")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    log = logging.getLogger("serve_bench")
    if args.ramp:
        return ramp_main(args, log)
    if args.fleet:
        return fleet_main(args, log)
    return rungs_main(args, log)


if __name__ == "__main__":
    raise SystemExit(main())
