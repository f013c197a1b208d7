#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ytklearn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's GBDT online-serving path on the card, as a user would:

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions, `nvcc --version` and whether ninja is on PATH;
  2. builds the heap-walk kernel from ytklearn_tpu_torch/serve/csrc/ with
     nvcc and prints the build time and ptxas' report;
  3. holds the kernel against its plain PyTorch version and against the
     stacked rung, all on the card, with torch.equal (tolerance: exact) at
     (trees, depth, rows) = (13, 1, 1), (64, 10, 512), (500, 6, 1) and
     (500, 6, 512), on rows with NaN, +-inf and values exactly at splits;
  4. writes a seeded 500-tree, depth-6, 28-feature sigmoid model and its
     config, serves it through ModelRegistry + ServeApp on cuda with
     YTK_SERVE_FUSED=1, POSTs 1, 7, 64, 512 and 600 rows plus a burst of 16
     concurrent one-row requests, and holds every score bit-equal to the
     host GBDTPredictor.batch_scores (predictions within rtol 1e-14 of its
     sigmoid); the kernel's launch count is zeroed just before these
     requests and read just after;
  5. times the one-row HTTP p50 latency, then traces 50 more one-row
     requests with torch.profiler for the device's idle share, and, per
     ladder rung, holds the kernel against its plain version (torch.equal)
     and times the kernel (CUDA events, median of repeats), its plain
     version and the stacked rung beside the kernel's bound;
  6. prints the `kernels` JSON line, the card line, and last the result
     line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the result line;
without a CUDA device it exits 2 before importing the port.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

SEED = 20261016
N_FEATURES = 28  # the Higgs width (experiment/higgs/local_gbdt.conf)
N_TREES = 500  # scripts/serve_bench.py's GBDT serving width
DEPTH = 6
LADDER = (1, 8, 64, 512)  # the default serving ladder
KERNEL_SHAPES = ((13, 1, 1), (64, 10, 512), (500, 6, 1), (500, 6, 512))
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: FP64 rate outside the tensor cores that the walk's compares and adds use
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def sh(cmd):
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    return (out.stdout + out.stderr).strip()


# -- model and rows -----------------------------------------------------------


def random_model(rng, n_trees, depth, names, base):
    """GBDTModel of `n_trees` trees of max depth exactly `depth` (the left
    spine runs the whole way; other branches stop early at random), as
    parsed back from its dump."""
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel, Tree

    def tree():
        t = Tree()

        def grow(nid, d, spine):
            if d >= depth or (not spine and rng.rand() < 0.2):
                t.leaf_value[nid] = float(rng.randn() * 0.1)
                return
            t.feat[nid] = 0
            t.feat_name[nid] = names[rng.randint(len(names))]
            t.split[nid] = float(rng.randn())
            t.default_left[nid] = bool(rng.rand() < 0.5)
            left, right = t.add_children(nid)
            grow(left, d + 1, spine)
            grow(right, d + 1, False)

        grow(0, 0, True)
        return t

    model = GBDTModel(base_prediction=base, num_tree_in_group=1,
                      obj_name="sigmoid",
                      trees=[tree() for _ in range(n_trees)])
    # round-trip through the text format, whose values are f32 renderings:
    # the served model is the parsed one
    return GBDTModel.loads(model.dumps())


def random_rows(rng, n, names, splits):
    """Feature dicts with gaps (missing -> NaN), +-inf, values exactly at
    split thresholds, and the odd unknown feature."""
    rows = []
    for _ in range(n):
        row = {}
        for nm in names:
            r = rng.rand()
            if r < 0.15:
                continue
            if r < 0.18:
                row[nm] = float("inf")
            elif r < 0.21:
                row[nm] = float("-inf")
            elif r < 0.35:
                row[nm] = float(splits[rng.randint(len(splits))])
            else:
                row[nm] = float(rng.randn())
        if rng.rand() < 0.1:
            row["unknown_feature"] = 1.0
        rows.append(row)
    return rows


def write_model(tmp, model, name):
    path = os.path.join(tmp, f"{name}.model")
    with open(path, "w") as f:
        f.write(model.dumps())
    conf = os.path.join(tmp, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(f'model {{ data_path = "{path}" }}\n'
                "optimization { loss_function = sigmoid, round_num = 1000 }\n")
    return conf


def split_values(model):
    return [t.split[i] for t in model.trees for i in range(t.n_nodes())
            if not t.is_leaf(i)]


# -- timing -------------------------------------------------------------------


def cuda_ms(fn, iters, repeats=7):
    """Median over `repeats` of the mean per-call time of `iters` calls,
    from CUDA events around the run."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(iters):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / iters)
    return statistics.median(times)


def walk_bound_ms(X, ht):
    """Least time for one walk of these rows, the larger of: the bytes the
    walk must move over HBM bandwidth, and its compares and adds over the
    FP64 rate. The bytes are what this run's data needs, each read once:
    the X elements some row looks up, each heap slot's feat id where some
    row visits it, its split where a visiting row has a value, its dleft
    where a visiting row has NaN, each leaf some row reaches; the scores
    are written once. The visited sets come from replaying the walk on the
    same inputs (the last heap level is read only as leaves)."""
    import torch

    B, F = X.shape
    T, H = ht.feat.shape
    LL = ht.leaf.shape[1]
    rows = torch.arange(B, device=X.device)[:, None]
    tids = torch.arange(T, device=X.device)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=X.device)
    slots, split_at, dleft_at, cells = [], [], [], []
    for _ in range(ht.depth):
        f = ht.feat[tids, pos].long()
        v = X[rows, f]
        nan = torch.isnan(v)
        slot = tids * H + pos
        slots.append(slot.flatten())
        split_at.append(slot[~nan])
        dleft_at.append(slot[nan])
        cells.append((rows * F + f).flatten())
        go_left = torch.where(nan, ht.dleft[tids, pos] > 0,
                              v <= ht.split[tids, pos])
        pos = 2 * pos + 2 - go_left.long()

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel())

    nbytes = (distinct(cells) * 8 + distinct(slots) * 4
              + distinct(split_at) * 8 + distinct(dleft_at) * 4
              + distinct([(tids * LL + pos - (LL - 1)).flatten()]) * 8
              + B * 8)
    ops = B * T * (ht.depth + 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- HTTP ---------------------------------------------------------------------


def post(port, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/predict", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as resp:
        check(resp.status == 200, f"/predict answered {resp.status}")
        return json.loads(resp.read())


def profile_requests(port, rows, card):
    """A separate traced run of one-row requests: device busy time (CUDA
    kernels and copies, from torch.profiler) against the client's wall
    time gives the device's idle share while serving."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for row in rows:
            post(port, {"features": row})
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    check(busy_ms > 0, "the profiler saw no device time")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:4]
    print(f"profile: {len(rows)} one-row requests (traced), wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; top device ops: "
          + ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f} ms"
                      f" x{e.count}" for e in top)
          + f" [{card}]", flush=True)


# -- phases -------------------------------------------------------------------


def phase_kernel(tmp, card):
    """K6 against its plain version and the stacked rung on the card."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import CompiledScorer, kernels

    names = [f"f{i}" for i in range(N_FEATURES)]
    max_err = 0.0
    for T, depth, B in KERNEL_SHAPES:
        rng = np.random.RandomState(SEED + T * 16 + depth)
        model = random_model(rng, T, depth, names, base=0.0)
        conf = write_model(tmp, model, f"k{T}_{depth}")
        pred = create_predictor("gbdt", conf)
        fused = CompiledScorer(pred, ladder=(B,), mode="fused",
                               device="cuda", warmup=False)
        stacked = CompiledScorer(pred, ladder=(B,), mode="stacked",
                                 device="cuda", warmup=False)
        check(fused.rung_info()["backend"] == "fused-cuda",
              f"fused rung not on the kernel: {fused.rung_info()}")
        rows = random_rows(rng, B, names, split_values(model))
        X = torch.from_numpy(fused.featurize(rows)).cuda()
        heap, why = kernels.build_heap(model.trees, fused.vocab)
        check(heap is not None, why)
        ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                     heap.leaf, heap.depth, heap.n_trees,
                                     "cuda")
        args = (X, ht.feat, ht.split, ht.dleft, ht.leaf, ht.depth)
        k = kernels.heap_walk(*args, max_feat=ht.max_feat)
        torch.cuda.synchronize()
        p = kernels.heap_walk_plain(*args)
        s_stacked, _ = stacked.score_tensor(X)
        s_fused, _ = fused.score_tensor(X)
        torch.cuda.synchronize()
        err = float((k - p).abs().max()) if B else 0.0
        max_err = max(max_err, err)
        ok = (torch.equal(k, p) and torch.equal(k + 0.0, s_stacked)
              and torch.equal(s_fused, s_stacked))
        print(f"kernel check T={T} (padded {heap.feat.shape[0]}) "
              f"depth={depth} B={B}, tolerance exact (torch.equal): "
              f"kernel==plain {torch.equal(k, p)}, "
              f"kernel==stacked {torch.equal(k + 0.0, s_stacked)}, "
              f"fused rung==stacked rung {torch.equal(s_fused, s_stacked)}, "
              f"max_abs_err {err} [{card}]", flush=True)
        check(ok, f"heap walk disagrees at T={T} depth={depth} B={B}")
    return max_err


def phase_slice(tmp, card):
    """The served 500-tree model on the fused CUDA rung, end to end."""
    import numpy as np

    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        ModelRegistry,
        ServeApp,
        kernels,
    )

    names = [f"f{i}" for i in range(N_FEATURES)]
    rng = np.random.RandomState(SEED)
    model = random_model(rng, N_TREES, DEPTH, names, base=0.1234)
    conf = write_model(tmp, model, "slice")
    os.environ["YTK_SERVE_FUSED"] = "1"
    t0 = time.perf_counter()
    registry = ModelRegistry(device="cuda")  # default ladder 1/8/64/512
    entry = registry.load("default", "gbdt", hocon.load(conf))
    load_s = time.perf_counter() - t0
    info = entry.scorer.rung_info()
    print(f"slice: loaded {N_TREES} trees depth {DEPTH} x {N_FEATURES} "
          f"features in {load_s:.3f} s, rung {json.dumps(info)}", flush=True)
    check(info["mode"] == "fused" and info["backend"] == "fused-cuda",
          f"not serving on the fused CUDA rung: {info}")
    check(entry.scorer.ladder == LADDER, f"ladder {entry.scorer.ladder}")
    app = ServeApp(registry, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0).start()
    host_pred = entry.predictor
    splits = split_values(model)
    n_checked = 0
    try:
        kernels.heap_walk.launches = 0  # count the main path's launches only
        for n in (1, 7, 64, 512, 600):
            rows = random_rows(rng, n, names, splits)
            out = post(app.port, {"rows": rows})
            want = host_pred.batch_scores(rows)
            check(np.array_equal(np.asarray(out["scores"]), want),
                  f"{n}-row response differs from the host tree walk")
            preds = np.asarray(out["predictions"])
            check(preds.shape == (n,) and np.all(np.isfinite(preds))
                  and np.allclose(preds, host_pred.batch_predicts(rows),
                                  rtol=1e-14, atol=0),
                  f"{n}-row predictions are off the host sigmoid "
                  "(rtol 1e-14)")
            n_checked += n
        burst = random_rows(rng, 16, names, splits)
        results = [None] * len(burst)

        def one(i):
            results[i] = post(app.port, {"features": burst[i]})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(burst))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            check(not t.is_alive(), "burst request hung")
        want = host_pred.batch_scores(burst)
        for i, out in enumerate(results):
            check(out is not None and out["scores"] == [want[i]],
                  f"burst request {i} differs from the host tree walk")
        n_checked += len(burst)
        launches = kernels.heap_walk.launches
        print(f"slice: {n_checked} rows in 21 requests, every score "
              f"bit-equal to the host GBDTPredictor.batch_scores; heap_walk "
              f"launches {launches} [{card}]", flush=True)
        check(launches > 0, "the main path launched no heap_walk kernel")

        lat = []
        one_row = random_rows(rng, 200, names, splits)
        for row in one_row:
            t0 = time.perf_counter()
            post(app.port, {"features": row})
            lat.append((time.perf_counter() - t0) * 1e3)
        p50 = statistics.median(lat)
        print(f"timing: HTTP /predict one-row p50 {p50:.4f} ms over "
              f"{len(lat)} sequential requests (client clock) [{card}]",
              flush=True)
        profile_requests(app.port, random_rows(rng, 50, names, splits), card)
    finally:
        app.stop(drain=True, timeout=30.0)
    return launches, model, p50


def phase_timings(model, card):
    """Per rung: kernel, plain walk and stacked rung on the card."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import CompiledScorer, kernels

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_t_")
    try:
        conf = write_model(tmp, model, "timing")
        pred = create_predictor("gbdt", conf)
        fused = CompiledScorer(pred, ladder=LADDER, mode="fused",
                               device="cuda", warmup=False)
        stacked = CompiledScorer(pred, ladder=LADDER, mode="stacked",
                                 device="cuda", warmup=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    heap, _ = kernels.build_heap(model.trees, fused.vocab)
    ht = kernels.heap_from_numpy(heap.feat, heap.split, heap.dleft,
                                 heap.leaf, heap.depth, heap.n_trees, "cuda")
    names = sorted(fused.vocab)
    rng = np.random.RandomState(SEED + 1)
    out = {}
    max_err = 0.0
    for B in LADDER:
        rows = random_rows(rng, B, names, split_values(model))
        X = torch.from_numpy(fused.featurize(rows)).cuda()
        args = (X, ht.feat, ht.split, ht.dleft, ht.leaf, ht.depth)
        k = kernels.heap_walk(*args, max_feat=ht.max_feat)
        p = kernels.heap_walk_plain(*args)
        torch.cuda.synchronize()
        err = float((k - p).abs().max())
        max_err = max(max_err, err)
        print(f"kernel check rung {B}, tolerance exact (torch.equal): "
              f"kernel==plain {torch.equal(k, p)}, max_abs_err {err} "
              f"[{card}]", flush=True)
        check(torch.equal(k, p), f"heap walk disagrees at rung {B}")
        ms = cuda_ms(lambda: kernels.heap_walk(*args, max_feat=ht.max_feat),
                     iters=50)
        plain_ms = cuda_ms(lambda: kernels.heap_walk_plain(*args), iters=3,
                           repeats=5)
        stacked_ms = cuda_ms(lambda: stacked.score_tensor(X), iters=3,
                             repeats=5)
        fused_ms = cuda_ms(lambda: fused.score_tensor(X), iters=20)
        bound_ms, bound_by = walk_bound_ms(X, ht)
        out[B] = (ms, plain_ms, bound_ms, bound_by)
        print(f"timing: rung {B} ({ht.feat.shape[0]} padded trees, depth "
              f"{ht.depth}): heap_walk kernel {ms:.6f} ms, plain walk "
              f"{plain_ms:.6f} ms, stacked rung {stacked_ms:.6f} ms, fused "
              f"rung with sigmoid {fused_ms:.6f} ms, bound {bound_ms:.6f} ms "
              f"({bound_by}) [{card}]", flush=True)
    return out, max_err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    card = sh(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0].strip()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}", flush=True)
    from ytklearn_tpu_torch.serve import kernels

    print(sh([kernels.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
    print(f"ninja: {shutil.which('ninja') or 'not found'} (not used: the "
          "kernel is built by nvcc into a ctypes library)", flush=True)

    build = kernels.build_kernel()
    print(f"build: heap_walk.cu in {build['seconds']:.3f} s: {build['cmd']}",
          flush=True)
    print(build["log"].strip(), flush=True)

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_")
    try:
        max_err = phase_kernel(tmp, card)
        launches, model, _p50 = phase_slice(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    times, timing_err = phase_timings(model, card)
    max_err = max(max_err, timing_err)
    ms, plain_ms, bound_ms, bound_by = times[LADDER[-1]]
    print(json.dumps({"kernels": [{
        "name": "heap_walk",
        "route": "cuda",
        "source": "ytklearn_tpu_torch/serve/csrc/heap_walk.cu",
        "replaces": "ytklearn_tpu/serve/kernels.py:341",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
