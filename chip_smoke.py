#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (ytklearn_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's paths on the card, as a user would: GBDT online serving
on the fused rung (slice 1), int8 GBDT training (slice 2), `cli train`
with the bf16 histograms and the binned serving rung (slice 3), the
histogram tuning tools with K8, the int8 one-hot histogram (slice 4), the
redesigned bf16/f32 histograms K1 and K3 of `cli train` (slice 5), the
redesigned int8 histograms K2 and K4 of int8 training (slice 6), and K8
redesigned on warpgroup tensor cores and K5, wave routing, redesigned
(slice 7).

  1. prints the card (nvidia-smi name and power limit), the torch and CUDA
     versions, `nvcc --version` and whether ninja is on PATH;
  2. builds the five kernel libraries (serve/csrc/heap_walk.cu: K6, K7;
     gbdt/csrc/hist.cu: K2, K4; gbdt/csrc/hist_float.cu: K1, K3;
     gbdt/csrc/route.cu: K5; gbdt/csrc/hist_u8.cu: K8) from the checkout,
     one nvcc each, all started together, and prints each build's time and
     ptxas' report;
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
  6. holds the training kernels K2 (hist_q), K4 (hist_gather_q) and K5
     (route) against their plain PyTorch versions with torch.equal
     (tolerance: exact, the sums are int32) at the shapes listed in
     HIST_SHAPES and GATHER_SHAPES; K1 (hist) and K3 (hist_gather) at bf16
     and f32 at the same shapes (counts exact, g/h within rtol 1e-5 plus
     1e-5 of the largest |sum|: float atomics add in any order); each also
     on a 64-slot wave with a duplicated id and pads, whose two slots must
     get the same sums (K2/K4 exact, K1/K3 at that tolerance); K7
     (binned_walk) with torch.equal on uint8 and uint16 tables at every
     rung of the 500-tree model; then (slice 7) K5 on duplicated valid
     ids (the later slot wins), a duplicated id whose later slot is
     invalid, node ids above 57,344, ids spread past the direct map (the
     sorted lookup, int64 fields), a misaligned pos[1:] with out separate
     and aliased, and int32 bins, each with torch.equal;
  7. trains a seeded Higgs-shaped synthetic (the torch twin of bench.py's
     _gen_gbdt) at full width with bench.py's GBDT configuration on cuda
     (TRAIN_ROWS rows, TRAIN_ROUNDS rounds, hist_precision="int8"), counts
     the kernels' launches over that run only, asserts the train loss
     falls below 0.65 and the test AUC and logloss to the digit
     (INT8_TEST_METRICS), and prints steady trees/s, launches and host
     syncs per tree; then traces two rounds of a second
     run with torch.profiler for the device's idle share;
  8. trains one small l2 configuration on cuda and on the CPU and requires
     the trees' integer fields to be equal;
  9. times each training kernel at the full-width shapes (CUDA events,
     median of repeats) beside its bound, its plain version and one
     scatter_add_ call; then the int8 width phase of slice 6: K2 over every
     bench row and K4 at its first fused rung (R = n/64) on waves of N = 1,
     2, 8, 16, 32, 42 and 64 slots, each held against its plain version
     with torch.equal and then timed beside one int32 scatter_add_ and its
     bound, with the plan q_plan took; and the saturating cases: every
     bench row in one node and bin at gq = -127, then +127, and hq = 127,
     K2 at the root wave and a 64-slot wave (q_plan's plan, one chunk,
     red) and K4 over every row gathered, each equal to the known sums;
 10. writes 2^20 + 2^17 Higgs-shaped text lines and runs
     `python -m ytklearn_tpu_torch.cli train gbdt experiment/higgs/
     local_gbdt.conf` with --set overrides (paths, 20 rounds, max_depth 8;
     full width: 28 features, 255 bins and leaves, bf16) in this process,
     and requires 20 trees, the model and its sidecar, and launches of K1,
     K3 and K5 only;
 11. serves that model on the binned rung (YTK_SERVE_BINNED=1, edges from
     its sidecar): 200 one-row requests and one of 512 rows, every score
     bit-equal to the port's CPU binned scorer, with K7's launches counted;
     then, without the sidecar, thresholds mode bit-equal to the host tree
     walk; times K7 at rung 512;
 12. trains the bench configuration of step 7 in bf16 (K1, K3, K5),
     prints its trees/s beside the figure PERF.md records for the kernels
     before their redesign, and times K1 and K3 at its shapes; then, the
     width phase of slice 5, K1 over every bench row and K3 at the first
     fused rung (R = n/64) on waves of N = 1, 2, 8, 16, 32, 42 and 64
     slots, each held against its plain version (counts exact, g/h at
     HIST_RTOL) and then timed beside one scatter_add_ and its bound;
     then a small l2 bf16 run twice on the card and once on the CPU,
     printing whether the card's trees repeat;
 13. holds K8 (hist_q_u8) against its plain version with torch.equal at
     N = 1, 7, 32 and 64 slots (F = 28, B = 256, a ragged n) and on waves
     of 64 and 100 slots (3N > 256: two n-tiles) with a duplicated id and
     pads, and against K2 in K8's layout;
 14. runs the tuning tools in this process, the main path of slice 4:
     tune_hist_kernel at the reference's size with its full variant list
     (K2, K1 and K8 across launch shapes, then K8 == K2 with torch.equal;
     K8's launches are counted over this run), micro_hist_gather at two
     budgets (K4 == gather-then-K2, exact) and tune_gbdt cut to waves 32
     and 64 in int8 at 2^21 rows and 6 trees;
 15. times K8 at the tune shape beside its bytes bound, its tensor-core
     floor (mma_floor_ms), its plain version and one scatter_add_, then K8
     and K2 on waves of 1 to 64 slots that hold every row;
 16. prints the `kernels` JSON line (eight kernels), the card line, and
     last the result line {"ok": true, "device": {...}}.

Any failure raises and the script exits non-zero without the result line;
without a CUDA device it exits 2 before importing the port.
"""

from __future__ import annotations

import json
import math
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


def device_busy(prof, top_k):
    """(busy ms, top device ops) of a torch.profiler trace. Busy time is
    the union of the device events' intervals (kernels, copies, sets):
    only events on the device count, since a CPU op's device time repeats
    the kernels it launched, and kernels launched through ctypes have no
    CPU op at all."""
    from torch.autograd import DeviceType

    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy_us += b - max(a, end)
            end = b
    ops = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total]
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:top_k]
    return busy_us / 1e3, top


def fmt_top(top, width):
    return ", ".join(f"{e.key[:width]} {e.self_device_time_total / 1e3:.3f} "
                     f"ms x{e.count}" for e in top)


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
    busy_ms, top = device_busy(prof, 4)
    check(busy_ms > 0, "the profiler saw no device time")
    print(f"profile: {len(rows)} one-row requests (traced), wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.4f}; top device ops: {fmt_top(top, 40)} "
          f"[{card}]", flush=True)


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
          f"features in {load_s:.3f} s, rung {json.dumps(info)} [{card}]",
          flush=True)
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


# -- training slice ------------------------------------------------------------

#: bench.py's GBDT cell at its own size: 10,500,000 train rows, 500,000
#: test rows and 40 trees on the synthetic (bench.py:306-317)
TRAIN_ROWS = 10_500_000
TEST_ROWS = 500_000
TRAIN_ROUNDS = 40
#: (F, n, B, N, bins dtype) for K2; (R, dead share) for K4; NW for K5
HIST_SHAPES = ((28, 65536, 256, 1, "u8"), (28, 65536, 256, 64, "u8"),
               (5, 49152, 16, 7, "i32"))
GATHER_SHAPES = (1024, 262144)
FP32_OPS_PER_S = 67e12  # H100 SXM CUDA-core rate (int32 adds bound below it)


def gen_higgs_like(n, n_test, F, seed):
    """Torch twin of bench.py::_gen_gbdt: a Higgs-shaped synthetic with a
    planted nonlinear signal, drawn on the card from a seeded generator."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt.data import GBDTData

    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_all = n + n_test
    X = torch.randn((n_all, F), generator=gen, device="cuda")
    logit = (1.5 * X[:, 0] * X[:, 1] + torch.sin(X[:, 2] * 2)
             + 0.8 * (X[:, 3] > 0.5) - 0.5 * X[:, 4] ** 2
             + 0.3 * X[:, 5] * X[:, 6])
    noise = torch.randn((n_all,), generator=gen, device="cuda")
    y = (logit + noise * 0.5 > 0).to(torch.float32)
    names = [f"f{i}" for i in range(F)]

    def mk(lo, hi):
        return GBDTData(X=X[lo:hi], y=y[lo:hi],
                        weight=np.ones(hi - lo, np.float32), n_real=hi - lo,
                        feature_names=names)

    return mk(0, n), mk(n, n_all)


def bench_params(rounds, data_path):
    """bench.py::bench_gbdt's configuration (bench.py:320-339)."""
    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )

    return GBDTParams(
        round_num=rounds, max_depth=60, max_leaf_cnt=255,
        tree_grow_policy="loss", learning_rate=0.1,
        min_child_hessian_sum=100.0, loss_function="sigmoid",
        eval_metric=["auc", "logloss"],
        approximate=[ApproximateSpec(type="sample_by_quantile", max_cnt=255)],
        model=ModelParams(data_path=data_path, dump_freq=0),
    )


def kernel_counts():
    from ytklearn_tpu_torch.gbdt import engine, hist, route
    from ytklearn_tpu_torch.serve import kernels

    return {"hist": hist.hist_wave.launches,
            "hist_gather": hist.hist_wave_gather_mxu.launches,
            "hist_q": hist.hist_wave_q.launches,
            "hist_gather_q": hist.hist_wave_gather.launches,
            "route": route.route_wave.launches,
            "binned_walk": kernels.binned_walk.launches,
            "hist_q_u8": hist.hist_q_u8.launches,
            "host_syncs": engine.grow.host_syncs}


def zero_kernel_counts():
    from ytklearn_tpu_torch.gbdt import engine, hist, route
    from ytklearn_tpu_torch.serve import kernels

    hist.hist_wave.launches = 0
    hist.hist_wave_gather_mxu.launches = 0
    hist.hist_wave_q.launches = 0
    hist.hist_wave_gather.launches = 0
    route.route_wave.launches = 0
    kernels.binned_walk.launches = 0
    hist.hist_q_u8.launches = 0
    engine.grow.host_syncs = 0


#: the histogram kernels each precision runs (full scan, gather)
PRECISION_KERNELS = {"int8": ("hist_q", "hist_gather_q"),
                     "bf16": ("hist", "hist_gather"),
                     "f32": ("hist", "hist_gather")}


def rand_hist_inputs(gen, F, n, B, N, dtype, M=None):
    """Bins, positions over 2N+1 nodes (a tenth dead), quantized grads at
    +-127 and N wave ids (a quarter -2 pads when N > 2), on the card."""
    import torch

    M = M or 2 * N + 1
    bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    bins = bins.to(torch.uint8) if dtype == "u8" else bins
    pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pos[torch.rand((n,), generator=gen, device="cuda") < 0.1] = -1
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    gq[:2] = torch.tensor([127.0, -127.0], device="cuda")
    ids = torch.randperm(M, generator=gen, device="cuda")[:N].to(torch.int32)
    if N > 2:
        ids[torch.rand((N,), generator=gen, device="cuda") < 0.25] = -2
    return bins, pos, gq, hq, ids, M


def compacted(pos, gq, hq, ids, R, dead_share, gen):
    """The engine's compaction of a wave's rows into R slots, with a share
    of dead slots (pos_g = -1) at the end."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import compact_indices

    member = torch.isin(pos, ids[ids >= 0])
    keep = int(R * (1 - dead_share))
    rows = torch.nonzero(member).flatten()
    rows = rows[torch.randperm(len(rows), generator=gen, device="cuda")[
        :keep]].sort().values
    mask = torch.zeros_like(member)
    mask[rows] = True
    idx, cnt = compact_indices(mask, R)
    valid = torch.arange(R, device="cuda") < cnt
    li = idx.long()
    pg = torch.where(valid, pos[li], -1).to(torch.int32)
    return idx, pg, gq[li].contiguous(), hq[li].contiguous()


def dup_ids(ids):
    """The wave's ids with slot 1's id (made a real one) repeated in the
    last slot and slot 0 a pad."""
    ids[-1] = ids[1] = ids[1].clamp(min=0)
    ids[0] = -2
    return ids


def dup_wave_inputs(gen):
    """rand_hist_inputs' 64-slot wave over 2^20 rows with a duplicated id
    (slots 1 and 63) and a pad."""
    bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, 28, 1 << 20, 256, 64,
                                                 "u8")
    return bins, pos, gq, hq, dup_ids(ids), M


def phase_train_kernels(card):
    """K2, K4 and K5 against their plain versions on the card, exact."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    errs = {"hist_q": 0.0, "hist_gather_q": 0.0, "route": 0.0}

    def cmp(name, got, want, what):
        torch.cuda.synchronize()
        err = float((got.long() - want.long()).abs().max()) if got.numel() \
            else 0.0
        errs[name] = max(errs[name], err)
        ok = torch.equal(got, want)
        print(f"kernel check {name} {what}, tolerance exact (torch.equal): "
              f"{ok}, max_abs_err {err} [{card}]", flush=True)
        check(ok, f"{name} disagrees with its plain version at {what}")

    for F, n, B, N, dt in HIST_SHAPES:
        bins, pos, gq, hq, ids, M = rand_hist_inputs(gen, F, n, B, N, dt)
        got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
        want = hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M)
        cmp("hist_q", got, want, f"(F, n, B, N) = ({F}, {n}, {B}, {N}) "
            f"{dt} bins")
    bins, pos, gq, hq, ids, M = rand_hist_inputs(
        gen, 28, 1 << 20, 256, 64, "u8")
    rows = bins.t().contiguous()
    for R in GATHER_SHAPES:
        idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.25, gen)
        got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                    max_nodes=M)
        want = hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, 256, M)
        cmp("hist_gather_q", got, want, f"R = {R}, N = 64, a quarter of "
            "the slots dead")
    bins, pos, gq, hq, ids, M = dup_wave_inputs(gen)
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, 256, max_nodes=M)
    cmp("hist_q", got, hist.hist_wave_q_plain(bins, pos, gq, hq, ids, 256, M),
        "a duplicated id (slots 1 and 63) and pads, N = 64")
    check(torch.equal(got[1], got[63]) and bool(got[1].any()),
          "hist_q: the duplicated id's slots differ")
    rows = bins.t().contiguous()
    idx, pg, gg, hg = compacted(pos, gq, hq, ids, 65536, 0.25, gen)
    got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256, max_nodes=M)
    cmp("hist_gather_q", got, hist.hist_gather_q_plain(rows, idx, pg, gg, hg,
                                                       ids, 256, M),
        "R = 65536, a duplicated id (slots 1 and 63) and pads, N = 64")
    check(torch.equal(got[1], got[63]) and bool(got[1].any()),
          "hist_gather_q: the duplicated id's slots differ")
    NW, n = 64, 1 << 20
    nid = torch.randperm(M, generator=gen, device="cuda")[:NW].to(
        torch.int32)
    valid = torch.rand((NW,), generator=gen, device="cuda") < 0.75
    feat = torch.randint(0, 28, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    feat[~valid] = -1
    slot = torch.randint(0, 256, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (M + 2 * torch.arange(NW, device="cuda")).to(torch.int32)
    lo = torch.randint(0, 128, (NW,), generator=gen, device="cuda",
                       dtype=torch.int32)
    hi = lo + torch.randint(1, 128, (NW,), generator=gen, device="cuda",
                            dtype=torch.int32)
    args = (bins, pos, valid, nid, feat, slot, lch, lch + 1, lo, hi)
    got = route.route_wave(*args[:8], lo=lo, hi=hi)
    want = route.route_wave_plain(*args)
    cmp("route", got, want, "NW = 64 over 2^20 rows, invalid slots, EFB "
        "member ranges")
    route_edge_cases(gen, cmp)
    return errs


def route_edge_cases(gen, cmp):
    """K5's lookup, row and store paths (slice 7), each against its plain
    version: duplicated valid ids (the later slot wins), a duplicated id
    whose later slot is invalid, node ids above K1-K4's 57,344 cap and a
    wave wider than the direct map, a misaligned pos[1:] view, out
    separate from and aliased to pos, int32 bins, int64 slot fields."""
    import torch

    from ytklearn_tpu_torch.gbdt import route

    NW, n, F = 64, (1 << 20) + 3, 28
    for what, dup, base, spread, view, alias, i32, wide in (
            ("duplicated valid ids", "valid", 0, 129, False, False, False,
             False),
            ("a duplicated id whose later slot is invalid", "invalid", 0,
             129, False, True, False, False),
            ("node ids above 57,344", None, 60000, 129, False, False, False,
             False),
            ("ids spread over 10^6 (the sorted lookup)", None, 60000,
             10 ** 6, False, True, False, True),
            ("a misaligned pos[1:], out separate", None, 0, 129, True,
             False, False, False),
            ("a misaligned pos[1:], out aliased", None, 0, 129, True, True,
             False, False),
            ("int32 bins, out aliased", None, 0, 129, False, True, True,
             False)):
        B = 1024 if i32 else 256
        bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                             dtype=torch.int32)
        bins = bins if i32 else bins.to(torch.uint8)
        ids = torch.randperm(spread, generator=gen, device="cuda")[:NW]
        nid = (ids + base).to(torch.int32)
        full = nid[torch.randint(0, NW, (n + 1,), generator=gen,
                                 device="cuda")]
        full[torch.rand((n + 1,), generator=gen, device="cuda") < 0.2] = -1
        pos = full[1:] if view else full[:n].clone()
        valid = torch.rand((NW,), generator=gen, device="cuda") < 0.8
        if dup:
            nid[NW - 1] = nid[1]
            valid[1] = True
            valid[NW - 1] = dup == "valid"
        feat = torch.randint(-1, F + 1, (NW,), generator=gen, device="cuda",
                             dtype=torch.int32)
        slot = torch.randint(0, B, (NW,), generator=gen, device="cuda",
                             dtype=torch.int32)
        lch = (base + 2 * spread + 2 * torch.arange(NW, device="cuda")).to(
            torch.int32)
        lo = torch.randint(0, B // 4, (NW,), generator=gen, device="cuda",
                           dtype=torch.int32)
        hi = lo + B // 2
        if wide:
            feat, slot, lo, hi = (x.long() for x in (feat, slot, lo, hi))
        want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                      lch + 1, lo, hi)
        got = route.route_wave(bins, pos, valid, nid, feat, slot, lch,
                               lch + 1, lo=lo, hi=hi,
                               out=pos if alias else None)
        check(not alias or got.data_ptr() == pos.data_ptr(),
              f"route: out is not pos at {what}")
        cmp("route", got, want, f"NW = {NW} over {n} rows, {what}")


def phase_train(tmp, card, precision="int8"):
    """The full-width training run at one histogram precision: int8, the
    main path of slice 2, or bf16, the JAX trainer's default."""
    import torch

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    train, test = gen_higgs_like(TRAIN_ROWS, TEST_ROWS, N_FEATURES, SEED)
    params = bench_params(TRAIN_ROUNDS, os.path.join(tmp, "train.model"))
    trainer = GBDTTrainer(params, hist_precision=precision, device="cuda")
    torch.cuda.synchronize()
    zero_kernel_counts()  # count the main path's launches only
    t0 = time.perf_counter()
    res = trainer.train(train=train, test=test)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernel_counts()
    losses = [r["train_loss"] for r in res.round_log]
    trees = len(res.model.trees)
    sync = trainer.sync_log
    # bench.py:346-352: from the first sync at round >= 3 to the last
    tail = [(r, t) for r, t in sync if r >= 3]
    check(len(tail) >= 2, f"too few syncs for a steady window: {sync}")
    (r0, t0s), (r1, t1s) = tail[0], tail[-1]
    tps = (r1 - r0) / (t1s - t0s)
    auc = res.test_metrics["auc"]
    print(f"train {precision}: {TRAIN_ROWS} rows x {N_FEATURES} features, "
          f"{TEST_ROWS} test rows, {trees} trees (loss policy, 255 leaves, "
          f"wave {trainer.grow_spec.wave}, ladder {trainer.grow_spec.ladder}, "
          f"{precision}) in {wall:.3f} s (preprocess "
          f"{trainer.time_stats['preprocess']:.3f} s, rounds "
          f"{trainer.time_stats['train']:.3f} s); steady {tps:.4f} trees/s "
          f"(sync log, rounds {r0}..{r1}); train loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f}; test AUC {auc:.6f}, test logloss "
          f"{res.test_loss:.6f} (EvalSet logloss "
          f"{res.test_metrics['logloss']:.6f}) [{card}]", flush=True)
    per_tree = {k: v / trees for k, v in counts.items()}
    # the trainer reads one loss per round besides the engine's probes
    syncs = (counts["host_syncs"] + len(sync)) / trees
    full, gather = PRECISION_KERNELS[precision]
    print(f"train {precision}: launches per tree: {full} "
          f"{per_tree[full]:.2f}, {gather} {per_tree[gather]:.2f}, route "
          f"{per_tree['route']:.2f}; host syncs per tree {syncs:.2f} "
          f"({counts['host_syncs']} phase probes + {len(sync)} loss reads "
          f"over {trees} trees); wave log rows used per tree "
          f"{(trainer.wave_log[..., 3] > 0).sum() / trees:.2f} [{card}]",
          flush=True)
    other = [k for k in ("hist", "hist_gather", "hist_q", "hist_gather_q")
             if k not in (full, gather)]
    check(all(counts[k] > 0 for k in (full, gather, "route"))
          and all(counts[k] == 0 for k in other),
          f"the {precision} path did not run exactly its kernels: {counts}")
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0]
          and res.train_loss < 0.65, f"train loss did not fall: {losses}")
    check(0.5 < auc <= 1.0 and math.isfinite(res.test_loss),
          f"test AUC {auc} / logloss {res.test_loss}")
    return counts, trainer, res, tps


def phase_train_profile(card):
    """Two traced rounds of a second full-width run: device busy time
    (kernels and copies) against the wall time of those rounds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    class Traced(GBDTTrainer):
        def _round(self, rnd, dd, spec, state):
            if rnd == 1:
                torch.cuda.synchronize()
                self.prof = profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA])
                self.prof.__enter__()
                self.t0 = time.perf_counter()
            out = super()._round(rnd, dd, spec, state)
            if rnd == 2:
                torch.cuda.synchronize()
                self.wall_ms = (time.perf_counter() - self.t0) * 1e3
                self.prof.__exit__(None, None, None)
            return out

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_p_")
    try:
        train, test = gen_higgs_like(TRAIN_ROWS, TEST_ROWS, N_FEATURES, SEED)
        tr = Traced(bench_params(3, os.path.join(tmp, "p.model")),
                    hist_precision="int8", device="cuda")
        tr.train(train=train, test=test)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    busy_ms, top = device_busy(tr.prof, 6)
    check(busy_ms > 0, "the profiler saw no device time in training")
    idle = 1 - busy_ms / tr.wall_ms
    print(f"train profile: 2 rounds (traced), wall {tr.wall_ms:.3f} ms, "
          f"device busy {busy_ms:.3f} ms, idle share {idle:.4f}; top device "
          f"ops: {fmt_top(top, 48)} [{card}]", flush=True)
    return idle


def phase_cpu_card_compare(card):
    """One small l2 configuration on cuda and on the CPU: the same trees."""
    import numpy as np

    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    rng = np.random.RandomState(SEED)
    n, F = 65536, 8
    X = rng.randn(n, F).astype(np.float32)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
         + rng.randn(n) * 0.3).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_c_")
    models = {}
    try:
        for dev in ("cuda", "cpu"):
            p = GBDTParams(
                round_num=5, max_depth=8, max_leaf_cnt=63,
                tree_grow_policy="loss", learning_rate=0.1,
                min_child_hessian_sum=10.0, loss_function="l2",
                eval_metric=["rmse"],
                approximate=[ApproximateSpec(max_cnt=255)],
                model=ModelParams(data_path=os.path.join(tmp, dev),
                                  dump_freq=0))
            tr = GBDTTrainer(p, hist_precision="int8", device=dev,
                             wave=16)
            models[dev] = tr.train(GBDTData(X, y, np.ones(n, np.float32), n,
                                            names)).model
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rel = 0.0
    for a, b in zip(models["cuda"].trees, models["cpu"].trees):
        for f in ("feat", "left", "right", "slot", "sample_cnt", "split"):
            check(getattr(a, f) == getattr(b, f),
                  f"cuda and cpu trees differ in {f}")
        la, lb = np.asarray(a.leaf_value), np.asarray(b.leaf_value)
        rel = max(rel, float(np.max(np.abs(la - lb)
                                    / np.maximum(np.abs(lb), 1e-30))))
    nodes = sum(t.n_nodes() for t in models["cuda"].trees)
    print(f"cpu/card: l2, {n} rows x {F} features, 5 trees ({nodes} nodes) "
          f"on cuda and on the CPU: integer fields and split values equal; "
          f"largest relative leaf difference {rel:.3e} [{card}]", flush=True)
    return rel


def bound_ms(nbytes, int_ops):
    """The larger of: `nbytes` over HBM bandwidth, `int_ops` int32
    operations over the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = int_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sector_bytes(offsets):
    """Bytes of the distinct 32-byte sectors that hold these byte offsets:
    the device reads memory in whole sectors."""
    import torch

    return 32 * int(torch.unique(offsets // 32).numel())


def hist_bound_ms(bins, gather, idx, pos, ids, M, B):
    """K2/K4's bound from this call's own inputs. Bytes: pos read whole;
    the sectors of gq, hq (and K4's idx) that hold a row of the wave, and
    of bins those rows' bins (K2: each feature's, feature-major; K4: the
    gathered rows' F bins, row-major); the (N, F, B, 3) int32 histogram
    written once. Operations: three int32 adds per wave row and feature."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import node_slots

    eb = bins.element_size()
    n, N = pos.shape[0], ids.shape[0]
    _, ok = node_slots(pos, ids, M)
    live = torch.nonzero(ok).flatten()
    F = bins.shape[1] if gather else bins.shape[0]
    nbytes = 4 * n + 12 * N * F * B
    nbytes += (3 if gather else 2) * sector_bytes(live * 4)  # (idx,) gq, hq
    if gather:
        rows = idx[live].long()
        nbytes += sector_bytes(((rows * F)[:, None]
                                + torch.arange(F, device=rows.device)) * eb)
    else:
        nbytes += sum(sector_bytes((f * bins.shape[1] + live) * eb)
                      for f in range(F))
    return bound_ms(nbytes, 3 * F * live.numel())


def route_bound_ms(bins_t, pos, valid, nid, feat):
    """K5's bound from this call's own inputs. Bytes: every row's position
    read and written (8 B a row), the slot table, and the sectors of bins
    that hold the bin of a row's matching slot's feature (a row outside
    the wave reads none). Operations: one id compare per row and slot."""
    import torch

    F, n = bins_t.shape
    f_row = torch.full_like(pos, -1)
    for i in range(nid.shape[0]):  # a later matching slot wins, as in K5
        hit = (pos == nid[i]) & valid[i]
        f_row = torch.where(hit, feat[i].clamp(0, F - 1), f_row)
    rows = torch.nonzero(f_row >= 0).flatten()
    nbytes = 8 * n + 32 * nid.shape[0] + sector_bytes(
        (f_row[rows].long() * n + rows) * bins_t.element_size())
    return bound_ms(nbytes, n * nid.shape[0])


def flat_keys(bin_of, F, B, pos, gq, hq, ids, M, bf16=None):
    """Flattened (slot, feature, bin, channel) keys and the values of every
    (row, feature) update: the input of the one-call yardstick. int32
    values of quantized grads (bf16 None), else f32 values of g/h (rounded
    to bf16 first when bf16)."""
    import torch

    from ytklearn_tpu_torch.gbdt.hist import node_slots, round_bf16

    slot, ok = node_slots(pos, ids, M)
    rows = torch.nonzero(ok).flatten()
    s = slot[rows]
    f = torch.arange(F, device="cuda")
    b = torch.stack([bin_of(fi, rows) for fi in range(F)], dim=1).long()
    base = ((s[:, None] * F + f[None, :]) * B + b) * 3  # (rows, F)
    keys = (base[..., None] + torch.arange(3, device="cuda")).flatten()
    if bf16 is None:
        gv, hv = gq[rows].int(), hq[rows].int()
    else:
        gv, hv = gq[rows], hq[rows]
        if bf16:
            gv, hv = round_bf16(gv), round_bf16(hv)
    vals = torch.stack([gv, hv, torch.ones_like(gv)], dim=1)
    vals = vals[:, None, :].expand(-1, F, -1).flatten().contiguous()
    return keys, vals


def phase_train_timings(trainer, card):
    """Each training kernel at the full-width training shapes."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist, route

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    dd_bins = trainer.dev_inputs.bins_t  # (28, n_pad) u8 training bins
    F, n = dd_bins.shape
    B, M = trainer.grow_spec.B, trainer.grow_spec.max_nodes
    N = trainer.grow_spec.wave
    pos = torch.randint(0, 2 * N + 1, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    ids = torch.arange(1, 2 * N + 1, 2, device="cuda", dtype=torch.int32)
    out = {}

    def run(name, fn, plain, lib, bound, iters):
        got, want = fn(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"{name} disagrees at the timing shape")
        ms = cuda_ms(fn, iters=iters)
        plain_ms = cuda_ms(plain, iters=1, repeats=3)
        lib_ms = cuda_ms(lib, iters=3, repeats=3) if lib else None
        out[name] = (ms, plain_ms, bound[0], bound[1], lib_ms)
        print(f"timing: {name} {ms:.6f} ms, plain {plain_ms:.6f} ms, "
              f"one scatter_add_ "
              f"{'%.6f ms' % lib_ms if lib_ms is not None else 'none'}, "
              f"bound {bound[0]:.6f} ms ({bound[1]}) [{card}]", flush=True)

    # K2: one full-scan wave of N slots over every training row
    args = (dd_bins, pos, gq, hq, ids, B)
    keys, vals = flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, gq, hq,
                           ids, M)
    flat = torch.zeros(N * F * B * 3, dtype=torch.int32, device="cuda")
    run("hist_q", lambda: hist.hist_wave_q(*args, max_nodes=M),
        lambda: hist.hist_wave_q_plain(*args, M),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(dd_bins, False, None, pos, ids, M, B), iters=10)
    del keys, vals
    # K4: the first fused rung (n/64 rows) of the same wave
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.05, gen)
    keys, vals = flat_keys(lambda f, r: rows[idx[r].long(), f], F, B, pg,
                           gg, hg, ids, M)
    run("hist_gather_q",
        lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                      max_nodes=M),
        lambda: hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, B, M),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(rows, True, idx, pg, ids, M, B), iters=20)
    del keys, vals, rows
    # K5: one wave of N slots over every training row
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    nid = ids
    feat = torch.randint(0, F, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slot = torch.randint(0, B, (N,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (2 * N + 1 + 2 * torch.arange(N, device="cuda")).to(torch.int32)
    lo = torch.zeros(N, dtype=torch.int32, device="cuda")
    hi = torch.full((N,), B - 1, dtype=torch.int32, device="cuda")
    rargs = (dd_bins, pos, valid, nid, feat, slot, lch, lch + 1)
    run("route", lambda: route.route_wave(*rargs, lo=lo, hi=hi),
        lambda: route.route_wave_plain(*rargs, lo, hi), None,
        route_bound_ms(dd_bins, pos, valid, nid, feat), iters=20)
    return out


# -- slice 6: K2 and K4 redesigned (csrc/hist.cu) ----------------------------

#: the waves of the int8 width phase (the float one's)
Q_WAVES = (1, 2, 8, 16, 32, 42, 64)
#: the int8 bench run's test AUC and logloss, to the digit: int8 sums are
#: exact and the split scans run in a fixed order, so a histogram kernel
#: that moves them is wrong
INT8_TEST_METRICS = ("0.949614", "0.308781")


def q_err(got, want, what, name, card):
    """Hold an int8 histogram exactly to its plain version; print and
    return the largest absolute difference (0 when equal)."""
    import torch

    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max()) if got.numel() \
        else 0.0
    ok = torch.equal(got, want)
    print(f"kernel check {name} {what}, tolerance exact (torch.equal): {ok}, "
          f"max_abs_err {err} [{card}]", flush=True)
    check(ok, f"{name} disagrees with its plain version {what}")
    return err


def plan_text(plan):
    return (f"{plan['kind']} {plan['ng']} x {plan['fg']}, {plan['n_tiles']} "
            f"tiles x {plan['n_chunks']} chunks of {plan['rows_per_chunk']} "
            f"rows, {plan['threads']} threads")


def phase_q_widths(trainer, card):
    """K2 over every bench row and K4 at its first fused rung (R = n/64), on
    waves of Q_WAVES slots (positions over 2N+1 nodes, the wave the odd
    ids, quantized grads at +-127), each held exactly to its plain version
    first, then timed beside one int32 scatter_add_ of the same sums and
    its bound, with the plan q_plan took. Returns the largest error."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    dd_bins = trainer.dev_inputs.bins_t
    F, n = dd_bins.shape
    B = trainer.grow_spec.B
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    err = 0.0
    for N in Q_WAVES:
        M = 2 * N + 1
        pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.arange(1, M, 2, device="cuda", dtype=torch.int32)
        idx, pg, gg, hg = compacted(pos, gq, hq, ids, R, 0.05, gen)
        for name, fn, plain, keys_of, bound, plan, iters in (
            ("hist_q", lambda: hist.hist_wave_q(dd_bins, pos, gq, hq, ids, B,
                                                max_nodes=M),
             lambda: hist.hist_wave_q_plain(dd_bins, pos, gq, hq, ids, B, M),
             lambda: flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, gq, hq,
                               ids, M),
             lambda: hist_bound_ms(dd_bins, False, None, pos, ids, M, B),
             hist.q_plan(N, F, B, M, n, sm), 10),
            ("hist_gather_q",
             lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                           max_nodes=M),
             lambda: hist.hist_gather_q_plain(rows, idx, pg, gg, hg, ids, B,
                                              M),
             lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F, B,
                               pg, gg, hg, ids, M),
             lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B),
             hist.q_plan(N, F, B, M, R, sm, True), 50),
        ):
            what = (f"at the int8 width phase's N = {N} "
                    f"({'n' if name == 'hist_q' else 'R'} = "
                    f"{n if name == 'hist_q' else R})")
            err = max(err, q_err(fn(), plain(), what, name, card))
            ms = cuda_ms(fn, iters=iters)
            keys, vals = keys_of()
            flat = torch.zeros(N * F * B * 3, dtype=torch.int32,
                               device="cuda")
            lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                             iters=3, repeats=3)
            del keys, vals, flat
            b_ms, b_by = bound()
            print(f"width q: {name} N = {N} {ms:.6f} ms, one int32 "
                  f"scatter_add_ {lib_ms:.6f} ms (ratio {ms / lib_ms:.3f}), "
                  f"bound {b_ms:.6f} ms ({b_by}), plan {plan_text(plan)} "
                  f"[{card}]", flush=True)
        del idx, pg, gg, hg
    print(f"phase q widths: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def phase_q_saturating(n, card):
    """The largest sums a lane of K2/K4 takes: every one of n rows in one
    node and one bin at gq = -127, then +127, and hq = 127 (|sum| = 127 n,
    within int32 at the bench's rows). K2 in the root wave and in a
    64-slot wave at q_plan's plan, at the longest chunk (one chunk: one
    block's tile takes every row) and at red; K4 over all n rows gathered,
    at its plan and its longest chunk. Each exactly against the known sums
    and the plain version."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    F, B = N_FEATURES, 256
    check(127 * n < 2 ** 31, f"{n} rows at 127 would wrap int32")
    bins = torch.full((F, n), 17, dtype=torch.uint8, device="cuda")
    pos = torch.full((n,), 5, dtype=torch.int32, device="cuda")
    h = torch.full((n,), 127.0, device="cuda")
    root = torch.tensor([5], dtype=torch.int32, device="cuda")
    wave = torch.arange(64, dtype=torch.int32, device="cuda")
    rows = bins.t().contiguous()
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    err = 0.0
    for gv in (-127.0, 127.0):
        g = torch.full((n,), gv, device="cuda")
        sums = torch.tensor([int(gv) * n, 127 * n, n], dtype=torch.int32,
                            device="cuda")
        cases = []
        for ids in (root, wave):
            N = ids.shape[0]
            ng, fg = hist._q_tile(N, F, B)
            tile = {"ng": ng, "fg": fg, "threads": 1024}
            for plan in (None, dict(tile, kind="tile", n_chunks=1),
                         {"kind": "red", "n_chunks": 528}):
                cases.append(("hist_q", ids, plan, lambda ids=ids, p=plan:
                              hist.hist_wave_q(bins, pos, g, h, ids, B,
                                               max_nodes=64, plan=p)))
        for plan in (None, {"kind": "tile", "ng": 1, "fg": F,
                            "n_chunks": 1}):
            cases.append(("hist_gather_q", root, plan, lambda p=plan:
                          hist.hist_wave_gather(rows, idx, pos, g, h, root,
                                                B, max_nodes=64, plan=p)))
        for name, ids, plan, fn in cases:
            N = ids.shape[0]
            want = torch.zeros((N, F, B, 3), dtype=torch.int32,
                               device="cuda")
            want[0 if N == 1 else 5, :, 17] = sums
            got = fn()
            shown = ("q_plan's " + plan_text(hist.q_plan(
                N, F, B, 64, n, torch.cuda.get_device_properties(0)
                .multi_processor_count, name == "hist_gather_q"))
                if plan is None else str(plan))
            what = (f"saturating: {n} rows in one node and bin, gq = "
                    f"{gv:+.0f}, hq = 127, N = {N}, plan {shown}")
            err = max(err, q_err(got, want, what, name, card))
            if name == "hist_q" and plan is None:
                check(torch.equal(got, hist.hist_wave_q_plain(
                    bins, pos, g, h, ids, B, 64)),
                      f"hist_q's plain version disagrees at {what}")
        del g
    print(f"phase q saturating: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err

# -- slice 3: cli train, the f32/bf16 histograms, the binned rung -------------

#: the text files `cli train` reads on the card (2^20 train, 2^17 test
#: lines), its rounds and the depth that keeps its trees on the binned rung
CLI_ROWS = 1 << 20
CLI_TEST_ROWS = 1 << 17
CLI_ROUNDS = 20
CLI_DEPTH = 8
CONF = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "experiment", "higgs", "local_gbdt.conf")
#: K1/K3 against their plain versions: float sums in two atomic orders
HIST_RTOL = 1e-5


def hist_err(got, want, what, name, card):
    """Counts exact; g/h within rtol HIST_RTOL and HIST_RTOL of the largest
    |sum|. Returns the largest absolute g/h error."""
    import torch

    torch.cuda.synchronize()
    counts_ok = torch.equal(got[..., 2], want[..., 2])
    scale = float(want[..., :2].abs().max()) if want.numel() else 0.0
    diff = (got[..., :2] - want[..., :2]).abs()
    err = float(diff.max()) if want.numel() else 0.0
    ok = counts_ok and bool((diff <= HIST_RTOL * want[..., :2].abs()
                             + HIST_RTOL * scale).all())
    print(f"kernel check {name} {what}, tolerance counts exact, g/h rtol "
          f"{HIST_RTOL} + {HIST_RTOL} x max|sum| ({scale:.6g}): counts exact "
          f"{counts_ok}, within {ok}, max_abs_err {err} [{card}]", flush=True)
    check(ok, f"{name} disagrees with its plain version at {what}")
    return err


def phase_float_kernels(card):
    """K1 and K3 at bf16 and f32 against their plain versions on the card,
    at the int8 checks' shapes."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    errs = {"hist": 0.0, "hist_gather": 0.0}
    for F, n, B, N, dt in HIST_SHAPES:
        bins, pos, _, _, ids, M = rand_hist_inputs(gen, F, n, B, N, dt)
        g = torch.randn((n,), generator=gen, device="cuda") * 3
        h = torch.rand((n,), generator=gen, device="cuda")
        for bf16 in (True, False):
            got = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                                 use_bf16=bf16)
            want = hist.hist_wave_plain(bins, pos, g, h, ids, B, M, bf16)
            errs["hist"] = max(errs["hist"], hist_err(
                got, want, f"(F, n, B, N) = ({F}, {n}, {B}, {N}) {dt} bins "
                f"{'bf16' if bf16 else 'f32'}", "hist", card))
    bins, pos, _, _, ids, M = rand_hist_inputs(gen, 28, 1 << 20, 256, 64,
                                               "u8")
    g = torch.randn((1 << 20,), generator=gen, device="cuda") * 3
    h = torch.rand((1 << 20,), generator=gen, device="cuda")
    rows = bins.t().contiguous()
    for R in GATHER_SHAPES:
        idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.25, gen)
        for bf16 in (True, False):
            got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                        mode="mxu", max_nodes=M,
                                        use_bf16=bf16)
            want = hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, 256, M,
                                          bf16)
            errs["hist_gather"] = max(errs["hist_gather"], hist_err(
                got, want, f"R = {R}, N = 64, a quarter of the slots dead, "
                f"{'bf16' if bf16 else 'f32'}", "hist_gather", card))
    bins, pos, _, _, ids, M = dup_wave_inputs(gen)
    rows = bins.t().contiguous()
    idx, pg, gg, hg = compacted(pos, g, h, ids, 65536, 0.25, gen)
    for bf16 in (True, False):
        what = (f"a duplicated id (slots 1 and 63) and pads, N = 64, "
                f"{'bf16' if bf16 else 'f32'}")
        full = hist.hist_wave(bins, pos, g, h, ids, 256, max_nodes=M,
                              use_bf16=bf16)
        gath = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, 256,
                                     mode="mxu", max_nodes=M, use_bf16=bf16)
        errs["hist"] = max(errs["hist"], hist_err(
            full, hist.hist_wave_plain(bins, pos, g, h, ids, 256, M, bf16),
            what, "hist", card))
        errs["hist_gather"] = max(errs["hist_gather"], hist_err(
            gath, hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, 256, M,
                                         bf16), "R = 65536, " + what,
            "hist_gather", card))
        hist_err(full[63], full[1], what + ": slot 63 against slot 1",
                 "hist", card)
        hist_err(gath[63], gath[1], what + ": slot 63 against slot 1",
                 "hist_gather", card)
    return errs


def binned_tables(model):
    """(vocab, heap, u8 edges table, u16 thresholds table) of a model: the
    edges span its split values in 200 steps per feature; the thresholds
    are its own split values (more than 254 on a feature of the 500-tree
    model)."""
    import numpy as np

    from ytklearn_tpu_torch.serve import kernels

    used = sorted({t.feat_name[i] for t in model.trees
                   for i in range(t.n_nodes()) if not t.is_leaf(i)})
    vocab = {n: i for i, n in enumerate(used)}
    heap, why = kernels.build_heap(model.trees, vocab)
    check(heap is not None, why)
    sv = split_values(model)
    edges = {n: np.linspace(min(sv) - 1.0, max(sv) + 1.0, 200) for n in used}
    u8, why = kernels.build_bin_table(model.trees, vocab, edges)
    check(u8 is not None and u8.mode == "edges" and u8.sentinel == 255, why)
    u16, why = kernels.build_bin_table(model.trees, vocab, None)
    check(u16 is not None and u16.sentinel == 65535,
          f"want a uint16 thresholds table: {why}")
    return vocab, heap, u8, u16


def binned_inputs(heap, table, X, device="cuda"):
    import numpy as np
    import torch

    from ytklearn_tpu_torch.serve import kernels

    bins = torch.from_numpy(kernels.bin_rows(X, table)).to(device)
    packed = torch.from_numpy(kernels.pack_heap_nodes(heap, table)).to(
        device)
    leaf = torch.from_numpy(np.ascontiguousarray(heap.leaf)).to(device)
    return bins, packed, leaf


def phase_binned_kernel(model, card):
    """K7 against its plain version with torch.equal, on uint8 and uint16
    tables, rows with missing values (the sentinel), at every ladder rung
    of the seeded 500-tree model."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.serve import kernels

    vocab, heap, u8, u16 = binned_tables(model)
    rng = np.random.RandomState(SEED + 5)
    max_err = 0.0
    for table in (u8, u16):
        for B in LADDER:
            rows = random_rows(rng, B, list(vocab), split_values(model))
            X = np.full((B, len(vocab)), np.nan)
            for i, r in enumerate(rows):
                for k, v in r.items():
                    if k in vocab:
                        X[i, vocab[k]] = v
            bins, packed, leaf = binned_inputs(heap, table, X)
            got = kernels.binned_walk(bins, packed, leaf, heap.depth,
                                      table.sentinel,
                                      max_feat=int(heap.feat.max()))
            want = kernels.binned_walk_plain(bins, packed, leaf, heap.depth,
                                             table.sentinel)
            torch.cuda.synchronize()
            ok = torch.equal(got, want)
            err = float((got - want).abs().max())
            max_err = max(max_err, err)
            print(f"kernel check binned_walk {table.mode} {table.dtype} "
                  f"table, {heap.n_trees} trees depth {heap.depth}, rung {B} "
                  f"({int((bins == table.sentinel).sum())} sentinel bins), "
                  f"tolerance exact (torch.equal): {ok}, max_abs_err {err} "
                  f"[{card}]", flush=True)
            check(ok, f"binned_walk disagrees at rung {B} ({table.dtype})")
    return max_err


def write_ytk_text(path, X, y, rng):
    """ytklearn text lines `1###label###f0:v,...`, 1% of them with one
    feature left out (a missing value)."""
    Xh = X.cpu().double().numpy()
    yh = y.cpu().numpy().astype(int).tolist()
    F = Xh.shape[1]
    fmt = "1###%d###" + ",".join(f"f{j}:%.9g" for j in range(F)) + "\n"
    blank = (rng.rand(len(Xh)) < 0.01).tolist()
    with open(path, "w") as f:
        for i, row in enumerate(Xh.tolist()):
            if blank[i]:
                j = rng.randint(F)
                f.write(f"1###{yh[i]}###" + ",".join(
                    f"f{k}:{row[k]:.9g}" for k in range(F) if k != j) + "\n")
            else:
                f.write(fmt % (yh[i], *row))


class Recorder:
    """Keeps each instance whose `method` runs, and that call's seconds."""

    def __init__(self, cls, method):
        self.cls, self.method, self.calls = cls, method, []

    def __enter__(self):
        orig = getattr(self.cls, self.method)
        rec = self

        def wrapped(obj, *a, **k):
            t0 = time.perf_counter()
            out = orig(obj, *a, **k)
            rec.calls.append((obj, time.perf_counter() - t0))
            return out

        self.orig = orig
        setattr(self.cls, self.method, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)


def phase_cli_train(tmp, card):
    """`python -m ytklearn_tpu_torch.cli train gbdt <conf>` on the card, run
    in this process (cli.main with the same arguments) so that the kernels'
    counts can be read: the Higgs config at full width (F = 28, 255 bins,
    255 leaves, loss policy, bf16) on 2^20 text lines."""
    import contextlib
    import io

    import numpy as np
    import torch

    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    train, test = gen_higgs_like(CLI_ROWS, CLI_TEST_ROWS, N_FEATURES,
                                 SEED + 6)
    rng = np.random.RandomState(SEED + 6)
    t0 = time.perf_counter()
    paths = {k: os.path.join(tmp, f"{k}.txt") for k in ("train", "test")}
    write_ytk_text(paths["train"], train.X, train.y, rng)
    write_ytk_text(paths["test"], test.X, test.y, rng)
    del train, test
    torch.cuda.empty_cache()
    model = os.path.join(tmp, "cli", "gbdt.model")
    argv = ["train", "gbdt", CONF,
            "--set", f"data.train.data_path={paths['train']}",
            "--set", f"data.test.data_path={paths['test']}",
            "--set", f"model.data_path={model}",
            "--set", f"model.feature_importance_path={model}.imp",
            "--set", f"optimization.round_num={CLI_ROUNDS}",
            "--set", f"optimization.max_depth={CLI_DEPTH}"]
    print(f"cli train: wrote {CLI_ROWS} + {CLI_TEST_ROWS} text lines in "
          f"{time.perf_counter() - t0:.3f} s (host) [{card}]; python -m "
          f"ytklearn_tpu_torch.cli {' '.join(argv)}", flush=True)
    out = io.StringIO()
    zero_kernel_counts()  # count the main path's launches only
    with Recorder(GBDTIngest, "load") as ingest, \
            Recorder(GBDTTrainer, "train") as trained, \
            contextlib.redirect_stdout(out):
        t0 = time.perf_counter()
        rc = cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = kernel_counts()
    line = out.getvalue().strip().splitlines()[-1]
    print(f"cli train: rc {rc}, {wall:.3f} s [{card}]; {line}", flush=True)
    res = json.loads(line)
    trainer = trained.calls[0][0]
    ts = trainer.time_stats
    sync = [(r, t) for r, t in trainer.sync_log if r >= 3]
    tps = (sync[-1][0] - sync[0][0]) / (sync[-1][1] - sync[0][1])
    trees = res["trees"]
    print(f"cli train: ingest {ingest.calls[0][1]:.3f} s (parse + fill, "
          f"host), preprocess {ts['preprocess']:.3f} s, rounds "
          f"{ts['train']:.3f} s, steady {tps:.4f} trees/s; precision "
          f"{trainer.hist_precision}, test AUC "
          f"{res['test_metrics']['auc']:.6f}, test loss "
          f"{res['test_loss']:.6f}; launches per tree: hist "
          f"{counts['hist'] / trees:.2f}, hist_gather "
          f"{counts['hist_gather'] / trees:.2f}, route "
          f"{counts['route'] / trees:.2f} (hist_q {counts['hist_q']}, "
          f"hist_gather_q {counts['hist_gather_q']}) [{card}]", flush=True)
    check(rc == 0 and trees == CLI_ROUNDS, f"cli train: rc {rc}, {res}")
    check(os.path.exists(model) and os.path.exists(model + ".bins.json"),
          "cli train wrote no model or no sidecar")
    check(trainer.hist_precision == "bf16", "cli train did not run bf16")
    check(all(counts[k] > 0 for k in ("hist", "hist_gather", "route"))
          and counts["hist_q"] == 0 and counts["hist_gather_q"] == 0,
          f"cli train did not run K1, K3 and K5 only: {counts}")
    check(0.5 < res["test_metrics"]["auc"] <= 1.0
          and res["train_loss"] < 0.69, f"cli train result {res}")
    return counts, model, tps, res


def serve_conf(model, tmp, name):
    conf = os.path.join(tmp, f"{name}.conf")
    with open(conf, "w") as f:
        f.write(f'model {{ data_path = "{model}" }}\n'
                "optimization { loss_function = sigmoid, round_num = 1000 }\n")
    return conf


def phase_serve_binned(tmp, model_path, card):
    """The model `cli train` just wrote, served on the binned rung (what
    `cli serve` starts, with YTK_SERVE_BINNED=1): edges mode from its
    sidecar, every score bit-equal to the port's CPU binned scorer; then,
    with the sidecar removed, thresholds mode bit-equal to the host tree
    walk."""
    import numpy as np

    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        CompiledScorer,
        ModelRegistry,
        ServeApp,
        kernels,
    )

    with open(model_path) as f:
        model = GBDTModel.loads(f.read())
    names = [f"f{i}" for i in range(N_FEATURES)]
    splits = split_values(model)
    conf = serve_conf(model_path, tmp, "binned")
    os.environ.pop("YTK_SERVE_FUSED", None)
    os.environ["YTK_SERVE_BINNED"] = "1"
    try:
        registry = ModelRegistry(device="cuda")
        entry = registry.load("default", "gbdt", hocon.load(conf))
    finally:
        os.environ.pop("YTK_SERVE_BINNED")
    info = entry.scorer.rung_info()
    print(f"serve binned: {len(model.trees)} trees of depth <= "
          f"{max(t.max_depth() for t in model.trees)}, rung "
          f"{json.dumps(info)} [{card}]", flush=True)
    check((info["mode"], info["backend"], info.get("bin_mode")) ==
          ("binned", "binned-cuda", "edges"), f"not binned on K7: {info}")
    cpu = CompiledScorer(create_predictor("gbdt", conf), mode="binned",
                         device="cpu")
    app = ServeApp(registry, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0).start()
    rng = np.random.RandomState(SEED + 7)
    try:
        kernels.binned_walk.launches = 0  # count the main path's only
        lat = []
        one_rows = random_rows(rng, 200, names, splits)
        got = []
        for row in one_rows:
            t0 = time.perf_counter()
            got += post(app.port, {"features": row})["scores"]
            lat.append((time.perf_counter() - t0) * 1e3)
        batch = random_rows(rng, 512, names, splits)
        out = post(app.port, {"rows": batch})
        launches = kernels.binned_walk.launches
    finally:
        app.stop(drain=True, timeout=30.0)
    rows = one_rows + batch
    got = np.asarray(got + out["scores"])
    want = cpu.score_batch(rows)
    p50 = statistics.median(lat)
    print(f"serve binned: 200 one-row requests + one of 512 rows, every "
          f"score bit-equal to the CPU binned scorer "
          f"{np.array_equal(got, want)}; one-row p50 {p50:.4f} ms (client "
          f"clock); binned_walk launches {launches} [{card}]", flush=True)
    check(np.array_equal(got, want), "binned rung differs from the CPU's")
    check(launches > 0, "the binned rung launched no binned_walk kernel")
    side = model_path + ".bins.json"
    os.rename(side, side + ".off")
    try:
        pred = create_predictor("gbdt", conf)
        th = CompiledScorer(pred, mode="binned", device="cuda")
        s = th.score_batch(rows)
        ok = np.array_equal(s, pred.batch_scores(rows))
    finally:
        os.rename(side + ".off", side)
    print(f"serve binned: without the sidecar, rung "
          f"{json.dumps(th.rung_info())}, scores bit-equal to "
          f"GBDTPredictor.batch_scores {ok} [{card}]", flush=True)
    check(th.rung_info()["bin_mode"] == "thresholds" and ok,
          "thresholds-mode binned scores differ from the host tree walk")
    return launches, p50


def phase_repro(card):
    """The small l2 configuration in bf16, twice on the card and once on
    the CPU: do the card's float atomics give the same trees run to run?"""
    import numpy as np

    from ytklearn_tpu_torch.config.params import (
        ApproximateSpec,
        GBDTParams,
        ModelParams,
    )
    from ytklearn_tpu_torch.gbdt.data import GBDTData
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    rng = np.random.RandomState(SEED)
    n, F = 65536, 8
    X = rng.randn(n, F).astype(np.float32)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
         + rng.randn(n) * 0.3).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_r_")
    runs = []
    try:
        for i, dev in enumerate(("cuda", "cuda", "cpu")):
            p = GBDTParams(
                round_num=5, max_depth=8, max_leaf_cnt=63,
                tree_grow_policy="loss", learning_rate=0.1,
                min_child_hessian_sum=10.0, loss_function="l2",
                eval_metric=["rmse"],
                approximate=[ApproximateSpec(max_cnt=255)],
                model=ModelParams(data_path=os.path.join(tmp, str(i)),
                                  dump_freq=0))
            res = GBDTTrainer(p, hist_precision="bf16", device=dev,
                              wave=16).train(
                GBDTData(X, y, np.ones(n, np.float32), n, names))
            runs.append(res)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    def key(t):
        return (t.feat, t.left, t.right, t.slot, t.sample_cnt, t.split)

    def leaf_rel(xs, zs):
        """Largest relative leaf difference over the trees of the same
        structure."""
        rel = 0.0
        for x, z in zip(xs, zs):
            if key(x) == key(z):
                la, lz = np.asarray(x.leaf_value), np.asarray(z.leaf_value)
                rel = max(rel, float(np.max(np.abs(la - lz)
                                            / np.maximum(np.abs(lz), 1e-30))))
        return rel

    a, b, c = (r.model.trees for r in runs)
    same_card = sum(key(x) == key(y) for x, y in zip(a, b))
    same_leaves = sum(x.leaf_value == y.leaf_value for x, y in zip(a, b))
    differ = sum(key(x) != key(z) for x, z in zip(a, c))
    rel, rel_card = leaf_rel(a, c), leaf_rel(a, b)
    losses = [np.asarray([r["train_loss"] for r in res.round_log])
              for res in runs]
    loss_rel = max(float(np.max(np.abs(la - losses[2]) / losses[2]))
                   for la in losses[:2])
    identical = same_card == same_leaves == len(a)
    print(f"repro: l2 bf16, {n} rows x {F} features, {len(a)} trees, wave "
          f"16: two card runs give identical trees {identical} (structure "
          f"equal in {same_card}, leaf values equal in {same_leaves} of "
          f"{len(a)} trees; largest relative leaf difference {rel_card:.3e}"
          f"); {differ} of {len(a)} trees differ in structure between card "
          f"and CPU; largest relative leaf difference card/CPU "
          f"(same-structure trees) {rel:.3e}; largest relative train-loss "
          f"difference {loss_rel:.3e} [{card}]", flush=True)
    check(loss_rel <= 1e-4, f"bf16 card and CPU losses differ: {losses}")
    return identical, differ, rel


def phase_float_timings(trainer, card):
    """K1 and K3 at the full-width bf16 training shapes: one 64-slot
    full-scan wave over every training row, and the first fused rung."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    dd_bins = trainer.dev_inputs.bins_t  # (28, n_pad) u8 training bins
    F, n = dd_bins.shape
    B, M = trainer.grow_spec.B, trainer.grow_spec.max_nodes
    N = trainer.grow_spec.wave
    bf16 = trainer.grow_spec.use_bf16
    pos = torch.randint(0, 2 * N + 1, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    g = torch.randn((n,), generator=gen, device="cuda") * 0.5
    h = torch.rand((n,), generator=gen, device="cuda") * 0.25
    ids = torch.arange(1, 2 * N + 1, 2, device="cuda", dtype=torch.int32)
    flat = torch.zeros(N * F * B * 3, dtype=torch.float32, device="cuda")
    out = {}

    def run(name, fn, plain, lib, bound, iters):
        hist_err(fn(), plain(), "at the timing shape", name, card)
        ms = cuda_ms(fn, iters=iters)
        plain_ms = cuda_ms(plain, iters=1, repeats=3)
        lib_ms = cuda_ms(lib, iters=3, repeats=3)
        out[name] = (ms, plain_ms, bound[0], bound[1], lib_ms)
        print(f"timing: {name} ({'bf16' if bf16 else 'f32'}) {ms:.6f} ms, "
              f"plain {plain_ms:.6f} ms, one f32 scatter_add_ {lib_ms:.6f} "
              f"ms, bound {bound[0]:.6f} ms ({bound[1]}) [{card}]",
              flush=True)

    keys, vals = flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, g, h, ids,
                           M, bf16=bf16)
    run("hist", lambda: hist.hist_wave(dd_bins, pos, g, h, ids, B,
                                       max_nodes=M, use_bf16=bf16),
        lambda: hist.hist_wave_plain(dd_bins, pos, g, h, ids, B, M, bf16),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(dd_bins, False, None, pos, ids, M, B), iters=10)
    del keys, vals
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.05, gen)
    keys, vals = flat_keys(lambda f, r: rows[idx[r].long(), f], F, B, pg,
                           gg, hg, ids, M, bf16=bf16)
    run("hist_gather",
        lambda: hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                      mode="mxu", max_nodes=M,
                                      use_bf16=bf16),
        lambda: hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, B, M,
                                       bf16),
        lambda: flat.zero_().scatter_add_(0, keys, vals),
        hist_bound_ms(rows, True, idx, pg, ids, M, B), iters=20)
    return out


#: the waves of the width phase, and bf16 bench trees/s with the kernels
#: K1/K3 had before their redesign (PERF.md section 5, same cell, NVIDIA
#: H100 80GB HBM3 at 700 W)
FLOAT_WAVES = (1, 2, 8, 16, 32, 42, 64)
BF16_TPS_BEFORE = 8.7082


def phase_float_widths(trainer, card):
    """K1 over every bench row and K3 at the first fused rung (R = n/64),
    on waves of FLOAT_WAVES slots (positions over 2N+1 nodes, the wave the
    odd ids), each held against its plain version first, then timed beside
    one f32 scatter_add_ of the same sums and its bound, with the plan
    float_plan took. Returns the largest g/h error."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    dd_bins = trainer.dev_inputs.bins_t
    F, n = dd_bins.shape
    B = trainer.grow_spec.B
    rows = dd_bins.t().contiguous()
    R = -(-(n // 64) // 1024) * 1024
    sm = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.randn((n,), generator=gen, device="cuda") * 0.5
    h = torch.rand((n,), generator=gen, device="cuda") * 0.25
    err = 0.0
    for N in FLOAT_WAVES:
        M = 2 * N + 1
        pos = torch.randint(0, M, (n,), generator=gen, device="cuda",
                            dtype=torch.int32)
        ids = torch.arange(1, M, 2, device="cuda", dtype=torch.int32)
        idx, pg, gg, hg = compacted(pos, g, h, ids, R, 0.05, gen)
        for name, fn, plain, keys_of, bound, plan, iters in (
            ("hist", lambda: hist.hist_wave(dd_bins, pos, g, h, ids, B,
                                            max_nodes=M),
             lambda: hist.hist_wave_plain(dd_bins, pos, g, h, ids, B, M),
             lambda: flat_keys(lambda f, r: dd_bins[f, r], F, B, pos, g, h,
                               ids, M, bf16=True),
             lambda: hist_bound_ms(dd_bins, False, None, pos, ids, M, B),
             hist.float_plan(N, F, B, M, n, sm), 10),
            ("hist_gather",
             lambda: hist.hist_wave_gather_mxu(rows, idx, pg, gg, hg, ids, B,
                                               max_nodes=M),
             lambda: hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, B,
                                            M),
             lambda: flat_keys(lambda f, r: rows[idx[r].long(), f], F, B,
                               pg, gg, hg, ids, M, bf16=True),
             lambda: hist_bound_ms(rows, True, idx, pg, ids, M, B),
             hist.float_plan(N, F, B, M, R, sm, True), 50),
        ):
            what = (f"at the width phase's N = {N} "
                    f"({'n' if name == 'hist' else 'R'} = "
                    f"{n if name == 'hist' else R}), bf16")
            err = max(err, hist_err(fn(), plain(), what, name, card))
            ms = cuda_ms(fn, iters=iters)
            keys, vals = keys_of()
            flat = torch.zeros(N * F * B * 3, dtype=torch.float32,
                               device="cuda")
            lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                             iters=3, repeats=3)
            del keys, vals, flat
            b_ms, b_by = bound()
            print(f"width: {name} N = {N} {ms:.6f} ms, one f32 scatter_add_ "
                  f"{lib_ms:.6f} ms (ratio {ms / lib_ms:.3f}), bound "
                  f"{b_ms:.6f} ms ({b_by}), plan {plan['kind']} "
                  f"{plan['ng']} x {plan['fg']}, {plan['n_tiles']} tiles x "
                  f"{plan['n_chunks']} chunks of {plan['rows_per_chunk']} "
                  f"rows, {plan['threads']} threads [{card}]", flush=True)
        del idx, pg, gg, hg
    print(f"phase float widths: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def binned_bound_ms(bins, packed, depth, LL):
    """K7's bound from this call's inputs: the bins some row looks up (1 or
    2 B each), each packed slot some row visits (4 B), each leaf some row
    reaches (8 B), read once, and the scores written once; operations, the
    compares and f64 adds, over the FP64 rate."""
    import torch

    from ytklearn_tpu_torch.serve import kernels

    B, F = bins.shape
    T, H = packed.shape
    rows = torch.arange(B, device=bins.device)[:, None]
    tids = torch.arange(T, device=bins.device)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=bins.device)
    slots, cells = [], []
    bw = bins.long()
    for _ in range(depth):
        fv, rank1, dl = kernels.unpack_nodes(packed[tids, pos])
        slots.append((tids * H + pos).flatten())
        cells.append((rows * F + fv).flatten())
        vv = bw[rows, fv]
        go_left = torch.where(vv == (255 if bins.element_size() == 1
                                     else 65535), dl > 0, vv < rank1)
        pos = 2 * pos + 2 - go_left.long()

    def distinct(parts):
        return int(torch.unique(torch.cat(parts)).numel())

    nbytes = (distinct(cells) * bins.element_size() + distinct(slots) * 4
              + distinct([(tids * LL + pos - (LL - 1)).flatten()]) * 8
              + B * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = B * T * (depth + 1) / FP64_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_binned_timing(served_model_path, model500, card):
    """K7 at rung 512 on the model the binned rung served (the main path's
    shape), and on the 500-tree model beside K6."""
    import numpy as np
    import torch

    from ytklearn_tpu_torch.gbdt.tree import GBDTModel
    from ytklearn_tpu_torch.gbdt.binning import bin_edges_path, \
        load_bin_edges, model_text_digest
    from ytklearn_tpu_torch.io.fs import LocalFileSystem
    from ytklearn_tpu_torch.serve import kernels

    with open(served_model_path) as f:
        text = f.read()
    served = GBDTModel.loads(text)
    edges = load_bin_edges(LocalFileSystem(),
                           bin_edges_path(served_model_path),
                           model_text_digest(text))
    rng = np.random.RandomState(SEED + 9)
    out = {}
    for label, model, table_of in (
            ("served", served, lambda vocab, heap: kernels.build_bin_table(
                served.trees, vocab, edges)[0]),
            ("500-tree", model500, None)):
        if table_of is None:
            vocab, heap, table, _ = binned_tables(model)
        else:
            used = sorted({t.feat_name[i] for t in model.trees
                           for i in range(t.n_nodes()) if not t.is_leaf(i)})
            vocab = {n: i for i, n in enumerate(used)}
            heap, why = kernels.build_heap(model.trees, vocab)
            check(heap is not None, why)
            table = table_of(vocab, heap)
        B = LADDER[-1]
        rows = random_rows(rng, B, list(vocab), split_values(model))
        X = np.full((B, len(vocab)), np.nan)
        for i, r in enumerate(rows):
            for k, v in r.items():
                if k in vocab:
                    X[i, vocab[k]] = v
        bins, packed, leaf = binned_inputs(heap, table, X)
        mf = int(heap.feat.max())

        def fn():
            return kernels.binned_walk(bins, packed, leaf, heap.depth,
                                       table.sentinel, max_feat=mf)

        def plain():
            return kernels.binned_walk_plain(bins, packed, leaf, heap.depth,
                                             table.sentinel)

        got, want = fn(), plain()
        torch.cuda.synchronize()
        check(torch.equal(got, want), f"binned_walk disagrees ({label})")
        ms = cuda_ms(fn, iters=50)
        plain_ms = cuda_ms(plain, iters=3, repeats=5)
        bound = binned_bound_ms(bins, packed, heap.depth, heap.leaf.shape[1])
        out[label] = (ms, plain_ms, bound[0], bound[1])
        print(f"timing: binned_walk rung {B}, {label} model "
              f"({heap.feat.shape[0]} padded trees, depth {heap.depth}, "
              f"{table.mode} {table.dtype} table): {ms:.6f} ms, plain "
              f"{plain_ms:.6f} ms, bound {bound[0]:.6f} ms ({bound[1]}); no "
              f"single PyTorch call computes it [{card}]", flush=True)
    return out["served"]


# -- slice 4: K8 and the histogram tuning tools --------------------------------

#: published H100 SXM dense int8 tensor-core rate (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12
#: K8 against its plain version: (N, fg, rows_per_block) at F = 28, B = 256
#: over a ragged n
U8_SHAPES = ((1, None, None), (7, 2, 4096), (32, None, None),
             (64, 4, 20000))
U8_ROWS = 200_003
#: wave widths of the K8 / K2 comparison at the tune shape
U8_WAVES = (1, 4, 8, 16, 32, 64)


def mma_floor_ms(N, F, B, n):
    """K8's tensor-core floor: the int8 operations of its padded product,
    2 * 16 ceil(3N/16) * 8 ceil(B/8) * n * F, over the dense int8 rate."""
    ops = 2 * 16 * -(-3 * N // 16) * 8 * -(-B // 8) * n * F
    return ops / INT8_OPS_PER_S * 1e3


def phase_u8_kernels(card):
    """K8 against its plain version (exact) at the U8_SHAPES, on a wave
    with a duplicated id and pads, and against K2 in K8's layout."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist

    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    err = 0.0
    cases = [(N, fg, rows, False) for N, fg, rows in U8_SHAPES]
    cases.append((64, None, None, True))
    cases.append((100, None, None, True))  # 3N > 256: two n-tiles of PV
    for N, fg, rows, dup in cases:
        bins, pos, gq, hq, ids, M = rand_hist_inputs(
            gen, N_FEATURES, U8_ROWS, 256, N, "u8")
        if dup:
            dup_ids(ids)
        got = hist.hist_q_u8(bins, pos, gq, hq, ids, 256, fg=fg,
                             rows_per_block=rows)
        want = hist.hist_q_u8_plain(bins, pos, gq, hq, ids, 256)
        k2 = hist.hist_wave_q(bins, pos, gq, hq, ids, 256, max_nodes=M)
        torch.cuda.synchronize()
        e = float((got.long() - want.long()).abs().max())
        err = max(err, e)
        ok = torch.equal(got, want)
        same_k2 = torch.equal(got, k2.permute(1, 3, 0, 2).reshape(
            N_FEATURES, 3 * N, 256))
        what = (f"(N, F, n, B) = ({N}, {N_FEATURES}, {U8_ROWS}, 256), fg "
                f"{fg or 'default'}, rows/block {rows or 'default'}"
                + (f", a duplicated id (slots 1 and {N - 1}) and pads"
                   if dup else ""))
        print(f"kernel check hist_q_u8 {what}, tolerance exact "
              f"(torch.equal): {ok}, equals K2 permuted {same_k2}, "
              f"max_abs_err {e} [{card}]", flush=True)
        check(ok and same_k2, f"hist_q_u8 disagrees at {what}")
        if dup:
            check(all(torch.equal(got[:, c * N + 1], got[:, c * N + N - 1])
                      for c in range(3)) and bool(got[:, 2 * N + 1].any()),
                  "hist_q_u8: the duplicated id's slots differ")
    print(f"phase u8 kernels: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err


def phase_tools(card):
    """The tuning tools in this process, as `python -m
    ytklearn_tpu_torch.scripts.<tool>` runs them: the main path of slice 4.
    Every launch count is zeroed just before the tools and read just after
    them: tune_hist_kernel runs K1, K2 and K8, micro_hist_gather K2 and K4,
    tune_gbdt K2, K4 and K5."""
    from ytklearn_tpu_torch.scripts import (
        micro_hist_gather,
        tune_gbdt,
        tune_hist_kernel,
    )

    for name, mod, argv in (
        ("tune_hist_kernel", tune_hist_kernel, []),
        ("micro_hist_gather", micro_hist_gather, ["--divs", "8,64",
                                                  "--repeats", "3"]),
        ("tune_gbdt", tune_gbdt, ["--rows", str(1 << 21), "--trees", "6",
                                  "--configs", "32:int8,64:int8"]),
    ):
        t0 = time.perf_counter()
        if name == "tune_hist_kernel":
            zero_kernel_counts()  # count the main path's launches only
        rc = mod.main(argv)
        print(f"phase tool {name} {' '.join(argv)}: rc {rc}, "
              f"{time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        check(rc == 0, f"{name} exited {rc}")
    counts = kernel_counts()
    ran = ("hist", "hist_q", "hist_gather_q", "route", "hist_q_u8")
    print(f"tools: launches over the three tools: "
          f"{', '.join(f'{k} {counts[k]}' for k in ran)} [{card}]",
          flush=True)
    check(all(counts[k] > 0 for k in ran),
          f"the tools did not launch each of their kernels: {counts}")
    return counts["hist_q_u8"]


def phase_u8_timing(card):
    """K8 at the reference's tune shape (its data): exact against its plain
    version and K2, timed beside its bytes bound (hist_bound_ms, counted as
    K2's), its tensor-core floor, its plain version and one scatter_add_."""
    import torch

    from ytklearn_tpu_torch.gbdt import hist
    from ytklearn_tpu_torch.scripts import tune_hist_kernel as tk

    t0 = time.perf_counter()
    n, F, B, N, M = tk.ROWS, tk.F, tk.B, tk.N, tk.SPREAD
    bins, pos, _, _, gq, hq, ids = tk.make_data(n, torch.device("cuda"))

    def fn():
        return hist.hist_q_u8(bins, pos, gq, hq, ids, B)

    def plain():
        return hist.hist_q_u8_plain(bins, pos, gq, hq, ids, B)

    got, want = fn(), plain()
    k2 = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    torch.cuda.synchronize()
    err = float((got.long() - want.long()).abs().max())
    ok = torch.equal(got, want)
    same_k2 = torch.equal(got, k2.permute(1, 3, 0, 2).reshape(F, 3 * N, B))
    print(f"kernel check hist_q_u8 at the tune shape (n, F, B, N) = ({n}, "
          f"{F}, {B}, {N}), tolerance exact (torch.equal): {ok}, equals K2 "
          f"permuted {same_k2}, max_abs_err {err} [{card}]", flush=True)
    check(ok and same_k2, "hist_q_u8 disagrees at the tune shape")
    del got, want, k2
    keys, vals = flat_keys(lambda f, r: bins[f, r], F, B, pos, gq, hq, ids, M)
    flat = torch.zeros(N * F * B * 3, dtype=torch.int32, device="cuda")
    ms = cuda_ms(fn, iters=5)
    plain_ms = cuda_ms(plain, iters=1, repeats=3)
    lib_ms = cuda_ms(lambda: flat.zero_().scatter_add_(0, keys, vals),
                     iters=3, repeats=3)
    del keys, vals
    bound, bound_by = hist_bound_ms(bins, False, None, pos, ids, M, B)
    floor = mma_floor_ms(N, F, B, n)
    k2_ms = cuda_ms(lambda: hist.hist_wave_q(bins, pos, gq, hq, ids, B,
                                             max_nodes=M), iters=5)
    plan = hist.u8_plan(N, F, B, n, torch.cuda.get_device_properties(0)
                        .multi_processor_count)
    print(f"timing: hist_q_u8 (default plan W {plan['W']}, fg "
          f"{plan['fg']}, {plan['rows_per_block']} rows a chunk, "
          f"{plan['items']} items over {plan['blocks']} blocks) "
          f"{ms:.6f} ms, plain {plain_ms:.6f} ms, one scatter_add_ "
          f"{lib_ms:.6f} ms, bound {bound:.6f} ms ({bound_by}), "
          f"mma_floor_ms {floor:.6f}; K2 at the same inputs {k2_ms:.6f} ms "
          f"[{card}]", flush=True)
    # where, if anywhere, the one-hot product wins: K8 and K2 at their
    # default plans on waves of N slots holding every row (the root wave
    # at N = 1), positions folded from the tune data
    for Nw in U8_WAVES:
        pw = (pos % Nw).contiguous()
        iw = torch.arange(Nw, dtype=torch.int32, device="cuda")
        a = cuda_ms(lambda: hist.hist_q_u8(bins, pw, gq, hq, iw, B), iters=3)
        b = cuda_ms(lambda: hist.hist_wave_q(bins, pw, gq, hq, iw, B,
                                             max_nodes=Nw), iters=3)
        print(f"timing: wave of {Nw} slots holding all {n} rows: hist_q_u8 "
              f"{a:.6f} ms (mma_floor_ms {mma_floor_ms(Nw, F, B, n):.6f}), "
              f"hist_q {b:.6f} ms, ratio {a / b:.3f} [{card}]", flush=True)
    print(f"phase u8 timing: {time.perf_counter() - t0:.3f} s [{card}]",
          flush=True)
    return err, (ms, plain_ms, bound, bound_by, lib_ms)


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
    from concurrent.futures import ThreadPoolExecutor

    from ytklearn_tpu_torch.gbdt import hist, route
    from ytklearn_tpu_torch.serve import kernels

    print(sh([kernels.find_nvcc(), "--version"]).splitlines()[-1], flush=True)
    print(f"ninja: {shutil.which('ninja') or 'not found'} (not used: the "
          "kernels are built by nvcc into ctypes libraries)", flush=True)

    # one nvcc per source, all started together
    sources = {"heap_walk.cu": kernels.build_kernel,
               "hist.cu": hist.build_kernel,
               "hist_float.cu": hist.build_float_kernel,
               "route.cu": route.build_kernel,
               "hist_u8.cu": hist.build_u8_kernel}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = {k: pool.submit(fn) for k, fn in sources.items()}
        builds = {k: f.result() for k, f in builds.items()}
    print(f"build: {len(sources)} libraries in {time.perf_counter() - t0:.3f} s (wall, "
          f"in parallel) [{card}]", flush=True)
    for name, build in builds.items():
        print(f"build: {name} in {build['seconds']:.3f} s [{card}]: "
              f"{build['cmd']}", flush=True)
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
    rows = [{
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
    }]

    errs = phase_train_kernels(card)
    errs.update(phase_float_kernels(card))
    errs["binned_walk"] = phase_binned_kernel(model, card)
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_t_")
    try:
        counts, trainer, res8, _tps = phase_train(tmp, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got = (f"{res8.test_metrics['auc']:.6f}", f"{res8.test_loss:.6f}")
    print(f"train int8: test AUC and logloss {got}, expected "
          f"{INT8_TEST_METRICS} [{card}]", flush=True)
    check(got == INT8_TEST_METRICS,
          f"int8 test AUC/logloss {got} moved from {INT8_TEST_METRICS}")
    ttimes = phase_train_timings(trainer, card)
    q_width_err = phase_q_widths(trainer, card)
    n_bench = trainer.dev_inputs.bins_t.shape[1]
    del trainer
    torch.cuda.empty_cache()
    q_sat_err = phase_q_saturating(n_bench, card)
    errs["hist_q"] = max(errs["hist_q"], q_width_err, q_sat_err)
    errs["hist_gather_q"] = max(errs["hist_gather_q"], q_width_err, q_sat_err)
    torch.cuda.empty_cache()
    phase_train_profile(card)
    phase_cpu_card_compare(card)

    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_cli_")
    try:
        cli_counts, cli_model, _cli_tps, _cli_res = phase_cli_train(tmp,
                                                                    card)
        k7_launches, _k7_p50 = phase_serve_binned(tmp, cli_model, card)
        k7_time = phase_binned_timing(cli_model, model, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="ytk_chip_smoke_b_")
    try:
        _c16, trainer, res16, tps16 = phase_train(tmp, card, "bf16")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"train: test AUC bf16 {res16.test_metrics['auc']:.6f} beside "
          f"int8 {res8.test_metrics['auc']:.6f}; logloss bf16 "
          f"{res16.test_loss:.6f}, int8 {res8.test_loss:.6f} [{card}]",
          flush=True)
    print(f"train bf16: steady {tps16:.4f} trees/s beside "
          f"{BF16_TPS_BEFORE} trees/s before the K1/K3 redesign (PERF.md "
          f"section 5, the same cell and card) [{card}]", flush=True)
    ttimes.update(phase_float_timings(trainer, card))
    errs["hist"] = max(errs["hist"], phase_float_widths(trainer, card))
    del trainer
    torch.cuda.empty_cache()
    phase_repro(card)

    errs["hist_q_u8"] = phase_u8_kernels(card)
    u8_launches = phase_tools(card)
    torch.cuda.empty_cache()
    u8_err, ttimes["hist_q_u8"] = phase_u8_timing(card)
    errs["hist_q_u8"] = max(errs["hist_q_u8"], u8_err)
    launches_of = dict(counts)
    launches_of.update({k: cli_counts[k] for k in ("hist", "hist_gather")})
    launches_of["hist_q_u8"] = u8_launches

    for name, src, line in (
        ("hist_q", "hist.cu", "ytklearn_tpu/gbdt/hist.py:113"),
        ("hist_gather_q", "hist.cu", "ytklearn_tpu/gbdt/hist.py:434"),
        ("route", "route.cu", "ytklearn_tpu/gbdt/route.py:23"),
        ("hist", "hist_float.cu", "ytklearn_tpu/gbdt/hist.py:51"),
        ("hist_gather", "hist_float.cu", "ytklearn_tpu/gbdt/hist.py:371"),
        ("hist_q_u8", "hist_u8.cu", "scripts/tune_hist_kernel.py:71"),
    ):
        ms, plain_ms, bound_ms, bound_by, lib_ms = ttimes[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"ytklearn_tpu_torch/gbdt/csrc/{src}",
            "replaces": line,
            "launches": launches_of[name],
            "max_abs_err": errs[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": lib_ms,
        })
    ms, plain_ms, bound_ms, bound_by = k7_time
    rows.append({
        "name": "binned_walk",
        "route": "cuda",
        "source": "ytklearn_tpu_torch/serve/csrc/heap_walk.cu",
        "replaces": "ytklearn_tpu/serve/kernels.py:439",
        "launches": k7_launches,
        "max_abs_err": errs["binned_walk"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
