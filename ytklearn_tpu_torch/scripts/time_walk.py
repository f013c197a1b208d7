"""K6 and K7, the serving walks, at every rung of the serving ladder on one
line each: the quick A/B of two checkouts of the walk kernels on one card.
Run it from each checkout in turns (A, B, B, A) within one call:

    python -m ytklearn_tpu_torch.scripts.time_walk [--rows N]
        [--repeats R] [--sweep] [--serve N] [--device cpu]

The data, seeded on the host: the 500-tree model (500 trees padded to 504
with -0.0 pad trees, depth 6, 28 features: chip_smoke.py's serving width)
and the served shape (`cli train`'s 20 rounds at depth 8, padded to 24),
random perfect heaps with a quarter of the slots always-left pads; rows
with NaN, +-inf and values exactly at splits; bins with 10% missing. Each
rung of the ladder 1, 8, 64, 512 up to --rows (and --rows itself) times
K6 on the 500-tree model, K7 on it with uint8 bins, and K7 on the served
shape with uint8 and uint16 bins; then K6 at rung 1 on 4,096 trees, whose
time is mostly the row's chain of 4,096 ordered f64 adds. Each case is
first held against its plain version (torch.equal). The script uses the
wrappers' public signatures only (K6's node records where the checkout's
heap tensors carry them), so a copy of it times an older checkout's
kernels too. With --sweep it also times launch shapes around walk_plan's
at rungs 1 and 512. With --serve N it serves the 500-tree model on the
fused rung and a random model of the served shape on the binned rung
(thresholds mode) through ModelRegistry and ServeApp, and prints each
rung's one-row /predict p50 over N requests (client clock) and the
device's idle share over 50 more traced with torch.profiler. Each case
prints the kernel's own time, the median
of the device events of 50 launches traced with torch.profiler, and
beside it the time of a call: CUDA events around 50 calls back to back,
the median of --repeats runs, which a kernel of a few microseconds
leaves to the wrapper's host work. Every line carries the card's name
and power limit; with --device cpu the plain versions run once and every
time reads "not measured (cpu)".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..serve import kernels
from ._common import NOT_MEASURED, Timer, device_busy, fmt_ms, parser, setup

LADDER = (1, 8, 64, 512)
F = 28
MODELS = {"500-tree": (504, 500, 6), "served": (24, 20, 8)}
CHAIN_TREES = 4096


def heap(rng, T, n_real, depth):
    """Random perfect-heap arrays: feat, split, dleft, leaf (-0.0 pad trees
    past n_real, a quarter of the slots always-left pads)."""
    H, LL = (1 << (depth + 1)) - 1, 1 << depth
    feat = rng.randint(0, F, (T, H)).astype(np.int32)
    split = np.round(rng.randn(T, H), 1)
    dleft = rng.randint(0, 2, (T, H)).astype(np.int32)
    pad = rng.rand(T, H) < 0.25
    pad[n_real:] = True
    feat[pad], split[pad], dleft[pad] = 0, np.inf, 1
    leaf = rng.randn(T, LL)
    leaf[n_real:] = -0.0
    return feat, split, dleft, leaf


def rows(rng, B, split):
    X = np.round(rng.randn(B, F), 1)
    r = rng.rand(B, F)
    X[r < 0.1] = np.nan
    X[(r >= 0.1) & (r < 0.13)] = np.inf
    X[(r >= 0.13) & (r < 0.16)] = -np.inf
    at = (r >= 0.16) & (r < 0.3)
    X[at] = rng.choice(split[np.isfinite(split)], size=int(at.sum()))
    return X


def binned(rng, feat, split, dleft, B, dtype):
    hi, sentinel = (250, 255) if dtype == np.uint8 else (1000, 65535)
    rank1 = rng.randint(0, hi + 1, size=feat.shape).astype(np.int64)
    rank1[~np.isfinite(split)] = 0xFFFF
    packed = (feat.astype(np.int64) | (rank1 << 12)
              | (dleft.astype(np.int64) << 28)).astype(np.int32)
    b = rng.randint(0, hi, size=(B, F))
    b[rng.rand(B, F) < 0.1] = sentinel
    return b.astype(dtype), packed, sentinel


#: traces kernel_ms makes before it gives up, and the idle seconds on each
#: side of the traced calls
TRACE_TRIES = 3
TRACE_PAD_S = 0.02


def kernel_ms(dev, fn, chain):
    """The kernel's own time: the median duration of the device events
    named *walk* (the walk kernels) over `chain` calls traced by
    torch.profiler, after a warm-up call. Back-to-back calls of a kernel
    of a few microseconds are bound by the wrapper's host work, which the
    events around them (Timer) measure instead. None on the CPU.

    Fifty such calls take about 2 ms, and a trace that short has, late in
    a long process on the card, come back without one device event. So
    the traced window is padded with TRACE_PAD_S of idle time on each
    side, a trace with no walk kernel is taken again, up to TRACE_TRIES
    times, and then the kernel's own time is not measured: None, with a
    line on standard error saying what the traces held."""
    if dev.type != "cuda":
        fn()
        return None
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize(dev)
    seen = []
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(TRACE_PAD_S)
            for _ in range(chain):
                fn()
            torch.cuda.synchronize(dev)
            time.sleep(TRACE_PAD_S)
        cuda = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        us = sorted(e.time_range.end - e.time_range.start for e in cuda
                    if "walk" in e.name)
        # the tracer may drop the odd event; it never adds one
        if len(us) > chain:
            raise RuntimeError(f"time_walk: traced {len(us)} walk kernels "
                               f"over {chain} calls")
        if us:
            return us[len(us) // 2] / 1e3
        seen.append(len(cuda))
    print(f"time_walk: kernel time not measured: {TRACE_TRIES} traces of "
          f"{chain} calls held no walk kernel ({seen} device events in "
          "all)", file=sys.stderr, flush=True)
    return None


#: a kernel time on the card whose traces held no walk kernel (kernel_ms)
TRACE_EMPTY = "not measured (no walk kernel traced)"


def fmt_pair(kms, cms):
    """A kernel's device time and the time of a call, back to back."""
    if cms is None:
        return NOT_MEASURED
    kernel = TRACE_EMPTY if kms is None else f"{kms:.6f} ms"
    return f"{kernel} (call {cms:.6f} ms)"


class Cases:
    """The wrappers' calls, closed over tensors on the device."""

    def __init__(self, dev, seed=5):
        self.dev = dev
        self.rng = np.random.RandomState(seed)
        self.heaps = {}

    def heap(self, name, T, n_real, depth):
        if name not in self.heaps:
            f, s, d, lf = heap(self.rng, T, n_real, depth)
            ht = kernels.heap_from_numpy(f, s, d, lf, depth, n_real, self.dev)
            self.heaps[name] = (ht, (f, s, d, lf))
        return self.heaps[name]

    def k6(self, name, T, n_real, depth, B):
        ht, (f, s, d, _lf) = self.heap(name, T, n_real, depth)
        X = torch.from_numpy(rows(self.rng, B, s)).to(self.dev)
        plain = (X, *(torch.from_numpy(a).to(self.dev) for a in (f, s, d)),
                 ht.leaf, depth)
        if hasattr(ht, "nodes"):  # node records, K6's one node table
            args = (X, ht.nodes, ht.leaf, depth)
        else:  # an older checkout: the three arrays
            args = (X, ht.feat, ht.split, ht.dleft, ht.leaf, depth)

        def run(**kw):
            return kernels.heap_walk(*args, max_feat=ht.max_feat, **kw)

        return run, lambda: kernels.heap_walk_plain(*plain), (B, T, depth, 8)

    def k7(self, name, T, n_real, depth, B, dtype):
        ht, (f, s, d, lf) = self.heap(name, T, n_real, depth)
        b, packed, sentinel = binned(self.rng, f, s, d, B, dtype)
        bins = torch.from_numpy(b).to(self.dev)
        pk = torch.from_numpy(packed).to(self.dev)
        args = (bins, pk, ht.leaf, depth, sentinel)

        def run(**kw):
            return kernels.binned_walk(*args, max_feat=F - 1, **kw)

        return (run, lambda: kernels.binned_walk_plain(*args),
                (B, T, depth, np.dtype(dtype).itemsize))


def sweep_plans(B, T, depth, bin_bytes, sm):
    """Launch shapes around walk_plan's: its rows and 1, 2 and 8 rows a
    tile, chunks of 64 to 512 trees, and threads at 1, 2 and 4 chains a
    thread, each through check_walk_plan (those it refuses are left out)."""
    base = kernels.walk_plan(B, T, depth, F, bin_bytes, sm)
    out, seen = [], set()
    for rows in sorted({base["rows"], *(r for r in (1, 2, 8) if r <= B)}):
        fold = -(-rows // 32) * 32
        for chunk in sorted({min(T, c) for c in (64, 128, 256, 512)}):
            for chains in (1, 2, 4):
                need = -(-rows * chunk // chains)
                threads = fold + min(1024 - fold,
                                     max(32, -(-need // 32) * 32))
                if (rows, chunk, threads) in seen:
                    continue
                seen.add((rows, chunk, threads))
                try:
                    out.append(kernels.check_walk_plan(
                        {"rows": rows, "chunk": chunk, "threads": threads},
                        B, T, depth, F, bin_bytes))
                except ValueError:
                    continue
    return out


def random_model(rng, n_trees, depth, names, base, digits=None):
    """A GBDTModel of `n_trees` trees of max depth exactly `depth` (the
    left spine runs the whole way; other branches stop early at random),
    splits rounded to `digits` decimals when given, as parsed back from
    its dump (the text's values are f32 renderings: the served model is
    the parsed one)."""
    from ..gbdt.tree import GBDTModel, Tree

    def tree():
        t = Tree()

        def grow(nid, d, spine):
            if d >= depth or (not spine and rng.rand() < 0.2):
                t.leaf_value[nid] = float(rng.randn() * 0.1)
                return
            t.feat[nid] = 0
            t.feat_name[nid] = names[rng.randint(len(names))]
            split = rng.randn()
            t.split[nid] = float(split if digits is None
                                 else np.round(split, digits))
            t.default_left[nid] = bool(rng.rand() < 0.5)
            left, right = t.add_children(nid)
            grow(left, d + 1, spine)
            grow(right, d + 1, False)

        grow(0, 0, True)
        return t

    model = GBDTModel(base_prediction=base, num_tree_in_group=1,
                      obj_name="sigmoid",
                      trees=[tree() for _ in range(n_trees)])
    return GBDTModel.loads(model.dumps())


def serve_rung(dev, card, rung, n_trees, depth, n_requests):
    """One-row /predict latency on a serving rung ("fused" or "binned",
    thresholds mode: no sidecar) of a seeded random model, through
    ModelRegistry + ServeApp as `cli serve` runs them: the client clock's
    p50 over n_requests sequential requests, then the device's idle share
    over 50 more traced with torch.profiler (busy = the union of the
    device events). Both "not measured (cpu)" on the CPU."""
    import json
    import os
    import shutil
    import statistics
    import tempfile
    import time
    import urllib.request

    from ..config import hocon
    from ..serve import BatchPolicy, ModelRegistry, ServeApp

    rng = np.random.RandomState(11)
    names = [f"f{i}" for i in range(F)]
    tmp = tempfile.mkdtemp(prefix="ytk_time_walk_")
    knob = {"fused": "YTK_SERVE_FUSED", "binned": "YTK_SERVE_BINNED"}[rung]
    try:
        path = os.path.join(tmp, "m.model")
        with open(path, "w") as f:
            f.write(random_model(rng, n_trees, depth, names, 0.1,
                                 digits=2).dumps())
        conf = os.path.join(tmp, "m.conf")
        with open(conf, "w") as f:
            f.write(f'model {{ data_path = "{path}" }}\n'
                    "optimization { loss_function = sigmoid, "
                    "round_num = 100000 }\n")
        os.environ[knob] = "1"
        try:
            registry = ModelRegistry(device=dev)
            entry = registry.load("default", "gbdt", hocon.load(conf))
        finally:
            os.environ.pop(knob)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    info = entry.scorer.rung_info()
    if info["mode"] != rung:
        raise RuntimeError(f"time_walk: not serving on the {rung} rung: "
                           f"{info}")
    app = ServeApp(registry, BatchPolicy(max_batch=512, max_wait_ms=2.0),
                   host="127.0.0.1", port=0).start()

    def post(row):
        req = urllib.request.Request(
            f"http://127.0.0.1:{app.port}/predict",
            data=json.dumps({"features": row}).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as resp:
            return json.loads(resp.read())

    def rows(n):
        return [{nm: float(np.round(rng.randn(), 2)) for nm in names
                 if rng.rand() > 0.1} for _ in range(n)]

    try:
        for row in rows(20):  # warm the path
            post(row)
        lat = []
        for row in rows(n_requests):
            t0 = time.perf_counter()
            post(row)
            lat.append((time.perf_counter() - t0) * 1e3)
        idle = None
        if dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile

            traced = rows(50)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for row in traced:
                    post(row)
                torch.cuda.synchronize(dev)
                wall_ms = (time.perf_counter() - t0) * 1e3
            idle = 1 - device_busy(prof)[0] / wall_ms
    finally:
        app.stop(drain=True, timeout=30.0)
        registry.close()
    if dev.type != "cuda":
        return (f"time_walk serve: {rung} rung ({n_trees} trees, depth "
                f"{depth}): one-row p50 {NOT_MEASURED} over {n_requests} "
                f"requests, idle share {NOT_MEASURED} [{card}]")
    return (f"time_walk serve: {rung} rung ({n_trees} trees, depth {depth}"
            f"{', ' + info['bin_mode'] if rung == 'binned' else ''}): "
            f"one-row p50 {statistics.median(lat):.4f} ms over {n_requests} "
            f"requests (client clock), idle share {idle:.4f} over 50 traced "
            f"[{card}]")


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], LADDER[-1])
    ap.add_argument("--sweep", action="store_true",
                    help="also time launch shapes around walk_plan's at "
                         "rungs 1 and 512 (this checkout's planner)")
    ap.add_argument("--serve", type=int, default=0, metavar="N",
                    help="also serve the 500-tree model on the fused rung "
                         "and the served shape on the binned rung, and "
                         "time N one-row /predict requests on each")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    timer = Timer(dev, args.repeats)
    sm = 1 if dev.type == "cpu" else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    rungs = sorted({b for b in LADDER if b <= args.rows} | {args.rows})
    cases = Cases(dev)
    t500, n500, d500 = MODELS["500-tree"]
    ts, ns, ds = MODELS["served"]
    exact = True
    for B in rungs:
        row = {
            "K6 500-tree": cases.k6("500-tree", t500, n500, d500, B),
            "K7 500-tree u8": cases.k7("500-tree", t500, n500, d500, B,
                                       np.uint8),
            "K7 served u8": cases.k7("served", ts, ns, ds, B, np.uint8),
            "K7 served u16": cases.k7("served", ts, ns, ds, B, np.uint16),
        }
        times = {}
        for label, (run, plain, _shape) in row.items():
            ok = torch.equal(run(), plain())
            exact = exact and ok
            times[label] = (kernel_ms(dev, run, 50),
                            timer.ms(run, chain=50), ok)
        print(f"time_walk: rung {B}: " + ", ".join(
            f"{k} {fmt_pair(kms, cms)} (exact: {ok})"
            for k, (kms, cms, ok) in times.items()) + f" [{card}]",
            flush=True)
        if args.sweep and B in (1, LADDER[-1]):
            for label in ("K6 500-tree", "K7 served u8"):
                run, plain, shape = row[label]
                want = plain()
                for plan in sweep_plans(*shape, sm):
                    ok = torch.equal(run(plan=plan), want)
                    exact = exact and ok
                    ms = kernel_ms(dev, lambda: run(plan=plan), 50)
                    shown = (TRACE_EMPTY if ms is None and dev.type == "cuda"
                             else fmt_ms(ms))
                    print(f"time_walk sweep: rung {B} {label} rows "
                          f"{plan['rows']} chunk {plan['chunk']} threads "
                          f"{plan['threads']}: {shown} (exact: {ok}) "
                          f"[{card}]", flush=True)
    run, plain, _ = cases.k6("chain", CHAIN_TREES, CHAIN_TREES, d500, 1)
    ok = torch.equal(run(), plain())
    exact = exact and ok
    print(f"time_walk: K6 rung 1 over {CHAIN_TREES} trees (depth {d500}): "
          f"{fmt_pair(kernel_ms(dev, run, 50), timer.ms(run, chain=50))} "
          f"(exact: {ok}) [{card}]", flush=True)
    plans = getattr(kernels, "walk_plan", None)
    if plans is not None:
        print(f"time_walk: plans at {sm} SMs " + ", ".join(
            f"rung {B} K6 {p6['rows']}x{p6['chunk']}/{p6['threads']} K7 "
            f"served {p7['rows']}x{p7['chunk']}/{p7['threads']}"
            for B, p6, p7 in ((B, plans(B, t500, d500, F, 8, sm),
                               plans(B, ts, ds, F, 1, sm)) for B in rungs))
            + f" [{card}]", flush=True)
    if args.serve:
        for rung, (T, n_real, depth) in (("fused", MODELS["500-tree"]),
                                         ("binned", MODELS["served"])):
            print(serve_rung(dev, card, rung, n_real, depth, args.serve),
                  flush=True)
    if not exact:
        print(f"time_walk: a kernel disagrees with its plain version "
              f"[{card}]", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
