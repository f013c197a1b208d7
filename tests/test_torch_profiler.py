"""The port's profiling plane (ytklearn_tpu_torch/obs/profiler.py) against
the JAX package's (ytklearn_tpu/obs/profiler.py), on the CPU.

Held to the reference: the disabled path (the same cached no-ops), the
abstract signatures and their diffs (the same strings for the same numpy
arrays; torch tensors spell as numpy arrays do), one small int8 GBDT run
and one linear L-BFGS run from the same seeded text files with the plane
on in both packages (the depth-0 phase names, less the reference's
`gbdt.compile`; coverage of at least 0.9 in both; the same span names,
`gbdt.round` once a round and `lbfgs.iteration` once an iteration; the
same `ingest.*` spans; the same `mem.<phase>.*` gauge names, less the
device gauges a CPU run has none of), and `/metrics?prof=1` of both
ServeApps over the same requests (the same keys, the same rows a rung).
The port's own parts: the bounded ledger and memory rings, peaks
attributed to their phase, the capture parser on a real CPU
torch.profiler capture and on a hand-made chrome document in torch's
format with device events (buckets computed by hand), the flight dump's
prof block, and a retrace planted through the build watcher.
"""

import copy
import json
import os
import time

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import build_gbdt, request_rows
from ytklearn_tpu import obs as jobs
from ytklearn_tpu import train as jtrain
from ytklearn_tpu.config.params import CommonParams as JCommon
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu.obs import core as jcore
from ytklearn_tpu.obs import profiler as jprofiler
from ytklearn_tpu.serve import BatchPolicy as JPolicy
from ytklearn_tpu.serve import ModelRegistry as JRegistry
from ytklearn_tpu.serve import ServeApp as JApp
from ytklearn_tpu_torch import cuda_build, obs
from ytklearn_tpu_torch import train as ptrain
from ytklearn_tpu_torch.config.params import CommonParams as PCommon
from ytklearn_tpu_torch.config.params import GBDTParams as PParams
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer as PTrainer
from ytklearn_tpu_torch.obs import core, health, profiler, recorder
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case
from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp

GBDT_ROWS, GBDT_F, GBDT_ROUNDS = 400, 5, 3
CONVEX_ITERS = 4
LADDER = (4, 32)


def _off(prof, o, c):
    prof.configure_profiler(on=False, capture_dir=None)
    prof.reset_profiler()
    if c is jcore:
        c.configure(enabled=False, jax_annotations=False)
    else:
        c.configure(enabled=False, torch_annotations=False)
    o.reset()


@pytest.fixture
def prof_on():
    """The port's plane armed (obs and span annotations underneath) with
    the background sampler off (mem_interval=0): every tick in a test is
    an explicit sample_once()."""
    obs.reset()
    profiler.reset_profiler()
    profiler.configure_profiler(on=True, mem_interval=0.0)
    yield profiler
    _off(profiler, obs, core)


@pytest.fixture
def both_on():
    """The plane armed in both packages, the samplers off."""
    for prof, o in ((profiler, obs), (jprofiler, jobs)):
        o.reset()
        prof.reset_profiler()
        prof.configure_profiler(on=True, mem_interval=0.0)
    yield
    _off(profiler, obs, core)
    _off(jprofiler, jobs, jcore)


# -- the disabled path ----------------------------------------------------------


def test_disabled_path_is_cached_noop():
    """With YTK_PROF unset and obs off, phase() is the obs core's cached
    NOOP_SPAN and LEDGER.program() one cached no-op, as in the reference
    — no allocation, no registry writes, no accounting."""
    obs.configure(enabled=False)
    obs.reset()
    profiler.reset_profiler()
    assert not profiler.enabled()
    p1 = profiler.phase("a", x=1)
    p2 = profiler.phase("b", settle=object())
    assert p1 is p2 is obs.NOOP_SPAN
    boom = lambda: 1 / 0  # noqa: E731 — must never be called when off
    c1 = profiler.LEDGER.program("x", sig_fn=boom)
    c2 = profiler.LEDGER.program("y")
    assert c1 is c2 is profiler.NOOP_PHASE
    with profiler.phase("c"), profiler.LEDGER.program("z", sig_fn=boom):
        pass
    health.note_compile("instantiate", "k[1]", 0.5)  # the watcher, off
    assert profiler.phases_snapshot() == {}
    assert profiler.LEDGER.snapshot()["compiles"] == 0
    assert obs.snapshot() == {"counters": {}, "gauges": {}}
    # the same contract as the reference's
    jobs.configure(enabled=False)
    jprofiler.reset_profiler()
    assert jprofiler.phase("a") is jobs.NOOP_SPAN
    assert jprofiler.LEDGER.program("x") is jprofiler.NOOP_PHASE


def test_phase_delegates_to_span_when_only_obs_on():
    obs.reset()
    obs.configure(enabled=True)
    try:
        with profiler.phase("only.obs"):
            time.sleep(0.002)
        evs = [e for e in obs.REGISTRY.events if e["name"] == "only.obs"]
        assert len(evs) == 1 and evs[0]["dur"] > 0
        assert profiler.phases_snapshot() == {}
    finally:
        obs.configure(enabled=False)
        obs.reset()


def test_phase_accounting_depth_and_coverage(prof_on):
    with profiler.phase("outer"):
        time.sleep(0.02)
        with profiler.phase("inner"):
            time.sleep(0.01)
    with profiler.phase("outer"):
        pass
    snap = profiler.phases_snapshot()
    assert snap["outer"]["depth"] == 0 and snap["outer"]["count"] == 2
    assert snap["inner"]["depth"] == 1
    assert snap["outer"]["wall_s"] >= snap["inner"]["wall_s"] > 0
    assert profiler.coverage(snap["outer"]["wall_s"]) == pytest.approx(1.0)


# -- signatures -----------------------------------------------------------------


def _trees(rng):
    a = rng.randn(4, 8).astype(np.float32)
    b = rng.randint(0, 9, (5, 8)).astype(np.int32)
    return [
        (a,),
        (a, {"w": a, "b": b}),
        ((a, b), [b, 3, 2.5]),
        ({"z": {"y": a}, "a": [b]},),
        (np.float32(1.5), None, "s"),
    ]


def test_abstract_signature_and_diff_equal_the_reference():
    rng = np.random.RandomState(0)
    for tree in _trees(rng):
        assert profiler.abstract_signature(*tree) == \
            jprofiler.abstract_signature(*tree), tree
    a = np.zeros((4, 8), np.float32)
    b = np.zeros((5, 8), np.float32)
    for old, new in (((a,), (b,)), ((a, {"w": a}), (b, {"w": a, "v": b})),
                     (({"w": a, "v": b},), ({"w": a},))):
        got = profiler.signature_diff(profiler.abstract_signature(*old),
                                      profiler.abstract_signature(*new))
        assert got == jprofiler.signature_diff(
            jprofiler.abstract_signature(*old),
            jprofiler.abstract_signature(*new))
    assert profiler.signature_diff(
        profiler.abstract_signature(a), profiler.abstract_signature(b)) == \
        ["args[0]: float32[4,8] -> float32[5,8]"]
    assert profiler.signature_diff(None, [["args[0]", "int"]]) == []
    # a torch tensor spells as the numpy array of its dtype and shape
    for arr in (a, b.astype(np.int64), np.zeros((3,), np.uint8)):
        assert profiler.abstract_signature(torch.from_numpy(arr)) == \
            jprofiler.abstract_signature(arr)


# -- the trainers with the plane on, in both packages ---------------------------


def _spans(registry_events):
    out = {}
    for e in registry_events:
        if e.get("ph") == "X":
            out[e["name"]] = out.get(e["name"], 0) + 1
    return out


def _depth0(snap):
    return {k for k, v in snap.items() if v["depth"] == 0}


def _mem_gauges(gauges):
    return {k for k in gauges if k.startswith("mem.") and "device" not in k}


def _write_gbdt_text(path, n, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, GBDT_F)
    y = (1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2])
         + rng.randn(n) * 0.5 > 0).astype(int)
    with open(path, "w") as f:
        for i in range(n):
            f.write(f"1###{y[i]}###" + ",".join(
                f"f{j}:{X[i, j]:.6g}" for j in range(GBDT_F)
                if rng.rand() > 0.05) + "\n")


@pytest.fixture(scope="module")
def gbdt_runs(tmp_path_factory):
    """One small int8 GBDT training from the same text in both packages,
    each with its plane on; (events, phases, gauges, wall, rounds) a
    package."""
    tmp = tmp_path_factory.mktemp("prof_gbdt")
    _write_gbdt_text(str(tmp / "train.txt"), GBDT_ROWS, 5)
    _write_gbdt_text(str(tmp / "test.txt"), GBDT_ROWS // 4, 6)
    out = {}
    for who, params, trainer, prof, o, c, kw in (
            ("jax", JParams, JTrainer, jprofiler, jobs, jcore,
             {"engine": "device"}),
            ("port", PParams, PTrainer, profiler, obs, core,
             {"device": "cpu"})):
        cfg = {"data": {"train": {"data_path": str(tmp / "train.txt")},
                        "test": {"data_path": str(tmp / "test.txt")},
                        "max_feature_dim": GBDT_F},
               "model": {"data_path": str(tmp / who / "gbdt.model"),
                         "dump_freq": 0},
               "optimization": {"round_num": GBDT_ROUNDS, "max_depth": 3,
                                "max_leaf_cnt": 7,
                                "tree_grow_policy": "loss"},
               "feature": {"approximate": [
                   {"cols": "default", "type": "sample_by_quantile",
                    "max_cnt": 16}]}}
        o.reset()
        prof.reset_profiler()
        prof.configure_profiler(on=True, mem_interval=0.0)
        try:
            tr = trainer(params.from_config(cfg), hist_precision="int8",
                         **kw)
            t0 = time.perf_counter()
            tr.train()
            wall = time.perf_counter() - t0
            out[who] = (list(o.REGISTRY.events), prof.phases_snapshot(),
                        dict(o.snapshot()["gauges"]), wall,
                        prof.coverage(wall))
        finally:
            _off(prof, o, c)
    return out


def test_gbdt_phases_spans_and_gauges_equal_the_reference(gbdt_runs):
    jev, jph, jg, _jw, jcov = gbdt_runs["jax"]
    pev, pph, pg, _pw, pcov = gbdt_runs["port"]
    assert _depth0(pph) == _depth0(jph) - {"gbdt.compile"}
    assert _depth0(pph) == {"gbdt.load", "gbdt.preprocess", "gbdt.train",
                            "gbdt.finalize"}
    assert pcov >= 0.9 and jcov >= 0.9, (pcov, jcov)
    jsp, psp = _spans(jev), _spans(pev)
    jsp.pop("gbdt.compile")
    assert set(psp) == set(jsp)
    assert psp["gbdt.round"] == jsp["gbdt.round"] == GBDT_ROUNDS
    assert psp["ingest.parse"] == jsp["ingest.parse"] == 2
    assert _mem_gauges(pg) == _mem_gauges(jg)
    assert {"mem.gbdt.load.host_rss_peak_bytes",
            "mem.gbdt.train.host_rss_peak_bytes"} <= _mem_gauges(pg)
    assert "gbdt.stat.train" in pg and "gbdt.stat.train" in jg


@pytest.fixture(scope="module")
def convex_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prof_convex")
    cfg = write_convex_case(str(tmp), "linear", 600, 200, 11, vocab=150,
                            l2=1e-3, max_iter=CONVEX_ITERS)
    cfg["optimization"]["line_search"]["lbfgs"]["convergence"]["eps"] = 1e-12
    out = {}
    for who, params, cls, prof, o, c, kw in (
            ("jax", JCommon, jtrain.HoagTrainer, jprofiler, jobs, jcore, {}),
            ("port", PCommon, ptrain.HoagTrainer, profiler, obs, core,
             {"device": "cpu"})):
        cc = copy.deepcopy(cfg)
        cc["model"]["data_path"] = str(tmp / who / "model")
        o.reset()
        prof.reset_profiler()
        prof.configure_profiler(on=True, mem_interval=0.0)
        try:
            import jax

            with jax.enable_x64(False):
                res = cls(params.from_config(cc), "linear", **kw).train()
            its = [e["dur"] for e in o.REGISTRY.events
                   if e["name"] == "lbfgs.iteration"]
            out[who] = (list(o.REGISTRY.events), prof.phases_snapshot(),
                        dict(o.snapshot()["gauges"]), res.n_iter, sum(its))
        finally:
            _off(prof, o, c)
    return out


def test_convex_phases_and_spans_equal_the_reference(convex_runs):
    jev, jph, jg, jn, jits = convex_runs["jax"]
    pev, pph, pg, pn, pits = convex_runs["port"]
    assert pn == jn == CONVEX_ITERS
    assert _depth0(pph) == _depth0(jph) == {"lbfgs.first_eval",
                                            "lbfgs.iterations"}
    # the iterations phase holds its iterations' spans, in both (the
    # convex run's phases cover the solve, not the ingest and the
    # callbacks around it: its coverage is held on the GBDT run only)
    for ph, its in ((pph, pits), (jph, jits)):
        assert 0 < its <= ph["lbfgs.iterations"]["wall_s"]
        assert ph["lbfgs.iterations"]["count"] == 1
    jsp, psp = _spans(jev), _spans(pev)
    assert set(psp) == set(jsp)
    assert psp["lbfgs.iteration"] == jsp["lbfgs.iteration"] == CONVEX_ITERS
    assert {k: v for k, v in psp.items() if k.startswith("ingest.")} == \
        {k: v for k, v in jsp.items() if k.startswith("ingest.")}
    assert {"ingest.parse", "ingest.dict", "ingest.materialize",
            "train.load", "train.round", "train.evaluate"} <= set(psp)
    assert _mem_gauges(pg) == _mem_gauges(jg)
    assert "mem.train.train.host_rss_peak_bytes" in pg


# -- the ledger and the memory rings --------------------------------------------


def test_ledger_ring_is_bounded(prof_on):
    for _ in range(40):
        profiler.LEDGER.on_compile(0.001)
    assert len(profiler.LEDGER.entries) == 40
    profiler.LEDGER.reset()
    old_entries = profiler.LEDGER.entries
    try:
        profiler.LEDGER.entries = type(old_entries)(maxlen=8)
        for i in range(40):
            profiler.LEDGER.on_compile(0.001, kind="load" if i % 2 else
                                       "build", kernel=f"lib{i}.so")
        assert len(profiler.LEDGER.entries) == 8
        # seq keeps counting across eviction — entries_since stays correct
        assert profiler.LEDGER.entries[-1]["seq"] == 40
        assert profiler.LEDGER.entries_since(35) == list(
            profiler.LEDGER.entries)[-5:]
        snap = profiler.LEDGER.snapshot()
        assert snap["compiles"] == 40 and snap["loads"] == 20
        assert snap["entries"][-1]["kind"] == "load"
        assert snap["entries"][-1]["kernel"] == "lib39.so"
    finally:
        profiler.LEDGER.reset()
        profiler.LEDGER.entries = old_entries


def test_mem_ring_bound_eviction_and_phase_attribution(prof_on):
    profiler.MEM.reset(ring_n=4)
    for i in range(10):
        profiler.MEM.sample_once(now=float(i))
    snap = profiler.MEM.snapshot()
    series = snap["series"]["mem.host_rss_bytes"]  # CPU run: RSS always
    assert len(series) == 4  # bounded: the 6 oldest ticks evicted
    assert [t for t, _ in series] == [6.0, 7.0, 8.0, 9.0]
    assert all(v > 0 for _, v in series)
    assert "<none>" in snap["phase_peaks"]  # outside any phase
    with profiler.phase("mem.probe"):
        with profiler.phase("mem.inner"):
            profiler.MEM.sample_once(now=42.0)
        profiler.MEM.sample_once(now=43.0)
    peaks = profiler.MEM.snapshot()["phase_peaks"]
    assert peaks["mem.probe"]["host_rss_peak_bytes"] > 0
    assert peaks["mem.inner"]["host_rss_peak_bytes"] > 0
    assert obs.snapshot()["gauges"]["mem.sampled.host_rss_bytes"] > 0


# -- the capture parser ---------------------------------------------------------


def test_parser_on_a_real_cpu_capture(prof_on, tmp_path):
    profiler.configure_profiler(capture_dir=str(tmp_path))
    a = torch.randn(64, 64)
    with profiler.phase("probe.capture", capture=True):
        with core.span("probe.inner"):
            for _ in range(3):
                a = torch.mm(a, a).tanh()
    caps = list(tmp_path.glob("probe.capture_*/trace.json"))
    assert len(caps) == 1
    res = profiler.parse_trace_json(str(caps[0]))
    assert not res["device"]
    assert {"probe.capture", "probe.inner"} <= set(res["annotations"])
    # the host ops land in the innermost span and name the kernel rows
    assert res["kernels"]["aten::mm"]["count"] == 3
    assert res["kernels"]["aten::tanh"]["count"] == 3
    assert res["span_device_ms"]["probe.inner"] > 0
    assert 0 < res["device_busy_ms"] <= res["window_ms"]
    rep = profiler.report(wall_s=1.0)
    assert rep["kernels"]["parsed"] == 1
    assert rep["kernels"]["windows"][0]["phase"] == "probe.capture"
    assert {k["name"] for k in rep["kernels"]["top_kernels"]} >= \
        {"aten::mm", "aten::tanh"}


def _torch_doc():
    """A chrome document in torch.profiler's format: a gbdt.train span
    with a gbdt.round inside, two launches of the kernel `hist` in the
    round (three device events the first, one the second: its memset,
    two kernels; a kernel), a `route` launch placed only by its
    correlation id, and torch's own copy outside every annotation."""
    host = {"pid": 1, "tid": 7}
    dev = {"pid": 0, "tid": 7}

    def x(cat, name, ts, dur, where, **args):
        ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
              **where}
        if args:
            ev["args"] = args
        return ev

    return {"traceEvents": [
        x("user_annotation", "gbdt.train", 0, 10_000, host),
        x("user_annotation", "gbdt.round", 1_000, 6_000, host),
        x("user_annotation", "kernel.hist", 1_100, 100, host),
        x("user_annotation", "kernel.hist", 1_300, 100, host),
        x("user_annotation", "kernel.route", 1_500, 100, host),
        x("user_annotation", "ProfilerStep#1", 0, 10_000, host),
        x("cpu_op", "aten::add", 1_050, 10, host),
        x("cuda_runtime", "cudaLaunchKernel", 1_550, 5, host,
          correlation=77),
        x("gpu_user_annotation", "gbdt.train", 2_000, 9_000, dev),
        x("gpu_user_annotation", "gbdt.round", 2_000, 5_000, dev),
        x("gpu_user_annotation", "kernel.hist", 2_000, 1_000, dev),
        x("gpu_user_annotation", "kernel.hist", 3_500, 500, dev),
        x("gpu_memset", "Memset (Device)", 2_000, 100, dev),
        x("kernel", "void tile_kernel<>()", 2_200, 400, dev),
        x("kernel", "void finish_kernel()", 2_700, 200, dev),
        x("kernel", "void tile_kernel<>()", 3_600, 300, dev),
        # launched at ts 1550 inside kernel.route; runs after gbdt.round
        x("kernel", "void route_kernel<>()", 7_500, 250, dev,
          correlation=77),
        x("gpu_memcpy", "Memcpy DtoH", 10_500, 150, dev),
    ]}


def test_parser_on_a_torch_format_device_doc(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(_torch_doc()))
    res = profiler.parse_trace_json(str(path))
    assert res["device"]
    # hand-computed (µs -> ms): hist = 0.1 + 0.4 + 0.2 + 0.3 over two
    # launches; route 0.25, one launch; the copy 0.15 under no kernel
    assert res["kernels"] == {
        "hist": {"ms": 1.0, "count": 2},
        "route": {"ms": 0.25, "count": 1},
        "Memcpy DtoH": {"ms": 0.15, "count": 1},
    }
    # spans: the hist events inside gbdt.round on the device timeline;
    # route by its launch inside gbdt.round on the host; the copy at
    # 10500-10650 lies inside gbdt.train (2000-11000)
    assert res["span_device_ms"] == {"gbdt.round": 1.25, "gbdt.train": 0.15}
    assert res["annotations"] == {"gbdt.train": 10.0, "gbdt.round": 6.0}
    # busy: 2000-2100, 2200-2600, 2700-2900, 3600-3900, 7500-7750,
    # 10500-10650 -> 1.4 ms; the window is the longest span, 10 ms
    assert res["device_busy_ms"] == pytest.approx(1.4)
    assert res["window_ms"] == 10.0


# -- the flight dump ------------------------------------------------------------


def test_flight_dump_carries_prof_block(prof_on, tmp_path):
    with profiler.phase("probe.phase"):
        profiler.MEM.sample_once(now=1.0)
    profiler.LEDGER.on_compile(0.002, kind="build", kernel="libx.so")
    recorder.install(flight_dir=str(tmp_path))
    try:
        path = recorder.dump(reason="test_profiler")
    finally:
        recorder.uninstall()
    with open(path) as f:
        doc = json.load(f)
    prof = doc["flight"]["prof"]
    assert "probe.phase" in prof["phases"]
    assert prof["compile"]["compiles"] == 1
    assert prof["compile"]["entries"][0]["kernel"] == "libx.so"
    assert prof["mem_phase_peaks"]["probe.phase"]["host_rss_peak_bytes"] > 0


def test_flight_dump_prof_block_absent_when_off(tmp_path):
    obs.reset()
    obs.configure(enabled=True)
    try:
        recorder.install(flight_dir=str(tmp_path))
        try:
            path = recorder.dump(reason="test_profiler_off")
        finally:
            recorder.uninstall()
        with open(path) as f:
            doc = json.load(f)
        assert "prof" not in doc["flight"]
    finally:
        obs.configure(enabled=False)
        obs.reset()


# -- the build watcher and the retrace sentinel ---------------------------------


class _Wrapper:
    launches = 0


def test_planted_instantiation_names_its_culprit(prof_on):
    """Arm the sentinel, then plant a new kernel instantiation through the
    shared launch counter under a ledger label: health.retrace fires with
    the signature diff and the ledger culprit naming the program and the
    instantiation; a repeat of the instantiation counts no build."""
    health.install_trace_counters()
    x1 = torch.zeros((4, 8))
    x2 = torch.zeros((5, 8))
    sent = health.RetraceSentinel("toy")
    sent.arm(sig=profiler.abstract_signature(x1))
    assert sent.check(sig=profiler.abstract_signature(x1))  # steady state
    w = _Wrapper()
    with profiler.LEDGER.program(
            "toy.step", sig_fn=lambda: profiler.abstract_signature(x2)):
        with cuda_build.launching(w, "toy_kernel", "red", 4):
            pass
        with cuda_build.launching(w, "toy_kernel", "red", 4):
            pass  # the same instantiation: no second build
    assert w.launches == 2
    assert obs.snapshot()["counters"]["compile.traces.backend_compile"] == 1
    assert not sent.check(sig=profiler.abstract_signature(x2), round=7)
    evs = [e for e in obs.REGISTRY.events if e["name"] == "health.retrace"]
    assert len(evs) == 1
    args = evs[0]["args"]
    assert args["changed"] == ["args[0]: float32[4,8] -> float32[5,8]"]
    assert args["culprits"] == [
        {"program": "toy.step", "kernel": "toy_kernel[red,4]",
         "ms": args["culprits"][0]["ms"]}]
    assert obs.snapshot()["counters"]["compile.retraces.unexpected"] == 1
    # a failed launch counts nothing
    with pytest.raises(RuntimeError):
        with cuda_build.launching(w, "toy_kernel", "tile", 1):
            raise RuntimeError("launch failed")
    assert w.launches == 2
    assert sent.check(round=8)


def test_loads_are_cache_hits_not_builds(prof_on):
    health.install_trace_counters()
    sent = health.RetraceSentinel("toy")
    sent.arm()
    health.note_compile("load", "libytk_x.so", 0.001)
    c = obs.snapshot()["counters"]
    assert c["compile.traces.cache_hits"] == 1
    assert "compile.traces.backend_compile" not in c
    assert sent.check()  # a load is no retrace
    led = profiler.LEDGER.snapshot()
    assert led["loads"] == 1 and led["entries"][0]["kind"] == "load"


# -- /metrics?prof=1 of both ServeApps ------------------------------------------


def test_serve_prof_block_equals_the_reference(both_on, tmp_path):
    build_gbdt(tmp_path, n_trees=5, depth=3, seed=4)
    cfg = {"model": {"data_path": str(tmp_path / "gbdt.model")},
           "optimization": {"loss_function": "sigmoid"}}
    os.environ["YTK_SERVE_FUSED"] = "1"
    try:
        reg = ModelRegistry(ladder=LADDER, device="cpu", watch_interval_s=0)
        reg.load("default", "gbdt", cfg)
    finally:
        os.environ.pop("YTK_SERVE_FUSED")
    jreg = JRegistry(ladder=LADDER, watch_interval_s=0)
    jreg.load("default", "gbdt", cfg)
    app = ServeApp(reg, BatchPolicy(max_batch=32, max_wait_ms=0.2))
    japp = JApp(jreg, JPolicy(max_batch=32, max_wait_ms=0.2))
    rng = np.random.RandomState(3)
    pool = request_rows(96, rng)
    sent = 0
    try:
        for n in (1, 3, 4, 9, 30, 32, 2):
            rows = pool[sent:sent + n]
            out = app.predict(rows, timeout=60.0)
            jout = japp.predict(rows, timeout=60.0)
            np.testing.assert_array_equal(out["scores"], jout["scores"])
            sent += n
        m = app.metrics_payload(prof=True, models=True)
        jm = japp.metrics_payload(prof=True, models=True)
    finally:
        for a in (app, japp):
            for b in a._batchers.values():
                b.close(drain=True)
        reg.close()
        jreg.close()
    p, jp = m["prof"], jm["prof"]
    assert set(p) == set(jp) and p["enabled"] and jp["enabled"]
    assert set(p["models"]) == set(jp["models"]) == {"default"}
    blk, jblk = p["models"]["default"], jp["models"]["default"]
    assert set(blk) == set(jblk)

    def rows_of(b):
        return {r: v["rows"] for r, v in b["rungs"].items()}

    assert rows_of(blk) == rows_of(jblk) == {"4": 10, "32": 71}
    assert sum(rows_of(blk).values()) == sent
    for r, v in blk["rungs"].items():
        assert set(v) == set(jblk["rungs"][r])
        assert v["calls"] == jblk["rungs"][r]["calls"]
    assert set(p["compile"]) == set(jp["compile"])
    # model_metrics carries each model's prof entry while the plane is on
    mb = m["model_metrics"]["models"]
    jmb = jm["model_metrics"]["models"]
    assert set(mb) == set(jmb)
    with_prof = {k for k in mb if "prof" in mb[k]}
    assert with_prof == {k for k in jmb if "prof" in jmb[k]} and with_prof
    for k in with_prof:
        assert rows_of(mb[k]["prof"]) == rows_of(jmb[k]["prof"])


# -- YTK_PROFILE_DIR and the report ---------------------------------------------


@pytest.mark.parametrize("case", ["rounds", "preempted", "skipped"])
def test_profile_dir_traces_the_rounds(tmp_path, monkeypatch, case):
    """YTK_PROFILE_DIR writes a torch.profiler trace of the device
    engine's rounds, and at a preemption too (the process's profiler slot
    released); while the plane's own capture of gbdt.train holds the
    profiler it is skipped and counted."""
    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.resilience import reset_chaos

    _write_gbdt_text(str(tmp_path / "g.train"), 300, 9)
    conf = tmp_path / "g.conf"
    conf.write_text(
        f'data {{ train {{ data_path = "{tmp_path / "g.train"}" }} '
        f"max_feature_dim = {GBDT_F} }}\n"
        f'model {{ data_path = "{tmp_path / "g.model"}", dump_freq = 1 }}\n'
        "optimization { round_num = 3, max_depth = 3 }\n")
    trace_dir = tmp_path / "rounds"
    monkeypatch.setenv("YTK_PROFILE_DIR", str(trace_dir))
    argv = ["train", "gbdt", str(conf), "--device", "cpu"]
    if case == "preempted":
        monkeypatch.setenv("YTK_CHAOS", "gbdt.sync:sigterm:1:0")
    if case == "skipped":
        argv += ["--profile", str(tmp_path / "prof")]
    try:
        rc = cli.main(argv)
        skipped = obs.snapshot()["counters"].get("prof.capture.skipped")
    finally:
        reset_chaos()
        _off(profiler, obs, core)
    assert rc == (143 if case == "preempted" else 0)
    assert not profiler._capture_active.locked()  # the slot is free again
    if case == "skipped":
        assert skipped == 1 and not trace_dir.exists()
        assert list((tmp_path / "prof").glob("gbdt.train_*/trace.json"))
        return
    res = profiler.parse_trace_json(str(trace_dir / "trace.json"))
    assert not res["device"] and res["kernels"]


def test_report_schema_and_format(prof_on):
    with profiler.phase("fmt.phase"):
        pass
    profiler.LEDGER.on_compile(0.001, kind="instantiate", kernel="k[1]")
    rep = profiler.report(wall_s=1.0)
    assert rep["schema"] == "ytkprof" and rep["enabled"]
    assert "fmt.phase" in rep["phases"]
    assert 0.0 <= rep["phase_coverage"] <= 1.0
    text = profiler.format_report(rep)
    assert "fmt.phase" in text and "coverage" in text and "k[1]" in text
    json.dumps(rep)  # JSON-ready end to end
