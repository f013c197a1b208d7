"""The port's obs planes (ytklearn_tpu_torch/obs) and the serving fleet's
AIMD controller, cache and Retry-After against the JAX package's, on the
CPU.

Every comparison is exact: the same inputs (made from a seed with numpy)
must give the same AIMD `max_batch` trajectory, the same sentinel fires
and counters, the same Retry-After seconds, the same cache keys and LRU
eviction order, and the same head-sampled trace set.
"""

import json
import os
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import obs as jobs
from ytklearn_tpu.obs import health as jhealth
from ytklearn_tpu.obs import model_metrics as jmm
from ytklearn_tpu.obs import trace as jtrace
from ytklearn_tpu.serve import batcher as jbatcher
from ytklearn_tpu.serve.fleet import aimd as jaimd
from ytklearn_tpu.serve.fleet import cache as jcache
from ytklearn_tpu.serve.fleet import front as jfront
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.obs import export, health, model_metrics
from ytklearn_tpu_torch.obs.heartbeat import (
    Heartbeat,
    start_history_sampler,
    stop_history_sampler,
)
from ytklearn_tpu_torch.obs import recorder, trace
from ytklearn_tpu_torch.serve import batcher
from ytklearn_tpu_torch.serve.fleet import aimd, cache, front

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def both_obs():
    """Obs collection on in both packages, fresh registries; restored."""
    was = (obs.enabled(), jobs.enabled())
    obs.configure(enabled=True)
    jobs.configure(enabled=True)
    obs.reset()
    jobs.reset()
    yield
    obs.reset()
    jobs.reset()
    obs.configure(enabled=was[0])
    jobs.configure(enabled=was[1])


def _counters(mod):
    return mod.snapshot()["counters"]


# -- AIMD ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,ladder,window", [
    (0, (1, 8, 64, 512), 16), (1, (1, 8, 64, 512), 1), (2, (4, 32), 4),
    (3, (16,), 2), (4, (1, 2, 4, 8, 16, 32, 64, 128, 256, 512), 8),
])
def test_aimd_trajectory_equals_the_reference(both_obs, seed, ladder,
                                              window):
    rng = np.random.RandomState(seed)
    c = aimd.AIMDController(ladder, slo_ms=100.0, inc=8, backoff=0.5,
                            window=window)
    j = jaimd.AIMDController(ladder, slo_ms=100.0, inc=8, backoff=0.5,
                             window=window)
    got, want = [c.max_batch], [j.max_batch]
    for _batch in range(400):
        n = rng.randint(1, 9)
        lats = rng.gamma(2.0, 40.0, size=n) * (1 + (rng.rand() < 0.1) * 3)
        for v in lats:
            c.observe(float(v))
            j.observe(float(v))
        c.note_batch()
        j.note_batch()
        got.append(c.max_batch)
        want.append(j.max_batch)
        assert c.snapshot() == j.snapshot()
    assert got == want
    # the trajectory really moves where the ladder leaves room to
    assert len(set(got)) > 1 or len(ladder) < 3
    keys = ("serve.aimd.backoff", "serve.aimd.increase")
    assert {k: _counters(obs).get(k) for k in keys} == \
        {k: _counters(jobs).get(k) for k in keys}


def test_maybe_controller_follows_the_slo_knob():
    with mock.patch.dict(os.environ, {"YTK_SERVE_SLO_MS": "0"}):
        assert aimd.maybe_controller((1, 8)) is None
        assert jaimd.maybe_controller((1, 8)) is None
    c = aimd.maybe_controller((1, 8, 64))
    assert c.slo_ms == 100.0 and c.max_batch == 8  # the knob's default
    with pytest.raises(ValueError):
        aimd.AIMDController((1, 8), slo_ms=10, backoff=1.5)


# -- sentinels -----------------------------------------------------------------


@pytest.mark.parametrize("seed,window,budget", [
    (0, 16, 0.1), (1, 1, 0.0), (2, 7, 0.25), (3, 256, 0.1),
])
def test_slo_burn_sentinel_fires_as_the_reference(both_obs, seed, window,
                                                  budget):
    rng = np.random.RandomState(seed)
    s = health.SLOBurnSentinel("serve.predict", 50.0, window=window,
                               budget=budget)
    j = jhealth.SLOBurnSentinel("serve.predict", 50.0, window=window,
                                budget=budget)
    for _ in range(600):
        if rng.rand() < 0.05:
            assert s.observe(violated=True) == j.observe(violated=True)
        else:
            v = float(rng.gamma(2.0, 20.0))
            assert s.observe(v) == j.observe(v)
    assert s.windows_fired == j.windows_fired
    assert s.windows_fired > 0 or budget >= 0.25
    pick = {k: v for k, v in _counters(obs).items()
            if k.startswith("health.")}
    assert pick == {k: v for k, v in _counters(jobs).items()
                    if k.startswith("health.")}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_drift_and_calibration_sentinels_as_the_reference(both_obs, seed):
    rng = np.random.RandomState(seed)
    d = health.DriftSentinel("serve.quality", 0.25, 0.35, 2, 200)
    jd = jhealth.DriftSentinel("serve.quality", 0.25, 0.35, 2, 200)
    c = health.CalibrationSentinel("serve.quality", 0.1, 2, 200)
    jc = jhealth.CalibrationSentinel("serve.quality", 0.1, 2, 200)
    for _ in range(200):
        psi = float(rng.rand() * 0.5) if rng.rand() < 0.9 else None
        ks = float(rng.rand() * 0.6)
        rows = int(rng.randint(0, 1000))
        delta = float(rng.rand() * 0.2) if rng.rand() < 0.9 else None
        assert d.observe(psi, ks, rows) == jd.observe(psi, ks, rows)
        assert c.observe(delta, rows) == jc.observe(delta, rows)
    assert (d.fired, c.fired) == (jd.fired, jc.fired) and d.fired > 0
    assert health.root_health_counters(_counters(obs)) == \
        jhealth.root_health_counters(_counters(jobs))


_STRICT_CASES = {
    "slo_burn": (lambda h: h.SLOBurnSentinel("serve.predict", 50.0,
                                             window=4, budget=0.0),
                 lambda s, i: s.observe(80.0 + i)),
    "drift": (lambda h: h.DriftSentinel("serve.quality", 0.25, 0.35, 2, 200),
              lambda s, i: s.observe(0.5 + 0.01 * i, 0.1, 500)),
    "calibration": (lambda h: h.CalibrationSentinel("serve.quality", 0.1, 2,
                                                    200),
                    lambda s, i: s.observe(0.3, 500)),
}


@pytest.mark.parametrize("kind", sorted(_STRICT_CASES))
def test_strict_mode_escalates_a_serving_sentinel_as_the_reference(
        both_obs, tmp_path, kind):
    make, feed = _STRICT_CASES[kind]
    hits = []
    with mock.patch.dict(os.environ, {"YTK_HEALTH_STRICT": "1",
                                      "YTK_FLIGHT_DIR": str(tmp_path)}):
        for h in (health, jhealth):
            s = make(h)
            for i in range(12):
                try:
                    feed(s, i)
                except h.HealthError as e:
                    hits.append((i, str(e).split(" (flight dump")[0]))
                    break
    assert len(hits) == 2 and hits[0] == hits[1], hits
    assert hits[0][1].startswith(f"health.{kind} at serve.")
    assert _counters(obs) == _counters(jobs)


def test_record_memory_gauges_on_the_cpu(both_obs):
    health.record_memory("phase")
    g = obs.snapshot()["gauges"]
    assert g["mem.phase.host_rss_peak_bytes"] > 0
    assert "mem.phase.device_peak_bytes" not in g  # no CUDA device here


# -- Retry-After ---------------------------------------------------------------


@pytest.mark.parametrize("backlog", [0, 1, 7, 64, 513, 4096, 10 ** 6])
@pytest.mark.parametrize("rate", [0.0, 3.0, 100.0, 5000.0, 2e6])
def test_retry_after_equals_the_reference(backlog, rate):
    now = 1_700_000_000.0
    w, jw = batcher.ScoredRateWindow(), jbatcher.ScoredRateWindow()
    if rate:
        # ten samples over the last second carrying `rate` rows/s
        for k in range(10):
            t = now - 1.0 + 0.1 * k
            w._ring.append((t, int(rate / 10)))
            jw._ring.append((t, int(rate / 10)))
    with mock.patch.object(batcher.time, "time", return_value=now), \
            mock.patch.object(jbatcher.time, "time", return_value=now):
        got = batcher.retry_after_s(backlog, w)
        want = jbatcher.retry_after_s(backlog, jw)
    assert got == want
    assert 1 <= got <= batcher.RETRY_AFTER_MAX_S


# -- the prediction cache ------------------------------------------------------


class _E:
    def __init__(self, fp, v):
        self.fingerprint, self.version = fp, v


def test_cache_keys_and_lru_order_equal_the_reference(both_obs):
    rng = np.random.RandomState(7)
    pool = [{f"c{i}": float(np.round(rng.randn(), 2))
             for i in range(rng.randint(1, 4))} for _ in range(40)]
    for row in pool:
        shuffled = dict(reversed(list(row.items())))
        assert cache.row_key(row) == jcache.row_key(row) == \
            cache.row_key(shuffled)
    c, j = cache.PredictionCache(24), jcache.PredictionCache(24)
    entries = [_E("fa", 1), _E("fa", 2), _E("fb", 1)]
    for _ in range(300):
        e = entries[rng.randint(3)]
        rows = [pool[k] for k in rng.randint(0, len(pool),
                                             rng.randint(1, 4))]
        scope = "m" if rng.rand() < 0.5 else "n"
        if rng.rand() < 0.5:
            a = c.lookup(c.model_key(e), rows, scope=scope)
            b = j.lookup(j.model_key(e), rows, scope=scope)
            assert a == b
        else:
            s = rng.randn(len(rows))
            c.store(c.model_key(e), rows, s, s * 2, scope=scope)
            j.store(j.model_key(e), rows, s, s * 2, scope=scope)
        assert list(c._lru) == list(j._lru)
    assert c.scope_rows() == j.scope_rows() and len(c) == 24
    assert _counters(obs) == _counters(jobs)
    assert cache.maybe_cache(0) is None and cache.maybe_cache() is None


# -- request tracing -----------------------------------------------------------


@pytest.fixture
def tracing():
    """Both packages' samplers are process-wide: put them back as found."""
    saved = [(t, t._state.rate, t._state.seed, t._state.slo_ms)
             for t in (trace, jtrace)]
    yield
    for t, rate, seed, slo in saved:
        t.configure_tracing(sample=rate, seed=seed, reset=True)
        t._state.slo_ms = slo


@pytest.mark.parametrize("rate,seed", [(0.01, 0), (0.05, 7), (0.5, 123),
                                       (1.0, 3)])
def test_trace_head_sampler_keeps_the_reference_set(tracing, rate, seed):
    trace.configure_tracing(sample=rate, seed=seed, reset=True)
    jtrace.configure_tracing(sample=rate, seed=seed, reset=True)
    got = [i for i in range(1, 3001) if trace.begin().ids]
    want = [i for i in range(1, 3001) if jtrace.begin().ids]
    assert got == want
    assert got == [n for n in range(1, 3001) if trace.head_keep(seed, n)]
    assert abs(len(got) / 3000 - rate) < 0.02 + rate * 0.2


def test_trace_exemplars_and_tail_rule(tracing):
    trace.configure_tracing(sample=1.0, seed=1, slo_ms=10.0, reset=True)
    ctx = trace.begin()
    ctx.hop_at("serve.parse", time.perf_counter(), time.perf_counter())
    trace.set_current_batch([ctx])
    with trace.batch_hop("serve.execute", rung=8):
        pass
    trace.end_current_batch()
    rec = trace.finish(ctx, status=200, latency_ms=1.0, rows=3)
    assert rec["kept"] == "head"
    assert [h["name"] for h in rec["hops"]] == ["serve.parse",
                                                "serve.execute"]
    trace.configure_tracing(sample=1e-9, reset=True)
    assert trace.finish(trace.NOOP_TRACE, status=200, latency_ms=1) is None
    assert trace.finish(trace.NOOP_TRACE, status=429)["kept"] == "tail_shed"
    assert trace.finish(trace.NOOP_TRACE, status=200,
                        latency_ms=50)["kept"] == "tail_slo"
    doc = trace.exemplars_payload()
    assert doc["schema"] == "ytk_traces" and len(doc["exemplars"]) == 2
    merged = export.exemplar_trace_events([doc])
    assert merged[0]["ph"] == "M" and len(merged) == 3
    adopted = trace.begin("a-1,b-2")
    assert adopted.kept == "adopted" and adopted.ids == ("a-1", "b-2")


# -- core, export, recorder, heartbeat -----------------------------------------


def test_spans_counters_and_the_chrome_and_jsonl_exports(both_obs,
                                                         tmp_path):
    x = torch.arange(6.0)
    with obs.span("outer", k=1):
        with obs.span("inner", settle=lambda: x):
            obs.inc("c", 2.0)
        obs.gauge("g", 3.5)
        obs.event("mark", a=1)
    assert obs.snapshot() == {"counters": {"c": 2.0}, "gauges": {"g": 3.5}}
    ev = obs.REGISTRY.events
    assert [e["name"] for e in ev][:3] == ["inner", "mark", "outer"]
    assert ev[0]["depth"] == 1 and ev[2]["depth"] == 0
    path = export.export_chrome_trace(str(tmp_path / "t.json"))
    doc = json.load(open(path))
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all("ts" in e and "dur" in e for e in xs)
    jl = export.export_jsonl(str(tmp_path / "t.jsonl"))
    back = export.load_jsonl(jl)
    assert back["counters"]["c"] == 2.0 and back["gauges"] == {"g": 3.5}
    assert len(back["events"]) == len(ev)


def test_disabled_path_records_nothing():
    was = obs.enabled()
    obs.configure(enabled=False)
    try:
        obs.reset()
        assert obs.span("x") is obs.NOOP_SPAN
        obs.inc("c")
        obs.event("e")
        assert obs.snapshot() == {"counters": {}, "gauges": {}}
    finally:
        obs.configure(enabled=was)


def test_history_sampler_and_heartbeat(both_obs):
    obs.inc("serve.requests", 3)
    assert start_history_sampler(interval_s=0.02, ring_n=4)
    try:
        time.sleep(0.15)
        snap = obs.REGISTRY.history_snapshot()
        assert snap["ring_n"] == 4
        assert 1 <= len(snap["series"]["serve.requests"]) <= 4
    finally:
        stop_history_sampler()
    assert obs.REGISTRY.history_snapshot() is None
    hb = Heartbeat("ingest", every_s=3600)
    assert hb.beat(rows=10) and not hb.beat(rows=20)
    assert _counters(obs)["heartbeat.ingest"] == 1.0


def test_recorder_thread_guard_and_dump(both_obs, tmp_path):
    @recorder.thread_guard
    def dies():
        raise ValueError("boom")

    with pytest.raises(ValueError):
        dies()
    assert any(e["name"] == "thread.died" for e in obs.REGISTRY.events)
    recorder.install(ring_n=16, flight_dir=str(tmp_path))
    try:
        obs.event("before.dump")
        path = recorder.dump("manual")
        fl = recorder.load_flight(path)
        assert fl["reason"] == "manual"
        assert fl["runtime"]["torch"] == torch.__version__
        assert fl["runtime"]["device_count"] == 0
        assert any(e["name"] == "before.dump" for e in fl["ring"])
        assert fl["traceEvents"]
    finally:
        recorder.uninstall()
        recorder._state.dir = None
    assert not recorder.installed()


@pytest.mark.parametrize("seed", [0, 1])
def test_model_metrics_as_the_reference(both_obs, seed):
    rng = np.random.RandomState(seed)
    m = model_metrics.ModelMetrics(slo_ms=20.0, max_models=2,
                                   burn_window=8, burn_budget=0.1)
    j = jmm.ModelMetrics(slo_ms=20.0, max_models=2, burn_window=8,
                         burn_budget=0.1)
    for name in ("a", "b", "c", "__overflow__", ""):
        assert m.register(name) == j.register(name)
    for _ in range(300):
        name = ["a", "b", "c", "zz", None][rng.randint(5)]
        r = rng.rand()
        if r < 0.8:
            ms = float(rng.gamma(2.0, 10.0))
            m.record_request(name, 3, ms)
            j.record_request(name, 3, ms)
        elif r < 0.9:
            m.record_violation(name, 429)
            j.record_violation(name, 429)
        else:
            m.record_not_found(name)
            j.record_not_found(name)
    a, b = m.snapshot(), j.snapshot()
    for fam in (a, b):
        for blk in fam["models"].values():
            blk["latency"].pop("count", None)
    assert a == b
    assert _counters(obs) == _counters(jobs)


def test_latency_helpers_equal_the_reference():
    rng = np.random.RandomState(3)
    vals = list(rng.gamma(2.0, 5.0, 777))
    assert front.latency_percentiles(vals) == \
        jfront.latency_percentiles(vals)
    assert front.latency_percentiles([]) == {"count": 0}
    raw = [[100.0 - k, float(k)] for k in range(100)] + [7.5]
    assert front.window_ring_ms(raw, 100.0, 30.0) == \
        jfront.window_ring_ms(raw, 100.0, 30.0)


@pytest.mark.parametrize("env,match", [
    ({"YTK_OBS_JAX": "1"}, "YTK_OBS_JAX"),
    ({"YTK_PROF": "1"}, "YTK_PROF"),
])
def test_unported_obs_knobs_raise(env, match):
    """YTK_OBS_JAX has no counterpart and raises. YTK_PROF, refused until
    ROADMAP.md 1.12, now arms the profiling plane: the app starts, and
    its `/metrics?prof=1` block says so, with the ledger and phases."""
    code = ("import json, ytklearn_tpu_torch.obs as o, "
            "ytklearn_tpu_torch.serve as s; "
            "a = s.ServeApp(s.ModelRegistry(device='cpu')); "
            "print(json.dumps(a.metrics_payload(prof=True)['prof']))")
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_"))}
    full.update(env, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=full,
                         capture_output=True, text=True, timeout=120)
    if match == "YTK_PROF":
        assert out.returncode == 0, out.stderr
        prof = json.loads(out.stdout.strip().splitlines()[-1])
        assert prof["enabled"] is True
        assert set(prof) == {"enabled", "models", "compile", "phases"}
        assert prof["compile"]["compiles"] == 0
        return
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr and match in out.stderr
