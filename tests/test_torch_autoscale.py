"""The port's fleet autoscaler (serve/fleet/autoscaler.py) and the fleet's
quality merge (obs/quality.py::merge_quality_payloads) against the JAX
package's, on the CPU.

AutoscalePolicy is pure (an injectable clock, no threads): both packages'
policies are fed the same hypothesis-made ScaleSignals sequences and must
return the same decisions, reasons, streaks and cooldowns at every tick.
merge_quality_payloads must give the same fleet drift view from the same
replica payloads (GK summaries of seeded data).

One live ramp: a port front over tests/fleet_stub_worker.py grows 1 -> 2
under backlog and drains back to 1 when idle, with no request lost. Its
autoscaler ticks are stepped by the test (`FleetAutoscaler.tick`, the
production decision path), and every wait is for a state, with deadlines
far beyond what a loaded machine needs, so the test does not race a
wall-clock window.
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from ytklearn_tpu.obs import quality as jquality
from ytklearn_tpu.serve.fleet import autoscaler as jauto
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.gbdt.quantile_sketch import WeightedQuantileSketch
from ytklearn_tpu_torch.obs import quality
from ytklearn_tpu_torch.serve import BatchPolicy, FleetFront
from ytklearn_tpu_torch.serve.fleet import autoscaler as pauto

STUB = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "fleet_stub_worker.py")
PARAMS = dict(up_backlog=100.0, down_backlog=10.0, up_windows=3,
              down_windows=5, up_cooldown_s=5.0, down_cooldown_s=10.0)


@pytest.fixture()
def obs_on():
    was = obs.enabled()
    obs.configure(enabled=True)
    obs.reset()
    yield
    obs.reset()
    obs.configure(enabled=was)


# -- the policy ----------------------------------------------------------------

_signal = st.fixed_dictionaries({
    "backlog_rows": st.one_of(st.integers(0, 20),
                              st.integers(0, 2000)),
    "ready": st.integers(0, 5),
    "extra_slots": st.integers(0, 2),
    "unsettled": st.sampled_from([0, 0, 0, 1]),
    "shed": st.sampled_from([0.0, 0.0, 0.0, 3.0]),
    "p99_ms": st.one_of(st.just(0.0), st.floats(0.0, 300.0)),
    "slo_burn": st.sampled_from([0.0, 0.0, 0.0, 1.0]),
    "dt": st.sampled_from([0.0, 0.5, 1.0, 1.0, 1.0, 4.0, 11.0]),
})


def _signals(mod, d):
    return mod.ScaleSignals(
        backlog_rows=d["backlog_rows"], ready=d["ready"],
        slots=d["ready"] + d["extra_slots"], unsettled=d["unsettled"],
        shed=d["shed"], p99_ms=d["p99_ms"], slo_burn=d["slo_burn"])


@settings(max_examples=150, deadline=None)
@given(steps=st.lists(_signal, min_size=1, max_size=60),
       band=st.sampled_from([(1, 1), (1, 2), (1, 4), (2, 3)]),
       slo=st.sampled_from([None, 0.0, 50.0]),
       windows=st.sampled_from([(1, 1), (2, 3), (3, 5)]))
def test_policy_decisions_equal_the_reference(steps, band, slo, windows):
    kw = dict(PARAMS, up_windows=windows[0], down_windows=windows[1])
    ours = pauto.AutoscalePolicy(band[0], band[1], slo_ms=slo, **kw)
    theirs = jauto.AutoscalePolicy(band[0], band[1], slo_ms=slo, **kw)
    now = 100.0
    for d in steps:
        now += d["dt"]
        a = ours.decide(_signals(pauto, d), now=now)
        b = theirs.decide(_signals(jauto, d), now=now)
        assert (a.action, a.want, a.reason) == (b.action, b.want, b.reason)
        assert ours.snapshot(now) == theirs.snapshot(now)


def test_policy_hysteresis_cooldowns_and_bounds_as_the_reference():
    """A scripted timeline through every rule: windows, the band between
    the thresholds, the silent cooldown, the pushed-out down cooldown, the
    defer while a slot heals and the blocked decision at each bound."""
    script = [
        # (backlog, ready, slots, unsettled, shed, p99, burn, now)
        (500, 1, 1, 0, 0, 0, 0, 0.0), (500, 1, 1, 0, 0, 0, 0, 1.0),
        (50, 1, 1, 0, 0, 0, 0, 2.0), (500, 1, 1, 0, 0, 0, 0, 3.0),
        (500, 1, 1, 0, 0, 0, 0, 4.0), (500, 1, 1, 0, 0, 0, 0, 5.0),
        (900, 2, 2, 0, 0, 0, 0, 6.0), (900, 2, 2, 0, 0, 0, 0, 7.0),
        (900, 2, 2, 0, 0, 0, 0, 8.0), (900, 2, 3, 1, 0, 0, 0, 11.0),
        (0, 2, 2, 0, 2, 0, 0, 12.0), (0, 2, 2, 0, 0, 0, 1, 13.0),
        (0, 2, 2, 0, 0, 90, 0, 14.0), (0, 2, 2, 0, 0, 10, 0, 15.0),
    ] + [(0, 2, 2, 0, 0, 0, 0, 16.0 + i) for i in range(12)] + [
        (0, 1, 1, 0, 0, 0, 0, 40.0 + i) for i in range(6)] + [
        (900, 4, 4, 0, 0, 0, 0, 60.0 + i) for i in range(4)]
    out = []
    for mod in (pauto, jauto):
        p = mod.AutoscalePolicy(1, 4, slo_ms=50.0, **PARAMS)
        rec = []
        for b, r, s, u, sh, p99, burn, now in script:
            d = p.decide(mod.ScaleSignals(b, r, s, u, sh, p99, burn), now)
            rec.append((d.action, d.want, p.snapshot(now)))
        out.append(rec)
    assert out[0] == out[1]
    actions = [a for a, _w, _s in out[0]]
    assert {"up", "down", "deferred", "blocked"} <= set(actions)


@pytest.mark.parametrize("kw,match", [
    ({"min_replicas": 0, "max_replicas": 2}, "replicas-min"),
    ({"min_replicas": 3, "max_replicas": 2}, "replicas-max"),
    ({"min_replicas": 1, "max_replicas": 2, "up_backlog": 5.0,
      "down_backlog": 5.0}, "hysteresis"),
])
def test_policy_refuses_what_the_reference_refuses(kw, match):
    for mod in (pauto, jauto):
        with pytest.raises(ValueError, match=match):
            mod.AutoscalePolicy(**kw)


def test_policy_defaults_are_the_reference_knobs(monkeypatch):
    monkeypatch.setenv("YTK_SERVE_SCALE_UP_WINDOWS", "4")
    monkeypatch.setenv("YTK_SERVE_SCALE_DOWN_COOLDOWN_S", "7.5")
    a = pauto.AutoscalePolicy(1, 3).snapshot(0.0)
    b = jauto.AutoscalePolicy(1, 3).snapshot(0.0)
    assert a == b and a["up_windows"] == 4
    monkeypatch.delenv("YTK_SERVE_SCALE_UP_WINDOWS")
    assert pauto.AutoscalePolicy(1, 3).snapshot(0.0) == \
        jauto.AutoscalePolicy(1, 3).snapshot(0.0)


def test_maybe_autoscaler_disarmed_on_a_fixed_fleet():
    for mod in (pauto, jauto):
        assert mod.maybe_autoscaler(object(), 2, 2) is None
        a = mod.maybe_autoscaler(object(), 1, 3,
                                 params={"interval_s": 0.5,
                                         "up_windows": 2})
        assert a.interval_s == 0.5 and a.policy.up_windows == 2


# -- the fleet's quality merge -------------------------------------------------


def _sketch_json(mod, values, b):
    sk = WeightedQuantileSketch(b=b)
    sk.push(np.asarray(values, np.float64))
    return mod.summary_to_json(sk.summary())


def _payloads(mod, seed, n_replicas, shift, b=64):
    """Replica `/metrics?quality=1` payloads: one model key served with a
    baseline by most replicas, without one by the first, and a second key
    with no baseline anywhere."""
    rng = np.random.RandomState(seed)
    base = {f: rng.randn(400) for f in ("f0", "f1")}
    base_score = rng.rand(400)
    out = {}
    for r in range(n_replicas):
        serve = {f: rng.randn(120) + shift * (f == "f1") for f in base}
        score = np.clip(rng.rand(120) + 0.1 * shift, 0, 1)
        with_base = r > 0 or n_replicas == 1
        m = {"model": "default", "version": 1,
             "rows_seen": int(rng.randint(100, 200)), "rows_sampled": 120,
             "no_baseline": not with_base,
             "psi_max": 0.1, "ks_max": 0.2}
        if with_base:
            m.update(
                sketches={f: _sketch_json(mod, v, b) for f, v in serve.items()},
                baseline={f: _sketch_json(mod, v, b) for f, v in base.items()},
                baseline_score=_sketch_json(mod, base_score, b),
                baseline_score_mean=float(base_score.mean()),
                score_sketch=_sketch_json(mod, score, b),
                score_sum=float(score.sum()), score_n=len(score))
        out[str(r)] = {"models": {
            "default@1": m,
            "other@3": {"model": "other", "version": 3, "rows_seen": 5,
                        "rows_sampled": 1, "no_baseline": True},
        }}
    return out


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10_000), n=st.integers(1, 4),
       shift=st.sampled_from([0.0, 0.5, 2.0]), b=st.sampled_from([16, 64]))
def test_merge_quality_payloads_equals_the_reference(seed, n, shift, b):
    ours = quality.merge_quality_payloads(_payloads(quality, seed, n, shift,
                                                    b))
    theirs = jquality.merge_quality_payloads(_payloads(jquality, seed, n,
                                                       shift, b))
    assert ours == theirs
    assert ours["fleet"]["other@3"]["no_baseline"] is True
    assert "psi_max" in ours["fleet"]["default@1"]


def test_merge_quality_payloads_ignores_replica_order():
    p = _payloads(quality, 3, 3, 0.5)
    flipped = {str(2 - int(k)): v for k, v in p.items()}
    a = quality.merge_quality_payloads(p)["fleet"]
    b = quality.merge_quality_payloads(flipped)["fleet"]
    assert a["default@1"]["features"] == b["default@1"]["features"]


# -- one live ramp over the stub ----------------------------------------------


def _wait_for(cond, timeout=90.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return cond()


def _tick_until(front, action, timeout=90.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if front.autoscaler.tick().action == action:
            return True
        time.sleep(0.02)
    return False


def test_fleet_grows_under_backlog_and_drains_back_to_the_floor(obs_on):
    """1 -> 2 under 16 clients on a 20 ms stub, then back to 1 once idle,
    drain-based; every response arrives and is right. The control thread
    is armed with an hour's interval, so only the test's ticks decide."""
    front = FleetFront(
        [sys.executable, STUB, "--weight", "2.0", "--delay-ms", "20"], 1,
        policy=BatchPolicy(max_batch=64, max_wait_ms=0.5, max_queue=4096),
        ready_timeout_s=90.0, monitor_interval_s=0.1,
        replicas_min=1, replicas_max=2,
        autoscale=dict(interval_s=3600.0, up_backlog=4.0, down_backlog=1.0,
                       up_windows=2, down_windows=2, up_cooldown_s=0.0,
                       down_cooldown_s=0.0),
    ).start()
    results, errors = [], []
    stop = threading.Event()

    def pump(tid):
        i = 0
        while not stop.is_set():
            x = float(tid * 100000 + i)
            try:
                out = front.predict([{"x": x}], timeout=120.0)
                if out["scores"][0] != 2.0 * x:
                    errors.append(f"wrong score {out['scores']} for {x}")
                results.append(out["replica"])
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(repr(e))
            i += 1

    threads = [threading.Thread(target=pump, args=(t,)) for t in range(16)]
    try:
        assert front.autoscaler is not None
        for t in threads:
            t.start()
        assert _tick_until(front, "up"), "no scale-up under backlog"
        assert _wait_for(lambda: len(front._ready_ids()) == 2)
        assert _wait_for(lambda: obs.snapshot()["gauges"].get(
            "serve.fleet.replicas") == 2.0)
        assert _wait_for(lambda: 1 in results), "replica 1 took no traffic"
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120.0)
    try:
        assert not errors, f"requests failed across the ramp: {errors[:3]}"
        assert _tick_until(front, "down"), "no scale-down when idle"
        assert sorted(front.handles) == [0]
        assert len(front._ready_ids()) == 1
        assert obs.snapshot()["gauges"].get("serve.fleet.replicas") == 1.0
        c = obs.snapshot()["counters"]
        assert c.get("serve.scale.up", 0) >= 1
        assert c.get("serve.scale.down", 0) >= 1
        ev = {e.get("name") for e in obs.REGISTRY.events}
        assert {"serve.scale.up", "serve.scale.up_ready", "serve.scale.down",
                "serve.scale.drain", "serve.scale.down_done"} <= ev
        m = front.metrics_payload()
        assert m["autoscale"]["enabled"] is True
        assert (m["autoscale"]["min"], m["autoscale"]["max"]) == (1, 2)
        assert m["autoscale"]["last_decision"]["action"] == "down"
        assert front.predict([{"x": 3.0}], timeout=60.0)["scores"] == [6.0]
    finally:
        front.stop(drain=True, timeout=30.0)
    assert {0, 1} <= set(results)
