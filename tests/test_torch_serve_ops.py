"""The port's serving operations against the JAX package's, on the CPU:
model fingerprints, hot reload (unchanged, changed, failing, deferred,
pinned during the build), rollback/pin/unpin and their HTTP codes, one
end-to-end run of both ServeApps on the same model text and requests (the
same bodies, /metrics keys, `serve.*` counters, trace exemplars, a hot
reload mid-traffic and a 429 with the same Retry-After), a GBDT model
trained, served and hot-reloaded on an fsspec `memory://` store, and
`cli serve`'s flags and refusals.

Scores are compared bit for bit; the port serves on the fused rung (the
heap walk's plain version on CPU tensors), the JAX package on its stacked
rung, both equal to the host tree walk.
"""

import argparse
import json
import os
import subprocess
import sys
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest

from serve_models import build_gbdt, request_rows
from ytklearn_tpu import cli as jcli
from ytklearn_tpu import obs as jobs
from ytklearn_tpu.obs import heartbeat as _jhb  # noqa: F401
from ytklearn_tpu.obs import quality as jquality
from ytklearn_tpu.obs import trace as jtrace
from ytklearn_tpu.obs.heartbeat import stop_history_sampler as jstop_hist
from ytklearn_tpu.predict import create_predictor as jcreate
from ytklearn_tpu.serve import BatchPolicy as JPolicy
from ytklearn_tpu.serve import ModelRegistry as JRegistry
from ytklearn_tpu.serve import ServeApp as JApp
from ytklearn_tpu.serve import registry as jregistry
from ytklearn_tpu_torch import cli, obs
from ytklearn_tpu_torch.io.fs import create_filesystem
from ytklearn_tpu_torch.obs import quality, recorder, trace
from ytklearn_tpu_torch.obs.heartbeat import stop_history_sampler
from ytklearn_tpu_torch.predict import create_predictor
from ytklearn_tpu_torch.resilience import reset_chaos
from ytklearn_tpu_torch.serve import (
    BatchPolicy,
    ModelRegistry,
    NoPreviousVersion,
    ServeApp,
    registry as pregistry,
)

LADDER = (4, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _http(method, port, path, payload=None, timeout=30.0):
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def _cfg(path):
    return {"model": {"data_path": str(path)},
            "optimization": {"loss_function": "sigmoid"}}


@pytest.fixture
def planes():
    """Obs on in both packages with fresh registries; the threads that
    start() arms are stopped and the samplers reset afterwards."""
    was = (obs.enabled(), jobs.enabled())
    had_recorder = recorder.installed()
    # both packages keep their samplers process-wide: put them back as
    # found for the tests that share this process
    traces = [(t, t._state.rate, t._state.seed, t._state.slo_ms)
              for t in (trace, jtrace)]
    monitors = [(qm, qm.default_monitor().rate, qm.default_monitor().seed,
                 qm.default_monitor().b) for qm in (quality, jquality)]
    for m in (obs, jobs):
        m.configure(enabled=True)
        m.reset()
    yield
    if not had_recorder:  # a trainer's guard installs it while obs is on
        recorder.uninstall()
    for stop in (stop_history_sampler, jstop_hist,
                 quality.stop_quality_evaluator,
                 jquality.stop_quality_evaluator):
        stop()
    for t, rate, seed, slo in traces:
        t.configure_tracing(sample=rate, seed=seed, reset=True)
        t._state.slo_ms = slo
    for qm, rate, seed, b in monitors:
        qm.configure_quality(sample=rate, seed=seed, b=b, reset=True)
    for m, w in ((obs, was[0]), (jobs, was[1])):
        m.reset()
        m.configure(enabled=w)


# -- fingerprints and hot reload -------------------------------------------------


def test_fingerprint_rules_equal_the_reference(tmp_path):
    build_gbdt(tmp_path, n_trees=3, depth=2)
    cfg = _cfg(tmp_path / "gbdt.model")
    p, j = create_predictor("gbdt", cfg), jcreate("gbdt", cfg)
    fp = pregistry.model_fingerprint(p)
    assert fp and fp == jregistry.model_fingerprint(j)
    # an in-flight atomic temp file is skipped; a sidecar is a change
    (tmp_path / "gbdt.model.tmp-123").write_text("half")
    assert pregistry.model_fingerprint(p) == fp
    for side in ("gbdt.model.sketch.json", "gbdt.model.version.json",
                 "gbdt.model.bins.json"):
        (tmp_path / side).write_text("{}")
        new = pregistry.model_fingerprint(p)
        assert new != fp and new == jregistry.model_fingerprint(j)
        fp = new
    (tmp_path / "gbdt.model").unlink()
    for side in ("sketch.json", "version.json", "bins.json"):
        (tmp_path / f"gbdt.model.{side}").unlink()
    assert pregistry.model_fingerprint(p) == "" == \
        jregistry.model_fingerprint(j)


def test_fingerprint_on_a_memory_store_equals_the_reference():
    """On fsspec paths os.stat fails (or hits a local file of the same
    name) and the fingerprint falls back to the path list, in both
    packages alike: a rewrite of the same path is no change."""
    from ytklearn_tpu.io.fs import create_filesystem as jcreate_fs

    fs = create_filesystem("memory")
    jfs = jcreate_fs("memory")
    with fs.atomic_open("memory://fp_case/gbdt.model") as f:
        f.write("x")

    class _P:
        def __init__(self, fs):
            self.fs = fs
            self.params = type("P", (), {"model": type("M", (), {
                "data_path": "memory://fp_case/gbdt.model",
                "field_dict_path": ""})(), "feature": None})()

    fp = pregistry.model_fingerprint(_P(fs))
    assert fp and fp == jregistry.model_fingerprint(_P(jfs))
    with fs.atomic_open("memory://fp_case/gbdt.model") as f:
        f.write("a different model text")
    assert pregistry.model_fingerprint(_P(fs)) == fp
    fs.delete("memory://fp_case")


def _two_registries(tmp_path, seed=4):
    build_gbdt(tmp_path, n_trees=5, depth=3, seed=seed)
    cfg = _cfg(tmp_path / "gbdt.model")
    with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
        reg = ModelRegistry(ladder=LADDER, device="cpu", watch_interval_s=0)
        reg.load("default", "gbdt", cfg)
    jreg = JRegistry(ladder=LADDER, watch_interval_s=0)
    jreg.load("default", "gbdt", cfg)
    return reg, jreg, cfg


def _rewrite(tmp_path, seed):
    os.utime(tmp_path / "gbdt.model", ns=(1, 1))  # mtime moves on rewrite
    build_gbdt(tmp_path, n_trees=5, depth=3, seed=seed)


@pytest.mark.parametrize("case", ["unchanged", "changed", "failing",
                                  "deferred", "pinned_during_build"])
def test_maybe_reload_as_the_reference(planes, tmp_path, case):
    reg, jreg, cfg = _two_registries(tmp_path)
    rows = request_rows(9, np.random.RandomState(2), [f"c{i}"
                                                      for i in range(6)])
    if case == "changed":
        _rewrite(tmp_path, 11)
    elif case == "failing":
        (tmp_path / "gbdt.model").write_text("not a model\n")
    elif case in ("deferred", "pinned_during_build"):
        _rewrite(tmp_path, 11)
        orig, jorig = reg._build, jreg._build

        def during(orig, r):
            def build(*a, **k):
                out = orig(*a, **k)
                if case == "deferred":  # the file set moves mid-build
                    (tmp_path / "gbdt.model.version.json").write_text("{}")
                else:
                    r.pin("default")
                return out
            return build

        reg._build = during(orig, reg)
        jreg._build = during(jorig, jreg)
    with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
        got = reg.maybe_reload("default")
    want = jreg.maybe_reload("default")
    assert got == want == (case == "changed")
    e, je = reg.get("default"), jreg.get("default")
    assert (e.version, reg.pinned("default")) == \
        (je.version, jreg.pinned("default"))
    assert np.array_equal(e.scorer.score_batch(rows),
                          je.predictor.batch_scores(rows))
    keys = ("serve.reload", "serve.reload_failed", "serve.reload_deferred")
    assert {k: obs.snapshot()["counters"].get(k) for k in keys} == \
        {k: jobs.snapshot()["counters"].get(k) for k in keys}
    if case == "changed":
        assert e.version == 2 and e.fingerprint == je.fingerprint
    reg.close()
    jreg.close()


def test_rollback_pin_unpin_as_the_reference(planes, tmp_path):
    reg, jreg, _cfg_ = _two_registries(tmp_path)
    for r in (reg, jreg):
        with pytest.raises(KeyError):
            r.rollback("nope")
        with pytest.raises(KeyError):
            r.pin("nope")
    with pytest.raises(NoPreviousVersion):
        reg.rollback("default")
    _rewrite(tmp_path, 12)
    with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
        assert reg.maybe_reload("default")
    assert jreg.maybe_reload("default")
    trail = []
    for r in (reg, jreg):
        steps = [r.rollback("default").version, r.pinned("default"),
                 r.maybe_reload("default"), r.rollback("default").version]
        r.unpin("default")
        steps += [r.pinned("default"), r.maybe_reload("default"),
                  r.get("default").version]
        trail.append(steps)
    assert trail[0] == trail[1] == [1, True, False, 2, False, False, 2]
    assert obs.snapshot()["counters"]["serve.rollback"] == 2 == \
        jobs.snapshot()["counters"]["serve.rollback"]
    reg.close()
    jreg.close()


def test_serve_load_retries_a_transient_fault(planes, tmp_path):
    build_gbdt(tmp_path, n_trees=2, depth=2)
    with mock.patch.dict(os.environ, {"YTK_CHAOS": "serve.load:oserror:1:0",
                                      "YTK_RETRY_BASE_S": "0",
                                      "YTK_RETRY_MAX": "2"}):
        reset_chaos()
        reg = ModelRegistry(ladder=LADDER, device="cpu", watch_interval_s=0)
        with pytest.raises(OSError):
            reg.load("default", "gbdt", _cfg(tmp_path / "gbdt.model"))
    reset_chaos()
    c = obs.snapshot()["counters"]
    assert c["chaos.injected.serve.load"] == 2 and c["io.retry.giveup"] == 1


# -- the HTTP app against the JAX package's ------------------------------------


def _apps(tmp_path, **kw):
    reg, jreg, cfg = _two_registries(tmp_path)
    pol, jpol = (BatchPolicy(max_batch=32, max_wait_ms=1.0),
                 JPolicy(max_batch=32, max_wait_ms=1.0))
    app = ServeApp(reg, pol, **kw).start()
    japp = JApp(jreg, jpol, **kw).start()
    return app, japp, cfg


def test_admin_endpoints_answer_as_the_reference(planes, tmp_path):
    app, japp, _cfg_ = _apps(tmp_path)
    try:
        for path, body in (("/admin/rollback", {"model": "default"}),
                           ("/admin/rollback", {"model": "nope"}),
                           ("/admin/pin", {}), ("/admin/pin", {"model": "x"}),
                           ("/admin/unpin", {"model": "default"}),
                           ("/admin/unpin", [1, 2])):
            s, _h, out = _http("POST", app.port, path, body)
            js, _jh, jout = _http("POST", japp.port, path, body)
            assert (s, out) == (js, jout), path
        assert s == 400
    finally:
        app.stop(timeout=10.0)
        japp.stop(timeout=10.0)


def test_end_to_end_against_the_jax_app(planes, tmp_path):
    for t in (trace, jtrace):
        t.configure_tracing(sample=0.3, seed=5, reset=True)
    for qm in (quality, jquality):
        qm.configure_quality(sample=0.5, seed=3, reset=True)
    # an SLO far above any CPU latency keeps AIMD, the burn sentinel and
    # the trace tail rule off the clock, so both runs are deterministic
    app, japp, cfg = _apps(tmp_path, slo_ms=10_000.0, cache_rows=64)
    names = [f"c{i}" for i in range(6)]
    rng = np.random.RandomState(8)
    try:
        hosts = {1: jcreate("gbdt", cfg)}
        pool = request_rows(48, rng, names)
        for k in range(40):
            if k == 20:  # a hot reload mid-traffic, in both
                _rewrite(tmp_path, 21)
                hosts[2] = jcreate("gbdt", cfg)
                with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
                    assert app.registry.maybe_reload("default")
                assert japp.registry.maybe_reload("default")
            lo = int(rng.randint(0, 40))
            body = {"rows": pool[lo:lo + int(rng.randint(1, 9))]}
            if k % 7 == 3:
                body["model"] = "nope"
            s, _h, out = _http("POST", app.port, "/predict", body)
            js, _jh, jout = _http("POST", japp.port, "/predict", body)
            assert s == js and list(out) == list(jout)
            if s != 200:
                assert s == 404 and out == jout
                continue
            assert out == {**jout, "predictions": out["predictions"]}
            np.testing.assert_allclose(out["predictions"],
                                       jout["predictions"], rtol=1e-14)
            assert np.array_equal(
                out["scores"], hosts[out["version"]].batch_scores(
                    body["rows"]))
        # a 429: the queue bound drops to 0 in both
        app.policy.max_queue = japp.policy.max_queue = 0
        s, h, out = _http("POST", app.port, "/predict", {"rows": pool[:2]})
        js, jh, jout = _http("POST", japp.port, "/predict",
                             {"rows": pool[:2]})
        assert (s, out["type"]) == (js, jout["type"]) == (429, "overload")
        assert h["Retry-After"] == jh["Retry-After"]
        assert int(h["Retry-After"]) >= 1
        q = "/metrics?raw=1&history=1&quality=1&prof=1&models=1"
        _s, _h, m = _http("GET", app.port, q)
        _s, _h, jm = _http("GET", japp.port, q)
        assert set(m) == set(jm)
        for key in ("batching", "cache", "queue_depth"):
            assert m[key] == jm[key], key
        # the prof block names each package's own rung
        for doc in (m, jm):
            for blk in doc["prof"]["models"].values():
                blk.pop("mode")
                blk.pop("backend")
        assert m["prof"] == jm["prof"] and not m["prof"]["enabled"]

        def serve_counters(c):
            return {k: v for k, v in c.items() if k.startswith("serve.")}

        assert serve_counters(m["counters"]) == \
            serve_counters(jm["counters"])
        assert m["model_metrics"]["models"].keys() == \
            jm["model_metrics"]["models"].keys()
        assert m["quality"]["models"].keys() == jm["quality"]["models"].keys()
        s, _h, tr = _http("GET", app.port, "/admin/traces")
        js, _jh, jtr = _http("GET", japp.port, "/admin/traces")

        def shape(doc):
            return [(e["kept"], e["status"], e.get("rows"),
                     [hp["name"] for hp in e["hops"]])
                    for e in doc["exemplars"]]

        assert shape(tr) == shape(jtr) and len(tr["exemplars"]) > 5
        assert set(tr) == set(jtr)
    finally:
        app.stop(timeout=10.0)
        japp.stop(timeout=10.0)


# -- a model on a remote (fsspec) store ----------------------------------------


def test_gbdt_on_memory_store_trained_served_and_reloaded(planes):
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
    from ytklearn_tpu_torch.config.params import ApproximateSpec, \
        GBDTParams, ModelParams
    from ytklearn_tpu_torch.gbdt.data import GBDTData

    fs = create_filesystem("memory")
    rng = np.random.RandomState(6)
    names = [f"f{i}" for i in range(4)]
    X = rng.randn(2000, 4).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float32)
    w = np.ones(2000, np.float32)
    path = "memory://store_case/gbdt.model"

    def train(rounds):
        p = GBDTParams(approximate=[ApproximateSpec(max_cnt=31)],
                       model=ModelParams(data_path=path, dump_freq=0),
                       round_num=rounds, max_depth=3, max_leaf_cnt=8,
                       tree_grow_policy="level", loss_function="sigmoid")
        GBDTTrainer(p, device="cpu", fs=fs, hist_precision="int8").train(
            GBDTData(X, y, w, 2000, names))

    try:
        train(2)
        assert fs.exists(path + ".sketch.json") and fs.exists(
            path + ".bins.json")
        cfg = {"fs_scheme": "memory", "model": {"data_path": path},
               "optimization": {"loss_function": "sigmoid"}}
        with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
            reg = ModelRegistry(ladder=LADDER, device="cpu",
                                watch_interval_s=0)
            reg.load("default", "gbdt", cfg)
        rows = [{n: float(v) for n, v in zip(names, r)} for r in X[:16]]
        e1 = reg.get("default")
        assert np.array_equal(e1.scorer.score_batch(rows),
                              create_predictor("gbdt", cfg).batch_scores(
                                  rows))
        # a changed file on the store is a new path set or nothing: drop
        # the old version's files first, so the reload sees a change
        fs.delete(path + ".bins.json")
        train(4)
        fs.delete(path + ".bins.json")
        with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
            assert reg.maybe_reload("default")
        e2 = reg.get("default")
        assert e2.version == 2 and len(e2.predictor.model.trees) == 4
        assert np.array_equal(e2.scorer.score_batch(rows),
                              create_predictor("gbdt", cfg).batch_scores(
                                  rows))
        reg.close()
    finally:
        fs.delete("memory://store_case")


# -- cli serve -------------------------------------------------------------------


def _flags(parser_fn, argv_head):
    """The long options of a CLI's argparse parser."""
    seen = {}

    def fake_parse(self, args=None, namespace=None):
        seen["opts"] = {o for a in self._actions for o in a.option_strings}
        raise SystemExit(0)

    with mock.patch.object(argparse.ArgumentParser, "parse_args",
                           fake_parse), pytest.raises(SystemExit):
        parser_fn(argv_head)
    return seen["opts"]


def test_cli_serve_accepts_every_reference_flag():
    ours = _flags(cli.serve_main, ["c", "gbdt"])
    theirs = _flags(jcli.serve_main, ["c", "gbdt"])
    assert theirs <= ours and ours - theirs == {"--device"}


@pytest.mark.parametrize("argv,env,want", [
    (["--replicas", "2"], {}, (2, 0, 0)),
    (["--replicas-max", "3"], {}, (0, 0, 3)),
    (["--replicas-min", "1"], {}, (0, 1, 0)),
    ([], {"YTK_SERVE_REPLICAS": "-1"}, (-1, 0, 0)),
])
def test_cli_serve_fleet_flags_raise_by_roadmap_item(tmp_path, argv, env,
                                                     want):
    """The fleet flags and knobs no longer raise (ROADMAP.md 1.6 is
    ported): each one routes `cli serve` to the fleet front with the
    reference's (replicas, min, max) reading, and nothing is refused."""
    seen = {}

    def fake_fleet(args, replicas, slo_ms, cache_rows, r_min=0, r_max=0):
        seen["got"] = (replicas, r_min, r_max)
        seen["device"] = args.device
        return 0

    with mock.patch.dict(os.environ, env), \
            mock.patch.object(cli, "_serve_fleet_main", fake_fleet):
        rc = cli.serve_main([str(tmp_path / "x.conf"), "gbdt", "--device",
                             "cpu", *argv])
    assert rc == 0 and seen == {"got": want, "device": "cpu"}


def test_cli_serve_defaults_arm_the_reference_planes(tmp_path):
    """At no flag: AIMD at 100 ms, the 5 s watcher, quality at 0.05 and
    trace sampling at 0.01 (the knobs' defaults), seen in /metrics and
    the server's own log."""
    build_gbdt(tmp_path, n_trees=3, depth=2)
    conf = tmp_path / "serve.conf"
    conf.write_text(f'model {{ data_path = "{tmp_path / "gbdt.model"}" }}\n'
                    "optimization { loss_function = sigmoid }\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_"))}
    env.update(PYTHONPATH=REPO, YTK_OBS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve", str(conf),
         "gbdt", "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
         "--ladder", "4,32"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        banner = json.loads(proc.stdout.readline())
        assert "wall_t0" in banner and banner["replica_id"] is None
        port = banner["port"]
        s, _h, _out = _http("POST", port, "/predict",
                            {"features": {"c0": 1.0}})
        assert s == 200
        _s, _h, m = _http("GET", port, "/metrics?quality=1")
        assert m["batching"]["default"]["slo_ms"] == 100.0
        assert m["quality"]["sample"] == 0.05
        _s, _h, tr = _http("GET", port, "/admin/traces")
        assert tr["sample"] == 0.01 and tr["slo_ms"] == 100.0
        proc.send_signal(15)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
    assert ModelRegistry(device="cpu").watch_interval_s == 5.0
