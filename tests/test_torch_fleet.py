"""The port's serving fleet (ytklearn_tpu_torch/serve/fleet/: front,
replica workers) against the JAX package's, on the CPU.

The front's pure helpers (`extract_raw_rows`, `merge_model_metrics`) equal
the reference's on fixed and hypothesis-made inputs. Both packages'
FleetFront drive tests/fleet_stub_worker.py (stdlib only: the worker HTTP
contract without importing either package), so spawn, balance, kill -9,
restart and admin fan-out cost milliseconds a replica, and the two fronts
give the same answers to the same seeded rows. One test boots the real
thing, `cli serve --device cpu --replicas 2` on a small GBDT model, whose
every response is bit-equal to the single-process port server's and to
the JAX package's GBDTPredictor host walk, before and after a hot reload
and a fleet-wide rollback.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from serve_models import build_gbdt, request_rows
from ytklearn_tpu import obs as jobs
from ytklearn_tpu.serve import BatchPolicy as JPolicy
from ytklearn_tpu.serve import FleetFront as JFront
from ytklearn_tpu.serve import MicroBatcher as JBatcher
from ytklearn_tpu.serve.fleet import front as jfront
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.obs import quality
from ytklearn_tpu_torch.obs import trace as ptrace
from ytklearn_tpu_torch.obs.heartbeat import stop_history_sampler
from ytklearn_tpu_torch.serve import (
    BatchPolicy,
    FleetFront,
    MicroBatcher,
    ModelRegistry,
    ServeApp,
)
from ytklearn_tpu_torch.serve.fleet import front as pfront
from ytklearn_tpu_torch.serve.fleet import worker as pworker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STUB = os.path.join(REPO, "tests", "fleet_stub_worker.py")
PACKAGES = {"port": (FleetFront, BatchPolicy, obs),
            "reference": (JFront, JPolicy, jobs)}


@pytest.fixture()
def obs_on():
    was = (obs.enabled(), jobs.enabled())
    for m in (obs, jobs):
        m.configure(enabled=True)
        m.reset()
    yield
    for m, w in ((obs, was[0]), (jobs, was[1])):
        m.reset()
        m.configure(enabled=w)


def _http(method, port, path, payload=None, timeout=30.0):
    data = (payload if isinstance(payload, bytes) else
            json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


# -- the front's pure helpers --------------------------------------------------

RAW_BODIES = [
    '{"rows":[{"a":1.5},{"b":2}]}',
    '{ "rows" : [ {"a": {"n": [1,2]}} , {"b":"}] tricky"} ] }',
    '{"rows":[{"rows":[1]}]}',
    '{"rows":[{"a":1}],"model":"m"}', '{"model":"m","rows":[{"a":1}]}',
    '{"features":{"a":1}}', '{"rows":[]}', '{"rows":[1,2]}',
    '{"rows":[{"a":1}]', '{"rows":[{"a":1}]}garbage', "", "{", "[]",
    '{"rows":[{"a":1},]}', '{"rows" [{"a":1}]}', '{"rows":[{"a":1} {"b":2}]}',
    '\t{"rows":\n[{"a":1}]\r}\n',
]

_values = st.one_of(st.integers(-5, 5), st.floats(allow_nan=False,
                    allow_infinity=False, width=32), st.text(max_size=4),
                    st.booleans(), st.none())
_rows = st.lists(st.dictionaries(st.text(max_size=4), _values, max_size=3),
                 max_size=4)


@st.composite
def _bodies(draw):
    rows = draw(_rows)
    ws = draw(st.sampled_from(["", " ", "\n", "\t ", "\r\n"]))
    sep = draw(st.sampled_from([(",", ":"), (", ", ": "), (" , ", " : ")]))
    body = ws + "{" + ws + '"rows"' + ws + sep[1] + json.dumps(
        rows, separators=sep) + ws
    extra = draw(st.sampled_from(["", ',"model":"m"', ',"deadline_ms":5',
                                  ',"client":"t"']))
    body += extra + "}" + ws
    cut = draw(st.one_of(st.none(), st.integers(0, max(len(body) - 1, 0))))
    if cut is not None:
        body = body[:cut]
    return body


def test_extract_raw_rows_equals_the_reference_on_fixed_bodies():
    for body in RAW_BODIES:
        assert pfront.extract_raw_rows(body) == jfront.extract_raw_rows(body)
    assert pfront.extract_raw_rows(RAW_BODIES[0]) == ['{"a":1.5}', '{"b":2}']


@settings(max_examples=300, deadline=None)
@given(body=st.one_of(_bodies(), st.text(max_size=40)))
def test_extract_raw_rows_equals_the_reference_on_made_bodies(body):
    got = pfront.extract_raw_rows(body)
    assert got == jfront.extract_raw_rows(body)
    if got is not None:  # each fragment is one verbatim row object
        assert [json.loads(g) for g in got] == json.loads(body)["rows"]


_ring = st.lists(st.one_of(
    st.tuples(st.floats(900.0, 1000.0), st.floats(0.0, 500.0)).map(list),
    st.floats(0.0, 500.0)), max_size=6)
_model_block = st.fixed_dictionaries(
    {"latency": st.fixed_dictionaries({"count": st.integers(0, 9),
                                       "raw_ms": _ring}),
     "counters": st.dictionaries(
         st.sampled_from(["requests", "request_rows", "shed",
                          "deadline_expired"]),
         st.floats(0.0, 1e4), max_size=4)},
    optional={"cache_rows": st.integers(0, 99),
              "slo": st.fixed_dictionaries(
                  {"slo_ms": st.floats(1.0, 200.0),
                   "windows_fired": st.integers(0, 5)})})
_replica_blocks = st.dictionaries(
    st.sampled_from(["0", "1", "2", "3"]),
    st.one_of(st.none(), st.fixed_dictionaries(
        {"models": st.dictionaries(st.sampled_from(["default", "b", "c"]),
                                   _model_block, max_size=3)})),
    max_size=4)


def test_merge_model_metrics_equals_the_reference_on_a_fixed_fleet():
    blocks = {
        "0": {"models": {"default": {
            "latency": {"count": 3, "raw_ms": [[990.0, 1.5], [900.0, 9.0],
                                               2.5]},
            "counters": {"requests": 3.0, "request_rows": 10.0},
            "cache_rows": 4, "slo": {"slo_ms": 50.0, "windows_fired": 1}}}},
        "1": {"models": {"default": {
            "latency": {"count": 1, "raw_ms": [[995.0, 4.0]]},
            "counters": {"requests": 1.0, "request_rows": 30.0}},
            "b": {"latency": {"count": 0, "raw_ms": []},
                  "counters": {"requests": 2.0, "request_rows": 2.0}}}},
    }
    got = pfront.merge_model_metrics(blocks, now=1000.0)
    assert got == jfront.merge_model_metrics(blocks, now=1000.0)
    assert got["models"]["default"]["latency"]["count"] == 3  # windowed
    assert [t["model"] for t in got["top_talkers"]] == ["default", "b"]


@settings(max_examples=200, deadline=None)
@given(blocks=_replica_blocks, now=st.floats(950.0, 1100.0))
def test_merge_model_metrics_equals_the_reference_on_made_payloads(blocks,
                                                                   now):
    assert pfront.merge_model_metrics(blocks, now) == \
        jfront.merge_model_metrics(blocks, now)


# -- the worker contract -------------------------------------------------------


def test_worker_argv_spawns_the_port_cli_on_its_device():
    argv = pworker.serve_worker_argv("c.conf", "gbdt", ["--ladder", "1,4"])
    assert argv[:4] == [sys.executable, "-m", "ytklearn_tpu_torch.cli",
                        "serve"]
    assert argv[argv.index("--device") + 1] == "cuda"
    assert argv[argv.index("--replicas") + 1] == "0"
    assert argv[-2:] == ["--ladder", "1,4"]
    cpu = pworker.serve_worker_argv("c.conf", "gbdt", device="cpu")
    assert cpu[cpu.index("--device") + 1] == "cpu"
    assert "ytklearn_tpu.cli" not in cpu


def test_default_replica_count_reads_the_serving_device():
    with mock.patch("os.cpu_count", return_value=9):
        assert pworker.default_replica_count("cpu") == 4
    with mock.patch("torch.cuda.is_available", return_value=True), \
            mock.patch("torch.cuda.current_device", return_value=0), \
            mock.patch("torch.cuda.device_count", return_value=1):
        assert pworker.default_replica_count("cuda") == 1
        assert pworker.default_replica_count() == 1
    with mock.patch("torch.cuda.is_available", return_value=False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        pworker.default_replica_count("cuda")


def test_forwarders_name_their_queue_hop_front_queue():
    """The front's per-replica forwarders pass trace_site="front", so a
    traced request's queue hop is `front.queue`, as in the reference."""
    names = []
    for batcher_cls in (MicroBatcher, JBatcher):
        b = batcher_cls(lambda rows: (np.zeros(len(rows)),
                                      np.zeros(len(rows))),
                        trace_site="front")
        ctx = ptrace.TraceCtx(["t-1"], kept="adopted")
        try:
            b.submit([{"x": 1.0}], trace=ctx).get(timeout=10.0)
        finally:
            b.close(drain=True, timeout=5.0)
        names.append([h["name"] for h in ctx.hops])
    assert names[0] == names[1] and "front.queue" in names[0]
    solo = MicroBatcher(lambda rows: (np.zeros(len(rows)),) * 2)
    try:
        assert solo.trace_site == "serve"
    finally:
        solo.close()


# -- both fronts over the stub -------------------------------------------------


def _stub_front(pkg, replicas=2, **kw):
    front_cls, policy_cls, _obs = PACKAGES[pkg]
    kw.setdefault("policy", policy_cls(max_batch=64, max_wait_ms=0.5,
                                       max_queue=4096))
    kw.setdefault("ready_timeout_s", 60.0)
    kw.setdefault("monitor_interval_s", 0.1)
    return front_cls([sys.executable, STUB, "--weight", "2.0"], replicas,
                     **kw)


def _drive(pkg):
    """Routing, scores of seeded rows, /metrics, the admin fan-out and the
    HTTP 404 of one front; the record both packages must agree on."""
    rng = np.random.RandomState(3)
    rows = [{f"c{j}": float(v) for j, v in enumerate(rng.randn(3))}
            for _ in range(24)]
    front = _stub_front(pkg).start().serve_http()
    try:
        out = {"scores": [], "preds": [], "seen": set()}
        lock = threading.Lock()

        def client(k):
            for r in rows[k::4]:
                res = front.predict([r], timeout=30.0)
                with lock:
                    out["scores"].append((rows.index(r), res["scores"][0]))
                    out["preds"].append(res["predictions"][0])
                    out["seen"].add(res["replica"])

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        out["scores"].sort()
        code, body = _http("POST", front.port, "/predict",
                           {"rows": rows[:3]})
        out["batch"] = (code, body["scores"], body["version"],
                        body["model"])
        code, err = _http("POST", front.port, "/predict",
                          {"features": {"x": 1.0}, "model": "nope"})
        out["unknown"] = (code, err["type"])
        ok, detail = front.admin("pin")
        out["admin"] = (ok, sorted(detail),
                        sorted(d["status"] for d in detail.values()))
        m = front.metrics_payload()
        out["fleet"] = m["fleet"]
        out["backlog"] = front._httpd.request_queue_size
        out["union"] = m["fleet_latency"]["count"] == sum(
            i.get("latency", {}).get("count", 0)
            for i in m["replicas"].values())
        return out
    finally:
        front.stop(drain=True, timeout=15.0)


def test_front_over_the_stub_equals_the_reference(obs_on):
    port, ref = _drive("port"), _drive("reference")
    assert port["scores"] == ref["scores"]
    assert sorted(port["preds"]) == sorted(ref["preds"])
    assert port["batch"] == ref["batch"] and port["batch"][0] == 200
    assert port["unknown"] == ref["unknown"] == (404, "unknown_model")
    assert port["admin"] == ref["admin"] == (True, ["0", "1"], [200, 200])
    assert port["fleet"] == ref["fleet"] == {"replicas": 2, "ready": 2,
                                             "restarts": 0}
    assert port["union"] and ref["union"]
    # the port's front listens with the single server's backlog of 128
    assert (port["backlog"], ref["backlog"]) == (128, 5)
    assert port["seen"] <= {0, 1} and ref["seen"] <= {0, 1}


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_front_kill9_reroutes_with_zero_failures_and_restarts(obs_on, pkg):
    """kill -9 one replica under load: every request completes (rerouted),
    the slot restarts, and serve.worker.{died,restarted} are counted."""
    front = _stub_front(pkg).start()
    errors, results = [], []
    stop = threading.Event()

    def hammer(tid):
        i = 0
        while not stop.is_set():
            x = float(tid * 1000 + i)
            try:
                out = front.predict([{"x": x}], timeout=60.0)
                if out["scores"][0] != 2.0 * x:
                    errors.append(f"wrong score {out['scores']} for {x}")
                results.append(out["replica"])
            except Exception as e:  # noqa: BLE001 — collected for the assert
                errors.append(repr(e))
            i += 1

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    victim = front.handles[0].pid
    try:
        for t in threads:
            t.start()
        deadline = time.time() + 30.0
        while len(results) < 20 and time.time() < deadline:
            time.sleep(0.02)
        os.kill(victim, signal.SIGKILL)
        deadline = time.time() + 60.0
        while time.time() < deadline and not (
                front.handles[0].restarts >= 1
                and front.handles[0].state == "ready"):
            time.sleep(0.05)
        n = len(results)
        deadline = time.time() + 30.0
        while len(results) < n + 20 and time.time() < deadline:
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=60.0)
    try:
        assert not errors, f"requests failed across the kill: {errors[:3]}"
        h = front.handles[0]
        assert h.restarts >= 1 and h.state == "ready" and h.pid != victim
        c = PACKAGES[pkg][2].snapshot()["counters"]
        assert c.get("serve.worker.died", 0) >= 1
        assert c.get("serve.worker.restarted", 0) >= 1
    finally:
        front.stop(drain=True, timeout=15.0)
    assert len(results) > 40


# -- the real thing: cli serve --device cpu --replicas 2 ----------------------


def _conf(tmp_path):
    conf = tmp_path / "serve.conf"
    conf.write_text(f'model {{ data_path = "{tmp_path / "gbdt.model"}" }}\n'
                    "optimization { loss_function = sigmoid }\n")
    return conf


def test_cli_fleet_on_cpu_is_bit_equal_to_one_server_and_the_host_walk(
        tmp_path):
    """Two CPU replicas behind the front (fused rung: the heap walk's plain
    version). Every response equals the single-process port server's and
    GBDTPredictor.batch_scores of its version, from both replicas; a hot
    reload reaches every replica, and /admin/rollback brings the whole
    fleet back to v1. SIGTERM drains the tree with rc 0."""
    jv1, names = build_gbdt(tmp_path, seed=4, n_trees=6, depth=3)
    v1_text = (tmp_path / "gbdt.model").read_text()
    conf = _conf(tmp_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_", "YTK_"))}
    env.update(PYTHONPATH=REPO, YTK_SERVE_FUSED="1", YTK_OBS="1",
               YTK_FLIGHT_DIR=str(tmp_path / "flight"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve", str(conf),
         "gbdt", "--port", "0", "--host", "127.0.0.1", "--device", "cpu",
         "--replicas", "2", "--ladder", "4,32", "--watch-interval", "0.2"],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    rows = request_rows(40, np.random.RandomState(6), names)
    with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
        reg = ModelRegistry(ladder=(4, 32), watch_interval_s=0, device="cpu")
        reg.load("default", "gbdt",
                 {"model": {"data_path": str(tmp_path / "gbdt.model")},
                  "optimization": {"loss_function": "sigmoid"}})
    solo = ServeApp(reg, BatchPolicy(max_wait_ms=0.5), host="127.0.0.1",
                    port=0, slo_ms=0).start()
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["fleet"] is True and banner["replicas"] == 2
        assert banner["device"] == "cpu" and "wall_t0" in banner
        ports = banner["replica_ports"]
        assert sorted(ports) == ["0", "1"]
        front = banner["port"]

        def fleet_answers(lo, hi, want_version):
            seen = set()
            out = [None] * (hi - lo)

            def client(k):
                for i in range(lo + k, hi, 4):
                    code, body = _http("POST", front, "/predict",
                                       {"rows": rows[i:i + 1]})
                    assert code == 200, body
                    out[i - lo] = body
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(4)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60.0)
            for body in out:
                assert body["version"] == want_version
                seen.add(body["replica"])
            return [b["scores"][0] for b in out], seen

        scores, seen = fleet_answers(0, 40, 1)
        code, one = _http("POST", solo.port, "/predict", {"rows": rows})
        assert code == 200
        assert scores == one["scores"]
        assert scores == jv1.batch_scores(rows).tolist()
        for rid, p in ports.items():  # each replica answers alike
            code, body = _http("POST", p, "/predict", {"rows": rows})
            assert body["scores"] == one["scores"], rid
        code, m = _http("GET", front, "/metrics")
        assert m["fleet"] == {"replicas": 2, "ready": 2, "restarts": 0}
        # the front's client-visible ring counts every request; the ring
        # union counts the replicas' (coalesced) forwards
        assert m["latency"]["count"] == 40
        assert m["fleet_latency"]["count"] == sum(
            i["latency"]["count"] for i in m["replicas"].values()) > 0
        batches = sum(i["counters"].get("serve.scorer.batches", 0)
                      for i in m["replicas"].values())
        assert batches >= len(seen)
        # hot reload: every replica's own watcher picks up v2
        jv2, _ = build_gbdt(tmp_path, seed=9, n_trees=6, depth=3)
        deadline = time.time() + 60.0
        while time.time() < deadline:
            vs = [_http("POST", p, "/predict", {"rows": rows[:1]})[1]
                  ["version"] for p in ports.values()]
            if vs == [2, 2]:
                break
            time.sleep(0.1)
        assert vs == [2, 2]
        scores2, _ = fleet_answers(0, 40, 2)
        assert scores2 == jv2.batch_scores(rows).tolist() != scores
        # fleet-wide rollback: every replica back on v1, pinned
        code, body = _http("POST", front, "/admin/rollback", {})
        assert code == 200 and body["ok"] is True
        assert sorted(body["replicas"]) == ["0", "1"]
        scores3, _ = fleet_answers(0, 40, 1)
        assert scores3 == scores
        code, err = _http("POST", front, "/predict",
                          {"features": {"x": 1.0}, "model": "nope"})
        assert (code, err["type"]) == (404, "unknown_model")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60.0) == 0
        # the front dumped its flight ring at SIGTERM, then drained
        dumps = sorted((tmp_path / "flight").glob("flight_*.json"))
        assert len(dumps) == 1
        doc = json.loads(dumps[0].read_text())
        assert doc["flight"]["reason"] == "sigterm"
        assert "serve.fleet.admin" in {
            e.get("name") for e in doc["flight"]["ring"]}
    finally:
        solo.stop(drain=False)
        quality.stop_quality_evaluator()
        stop_history_sampler()
        if proc.poll() is None:
            # SIGTERM first: the front stops its replicas; a killed front
            # would leave them running
            proc.terminate()
            try:
                proc.wait(timeout=60.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
    assert (tmp_path / "gbdt.model").read_text() != v1_text
