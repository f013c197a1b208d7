"""The port's ServeApp, ModelRegistry, MicroBatcher and `cli serve` on the CPU.

The app serves a build_gbdt fixture at port 0 on device="cpu" through the
fused rung (the heap walk's plain version on CPU tensors). Scores must
equal the JAX GBDTPredictor.batch_scores bit for bit, and a /predict
response must carry the keys the JAX ServeApp answers the same request
with. `cli serve` also serves an FM and a gbmlr model that `cli train`
wrote, at both precision rungs.
"""

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from unittest import mock

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from serve_models import build_gbdt, request_rows
from ytklearn_tpu.serve import BatchPolicy as JaxPolicy
from ytklearn_tpu.serve import ModelRegistry as JaxRegistry
from ytklearn_tpu.serve import ServeApp as JaxApp
from ytklearn_tpu_torch.serve import (
    BatchPolicy,
    MicroBatcher,
    ModelRegistry,
    OverloadError,
    ServeApp,
    ServeClosed,
)

LADDER = (4, 32)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _http(method, port, path, payload=None, raw=None, timeout=30.0):
    data = raw if raw is not None else (
        json.dumps(payload).encode() if payload is not None else None)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _cfg(tmp):
    return {"model": {"data_path": str(tmp / "gbdt.model")},
            "optimization": {"loss_function": "sigmoid"}}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_serve")
    jpred, names = build_gbdt(tmp, n_trees=17, depth=5)
    reg = ModelRegistry(ladder=LADDER, device="cpu")
    with mock.patch.dict(os.environ, {"YTK_SERVE_FUSED": "1"}):
        reg.load("default", "gbdt", _cfg(tmp))
    app = ServeApp(reg, BatchPolicy(max_batch=32, max_wait_ms=1.0)).start()
    yield app, jpred, names, tmp
    app.stop(drain=True, timeout=10.0)


def test_registry_loads_on_the_fused_rung(served):
    app, _jpred, _names, _tmp = served
    entry = app.registry.get("default")
    assert entry.version == 1 and app.registry.names() == ["default"]
    assert entry.scorer.rung_info()["mode"] == "fused"
    assert entry.scorer.rung_info()["backend"] == "fused-plain"
    with pytest.raises(KeyError):
        app.registry.get("nope")


@pytest.mark.parametrize("n", [1, 3, 33, 70])
def test_predict_rows_bit_equal_to_jax_host_walk(served, n):
    app, jpred, names, _tmp = served
    rows = request_rows(n, np.random.RandomState(n), names)
    status, out = _http("POST", app.port, "/predict", {"rows": rows})
    assert status == 200
    assert np.array_equal(np.asarray(out["scores"]), jpred.batch_scores(rows))
    np.testing.assert_allclose(out["predictions"], jpred.batch_predicts(rows),
                               rtol=1e-14, atol=0)
    assert out["model"] == "default" and out["version"] == 1


def test_predict_features_and_response_keys_match_jax(served):
    app, jpred, names, tmp = served
    row = request_rows(1, np.random.RandomState(0), names)[0]
    status, out = _http("POST", app.port, "/predict", {"features": row})
    assert status == 200
    assert out["scores"] == jpred.batch_scores([row]).tolist()
    reg = JaxRegistry(ladder=LADDER, watch_interval_s=0)
    reg.load("default", "gbdt", _cfg(tmp))
    japp = JaxApp(reg, JaxPolicy(max_batch=32, max_wait_ms=1.0)).start()
    try:
        jstatus, jout = _http("POST", japp.port, "/predict", {"features": row})
    finally:
        japp.stop(drain=True, timeout=10.0)
    assert jstatus == 200
    assert list(out) == list(jout)
    assert out["scores"] == jout["scores"]
    np.testing.assert_allclose(out["predictions"], jout["predictions"],
                               rtol=1e-14, atol=0)


def test_concurrent_requests_coalesce_and_stay_exact(served):
    app, jpred, names, _tmp = served
    rows = request_rows(16, np.random.RandomState(9), names)
    results = [None] * len(rows)

    def one(i):
        results[i] = _http("POST", app.port, "/predict",
                           {"features": rows[i]})

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(rows))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    want = jpred.batch_scores(rows)
    for i, (status, out) in enumerate(results):
        assert status == 200
        assert out["scores"] == [want[i]]


def test_healthz_and_readyz(served):
    app, _jpred, _names, _tmp = served
    status, out = _http("GET", app.port, "/healthz")
    assert status == 200 and out["status"] == "ok"
    assert out["models"] == {"default": {"version": 1}}
    status, out = _http("GET", app.port, "/readyz")
    assert status == 200 and out["ready"] is True
    assert _http("GET", app.port, "/nope")[0] == 404


@pytest.mark.parametrize("body", [
    b"not json", b"[1, 2]", b"{}", b'{"rows": {"a": 1}}', b'{"rows": [1]}',
])
def test_bad_body_gets_400(served, body):
    app, _jpred, _names, _tmp = served
    status, out = _http("POST", app.port, "/predict", raw=body)
    assert status == 400 and out["type"] == "bad_request"


def test_unknown_model_gets_404(served):
    app, _jpred, names, _tmp = served
    status, out = _http("POST", app.port, "/predict",
                        {"features": {}, "model": "nope"})
    assert status == 404 and out["type"] == "unknown_model"


class _GatedScore:
    """score_fn that blocks until released, to hold requests in the queue."""

    def __init__(self):
        self.entered = threading.Event()
        self.release = threading.Event()

    def __call__(self, rows):
        self.entered.set()
        assert self.release.wait(10)
        s = np.arange(len(rows), dtype=np.float64)
        return s, s


def test_batcher_sheds_when_full_and_drains_on_close():
    gate = _GatedScore()
    b = MicroBatcher(gate, BatchPolicy(max_batch=1, max_wait_ms=0.0,
                                       max_queue=2))
    first = b.submit([{"a": 1.0}])
    assert gate.entered.wait(10)  # the worker holds request 1
    queued = [b.submit([{"a": 2.0}]), b.submit([{"a": 3.0}])]
    with pytest.raises(OverloadError):
        b.submit([{"a": 4.0}])
    gate.release.set()
    b.close(drain=True, timeout=10)
    assert b.closed
    for p in [first] + queued:
        s, _ = p.get(timeout=5)
        assert s.tolist() == [0.0]
    with pytest.raises(ServeClosed):
        b.submit([{"a": 5.0}])


def test_stop_drains_queued_requests(tmp_path):
    jpred, names = build_gbdt(tmp_path, n_trees=5, depth=3)
    reg = ModelRegistry(ladder=LADDER, device="cpu")
    reg.load("default", "gbdt", _cfg(tmp_path))
    app = ServeApp(reg, BatchPolicy(max_batch=4, max_wait_ms=50.0)).start()
    rows = request_rows(12, np.random.RandomState(2), names)
    pending = [app.batcher_for("default").submit([r]) for r in rows]
    app.stop(drain=True, timeout=10.0)
    got = np.concatenate([p.get(timeout=5)[0] for p in pending])
    assert np.array_equal(got, jpred.batch_scores(rows))
    assert not app.ready()
    with pytest.raises(ServeClosed):
        app.predict(rows[:1])


def _serve_cli(tmp_path, *extra):
    conf = tmp_path / "serve.conf"
    conf.write_text(
        f'model {{ data_path = "{tmp_path / "gbdt.model"}" }}\n'
        "optimization { loss_function = sigmoid }\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO, YTK_SERVE_FUSED="1")
    return subprocess.Popen(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve", str(conf),
         "gbdt", "--host", "127.0.0.1", "--port", "0", "--ladder", "4,32",
         *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True,
    )


def test_cli_serve_banner_predict_and_sigterm_drain(tmp_path):
    jpred, names = build_gbdt(tmp_path, n_trees=6, depth=3)
    proc = _serve_cli(tmp_path, "--device", "cpu")
    try:
        banner = json.loads(proc.stdout.readline())
        assert banner["ladder"] == [4, 32]
        assert banner["rung"]["mode"] == "fused"
        rows = request_rows(5, np.random.RandomState(1), names)
        status, out = _http("POST", banner["port"], "/predict",
                            {"rows": rows})
        assert status == 200
        assert np.array_equal(out["scores"], jpred.batch_scores(rows))
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_cli_serve_without_device_raises_on_a_cpu_only_box(tmp_path):
    """The default device is cuda; with no GPU the CLI fails loudly."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this box has a GPU: the default device is usable")
    build_gbdt(tmp_path, n_trees=2, depth=2)
    proc = _serve_cli(tmp_path)
    out, err = proc.communicate(timeout=60)
    assert proc.returncode != 0 and out == ""
    assert "no CUDA device" in err


@pytest.mark.parametrize("family,extra", [
    ("fm", {"k": [1, 3]}),
    ("gbmlr", {"k": 4, "tree_num": 2, "learning_rate": 0.3}),
])
def test_cli_serve_trained_family(tmp_path, family, extra):
    """`cli train` a small FM and gbmlr model on the CPU, `cli serve` each
    (the stacked rung at f64 even under YTK_SERVE_BINNED; bf16 for FM
    names itself in the banner), and /predict's scores equal the host
    predictor's at rtol 1e-10, atol 1e-12 (f64 sums in another order)."""
    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

    cfg = write_convex_case(str(tmp_path), "fm", 400, 50, 11, vocab=60,
                            nnz=6, max_iter=4)
    cfg.update(extra)
    conf = tmp_path / "model.conf"
    conf.write_text(json.dumps(cfg))
    assert cli.main(["train", family, str(conf), "--device", "cpu"]) == 0
    pred = create_predictor(family, cfg)
    rng = np.random.RandomState(3)
    rows = [{f"f{j}": float(rng.rand()) for j in rng.choice(60, 6)}
            for _ in range(7)] + [{}, {"unknown": 1.0, "f3": 2.0}]
    for precision in ("f64", "bf16"):
        env = dict(os.environ, PYTHONPATH=REPO, YTK_SERVE_BINNED="1",
                   YTK_SERVE_PRECISION=precision)
        proc = subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve",
             str(conf), family, "--host", "127.0.0.1", "--port", "0",
             "--ladder", "4,32", "--device", "cpu"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            banner = json.loads(proc.stdout.readline())
            rung = banner["rung"]
            assert (banner["model"], rung["mode"], rung["downgraded"]) == \
                (family, "stacked", False)
            served = "bf16" if family == "fm" and precision == "bf16" \
                else "f64"
            assert rung["precision"] == served
            status, out = _http("POST", banner["port"], "/predict",
                                {"rows": rows})
            assert status == 200
            if served == "f64":
                np.testing.assert_allclose(out["scores"],
                                           pred.batch_scores(rows),
                                           rtol=1e-10, atol=1e-12)
                np.testing.assert_allclose(out["predictions"],
                                           pred.batch_predicts(rows),
                                           rtol=1e-9, atol=1e-12)
            else:  # the reference's bf16 band on predictions
                assert np.max(np.abs(np.asarray(out["predictions"])
                                     - pred.batch_predicts(rows))) < 0.1
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
