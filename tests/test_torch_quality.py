"""The port's model-quality plane (ytklearn_tpu_torch/obs/quality.py) and the
GBDT trainer's `<model>.sketch.json` against the JAX package's, on the CPU.

The row sampler is bit-equal. PSI, KS and the sidecar payloads are held at
rtol 1e-9 (both packages sketch the same float64 values with the same
weighted GK summary), the trained sidecar's score block at rtol 1e-5: its
predictions are each package's own float32 sigmoid of the same trees'
scores, a few ulps apart.
"""

import json
import os

import numpy as np
import pytest

from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt import quantile_sketch as jqs
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.obs import quality as jq
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import quantile_sketch as qs
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.obs import quality as q

RTOL = 1e-9
#: the sidecar's score block: float32 predictions of each package's own
#: float32 sigmoid, a few ulps apart
SCORE_RTOL = 1e-5


def _close(a, b, path="$", rtol=RTOL):
    """Recursive equality of two JSON-like trees, floats at `rtol`."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, set(a) ^
                                                          set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}", rtol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]", rtol)
    elif isinstance(a, float) or isinstance(b, float):
        assert np.isclose(a, b, rtol=rtol, atol=0) or a == b, (path, a, b)
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 40 + 3])
@pytest.mark.parametrize("rate", [0.0, 0.01, 0.05, 0.5, 1.0])
def test_row_sampler_bit_equal(seed, rate):
    for start, n in ((0, 1), (0, 16), (5, 17), (1000, 4096)):
        got = q.sample_mask(seed, start, n, rate)
        assert np.array_equal(got, jq.sample_mask(seed, start, n, rate))
        assert got.tolist() == [q.row_keep(seed, start + 1 + i, rate)
                                for i in range(n)]
        assert got.tolist() == [jq.row_keep(seed, start + 1 + i, rate)
                                for i in range(n)]


def _sketch(mod, vals, w=None, b=32):
    sk = mod.WeightedQuantileSketch(b=b)
    sk.push(vals, w)
    return sk.summary()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_psi_ks_and_cdf_on_the_same_sketches(seed):
    rng = np.random.RandomState(seed)
    base = rng.randn(20000)
    shift = rng.randn(5000) * (1 + seed * 0.3) + seed * 0.2
    disc = np.round(rng.rand(3000) * 4)
    for a, b in ((base, shift), (base, base[:777]), (disc, disc[::-1])):
        ps = (_sketch(qs, a), _sketch(qs, b))
        js = (_sketch(jqs, a), _sketch(jqs, b))
        for s, t in zip(ps, js):
            _close(q.summary_to_json(s), jq.summary_to_json(t))
        got = (q.psi_summaries(*ps), q.ks_summaries(*ps))
        want = (jq.psi_summaries(*js), jq.ks_summaries(*js))
        assert np.allclose(got, want, rtol=RTOL, atol=0)
        xs = np.linspace(-3, 3, 41)
        assert np.allclose(q.summary_cdf(ps[0], xs),
                           jq.summary_cdf(js[0], xs), rtol=RTOL, atol=0)
    assert q.psi_from_probs([0.5, 0.5], [0.5, 0.5]) == 0.0
    assert q.psi_summaries(ps[0], _sketch(qs, np.zeros(0))) is None


def test_training_sketch_payload_equals_the_reference():
    rng = np.random.RandomState(5)
    X = rng.randn(3000, 5)
    X[rng.rand(3000) < 0.2, 1] = np.nan
    X[:, 4] = np.round(X[:, 4])
    w = rng.rand(3000) + 0.5
    preds = np.stack([rng.rand(3000), rng.rand(3000)], 1)
    names = [f"f{i}" for i in range(5)]
    got = q.build_training_sketch(X, names, weight=w, preds=preds, b=16)
    want = jq.build_training_sketch(X, names, weight=w, preds=preds, b=16)
    _close(got, want)


class _Pred:
    def __init__(self, path, fs):
        self.fs = fs
        self.params = type("P", (), {"model": type("M", (), {
            "data_path": path})()})()


class _Entry:
    def __init__(self, name, version, path, fs):
        self.name, self.version, self.fingerprint = name, version, "fp"
        self.predictor = _Pred(path, fs)


def test_monitor_and_sidecar_round_trip_equal_the_reference(tmp_path):
    rng = np.random.RandomState(11)
    names = [f"c{i}" for i in range(4)]
    X = rng.randn(4000, 4)
    payload = jq.build_training_sketch(X, names, preds=1 / (1 + np.exp(
        -X[:, 0])), b=32)
    path = str(tmp_path / "m.model")
    q.dump_quality_sidecar(LocalFileSystem(), q.quality_sidecar_path(path),
                           payload, model_digest="abc")
    base = q.load_quality_baseline(LocalFileSystem(),
                                   q.quality_sidecar_path(path))
    jbase = jq.load_quality_baseline(JFS(), jq.quality_sidecar_path(path))
    assert set(base) == set(jbase) and base["rows"] == 4000
    assert q.load_quality_baseline(LocalFileSystem(), q.quality_sidecar_path(
        path), model_digest="other") is None
    mon = q.QualityMonitor(sample=0.3, seed=4, b=32)
    jmon = jq.QualityMonitor(sample=0.3, seed=4, b=32)
    e = _Entry("m", 1, path, LocalFileSystem())
    je = _Entry("m", 1, path, JFS())
    for k in range(60):
        n = int(rng.randint(1, 40))
        rows = [{nm: float(v) for nm, v in zip(names, rng.randn(4) + 0.5)
                 if rng.rand() > 0.1} for _ in range(n)]
        preds = rng.rand(n)
        assert mon.observe(e, rows, preds) == jmon.observe(je, rows, preds)
    got = mon.snapshot(include_sketches=True)
    want = jmon.snapshot(include_sketches=True)
    _close(got, want)
    m = got["models"]["m@v1"]
    assert m["psi_max"] > 0.05 and m["features"]["c0"]["psi"] > 0


def test_missing_sidecar_serves_baseline_less(tmp_path):
    mon = q.QualityMonitor(sample=1.0, seed=0)
    e = _Entry("m", 3, str(tmp_path / "none.model"), LocalFileSystem())
    assert mon.observe(e, [{"a": 1.0}], [0.5]) == 1
    out = mon.evaluate(feed_sentinels=False)
    assert out["m@v3"]["no_baseline"] and out["m@v3"]["rows_seen"] == 1


@pytest.mark.parametrize("engine", ["device", "host"])
def test_gbdt_trainer_writes_the_reference_sketch_sidecar(tmp_path, engine):
    rng = np.random.RandomState(3)
    F, n, n_test = 5, 3000, 1000
    names = [f"f{i}" for i in range(F)]
    X = rng.randn(n + n_test, F).astype(np.float32)
    X[rng.rand(n + n_test) < 0.1, 2] = np.nan
    y = ((X[:, 0] * X[:, 1] + X[:, 3] + rng.randn(n + n_test) * 0.5) > 0
         ).astype(np.float32)
    w, wt = np.ones(n, np.float32), np.ones(n_test, np.float32)
    kw = dict(round_num=3, max_depth=4, max_leaf_cnt=8,
              tree_grow_policy="level", learning_rate=0.3,
              loss_function="sigmoid")
    jpath, ppath = str(tmp_path / "jax.model"), str(tmp_path / "port.model")
    JTrainer(JParams(approximate=[JSpec(max_cnt=31)],
                     model=JModelParams(data_path=jpath, dump_freq=0), **kw),
             engine=engine, hist_precision="int8").train(
        JData(X[:n], y[:n], w, n, names),
        JData(X[n:], y[n:], wt, n_test, names))
    extra = {"hist_precision": "int8"} if engine == "device" else {}
    GBDTTrainer(GBDTParams(approximate=[ApproximateSpec(max_cnt=31)],
                           model=ModelParams(data_path=ppath, dump_freq=0),
                           **kw), engine=engine, device="cpu", **extra).train(
        GBDTData(X[:n], y[:n], w, n, names),
        GBDTData(X[n:], y[n:], wt, n_test, names))
    with open(jpath + ".sketch.json") as f:
        want = json.load(f)
    with open(ppath + ".sketch.json") as f:
        got = json.load(f)
    assert got["schema"] == "ytk-quality-sketch" and got["rows"] == n
    assert set(got["features"]) == set(names)
    assert got["score"]["n"] == n_test
    # the digest names each package's own model text (equal texts, equal
    # digests); the held-out scores' sketch at the stated tolerance
    _close({k: v for k, v in got.items()
            if k not in ("model_digest", "score")},
           {k: v for k, v in want.items()
            if k not in ("model_digest", "score")})
    _close(got["score"], want["score"], "$.score", SCORE_RTOL)
    with open(ppath) as f1, open(jpath) as f2:
        same_text = f1.read() == f2.read()
    assert (got["model_digest"] == want["model_digest"]) == same_text
    assert os.path.exists(ppath + ".bins.json")
