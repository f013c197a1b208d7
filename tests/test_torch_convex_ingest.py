"""The port's convex ingest (ytklearn_tpu_torch/io/reader.py::DataIngest,
io/feature_hash.py, transform/) on its Python parser against the JAX
package's Python path (`DataIngest._load_python` on both sides; the native
paths are held together in tests/test_torch_native_ingest.py) on the same
seeded text files.

Tolerance: exact. Every ELL array (idx, val, field), label, weight and
label statistic is array_equal, the feature and field maps equal, the
transform nodes equal field for field and the `_feature_transform_stat`
sidecars byte-identical. murmur3 x64-128 and FeatureHash are integer and
string functions and equal the reference's for every tail length.
"""

import copy

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.io import feature_hash as jfh
from ytklearn_tpu.io.reader import DataIngest as JIngest
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.io import feature_hash as pfh
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.io.reader import DataIngest as PIngest
from ytklearn_tpu_torch.models.ffm import load_field_dict
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case


@pytest.mark.parametrize("seed", [0, 42, 39916801, 2**40 + 7])
def test_murmur3_and_feature_hash_exact(seed):
    rng = np.random.RandomState(seed % 2**31)
    for n in range(0, 41):
        data = bytes(rng.randint(0, 256, n).astype(np.uint8))
        assert pfh.murmur3_x64_128(data, seed) == \
            jfh.murmur3_x64_128(data, seed)
        assert pfh.murmur3_x64_128_h1(data, seed) == \
            jfh.murmur3_x64_128_h1(data, seed)
    ph, jh = pfh.FeatureHash(1000, seed), jfh.FeatureHash(1000, seed)
    names = [f"f{i}" for i in range(200)] + ["", "é@x", "a" * 33]
    for nm in names:
        assert ph.hash_name(nm) == jh.hash_name(nm)
    feats = [(nm, float(i) * 0.5) for i, nm in enumerate(names)]
    assert ph.hash_features(feats) == jh.hash_features(feats)


def _odd_lines(path, K):
    """Lines the synthetic writer never makes: a blank line, a bad value,
    a label out of range, a K-vector label, an empty feature list, a
    feature of a field outside FFM's field dict."""
    with open(path, "a") as f:
        f.write("\n")
        f.write("1###1###f1:abc\n")
        f.write(f"1###{K + 3}###f1:1\n")
        if K > 2:
            f.write("1###" + ",".join(["0"] * (K - 1) + ["1"]) + "###f2:2\n")
        f.write("2###0###\n")
        f.write("1###0###zz@f1:1,f2:3\n")


# (name, family, config edits)
CASES = [
    ("linear", "linear", {}),
    ("no_bias", "linear", {"model.need_bias": False}),
    ("threshold", "linear", {"feature.filter_threshold": 30}),
    ("hash", "linear", {"feature.feature_hash.need_feature_hash": True,
                        "feature.feature_hash.bucket_size": 37}),
    ("standardize", "linear", {"feature.transform.switch_on": True,
                               "feature.transform.exclude_features":
                               ["f3", "f9"]}),
    ("scale_range", "fm", {"feature.transform.switch_on": True,
                           "feature.transform.mode": "scale_range",
                           "feature.transform.scale_range.min": 0.0,
                           "feature.transform.include_features":
                           ["f1", "f40", "f77", "f120"]}),
    ("y_sampling", "linear", {"data.y_sampling": ["0@0.5", "1@2"]}),
    ("multiclass", "multiclass_linear", {}),
    ("ffm", "ffm", {}),
]


def _set(cfg, key, val):
    d = cfg
    parts = key.split(".")
    for p in parts[:-1]:
        d = d.setdefault(p, {})
    d[parts[-1]] = val


def _ingest(cls, pcls, cfg, family):
    """Either package's Python path (the JAX package's `load` takes the
    native parser once a process has loaded it, whatever YTK_NO_NATIVE
    says later; the port's reads the knob at every call)."""
    p = pcls.from_config(cfg)
    kw = {}
    if family == "multiclass_linear":
        kw["n_labels"] = int(p.k)
    if family == "ffm":
        kw["field_map"] = load_field_dict(LocalFileSystem(),
                                          p.model.field_dict_path)
    ing = cls(p, **kw)
    return ing._load_python()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ingests of every case; the JAX one on its Python path."""
    out = {}
    for name, family, edits in CASES:
        d = str(tmp_path_factory.mktemp(name))
        cfg = write_convex_case(d, family, 600, 150, 11, vocab=160,
                                nnz=8)
        K = int(cfg.get("k", 2)) if family == "multiclass_linear" else 2
        _odd_lines(cfg["data"]["train"]["data_path"], K)
        cfg["data"]["train"]["max_error_tol"] = 5
        for k, v in edits.items():
            _set(cfg, k, v)
        res = {}
        for tag, cls, pcls in (("jax", JIngest, JParams),
                               ("port", PIngest, PParams)):
            c = copy.deepcopy(cfg)
            c["model"]["data_path"] = f"{d}/{tag}_model"
            res[tag] = _ingest(cls, pcls, c, family)
            side = f"{d}/{tag}_model_feature_transform_stat"
            try:
                with open(side) as f:
                    res[tag + "_side"] = f.read()
            except FileNotFoundError:
                res[tag + "_side"] = None
        out[name] = res
    return out


def _same_ds(a, b):
    for f in ("idx", "val", "y", "weight", "field"):
        x, y = getattr(a, f), getattr(b, f)
        if x is None or y is None:
            assert x is None and y is None, f
            continue
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert (a.n_real, a.dim) == (b.n_real, b.dim)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_ingest_arrays_equal_jax_python_path(name, runs):
    j, p = runs[name]["jax"], runs[name]["port"]
    _same_ds(j.train, p.train)
    _same_ds(j.test, p.test)
    assert j.feature_map == p.feature_map
    assert list(j.feature_map) == list(p.feature_map)
    assert np.array_equal(j.y_real_stat, p.y_real_stat)
    assert np.array_equal(j.y_weight_stat, p.y_weight_stat)


@pytest.mark.parametrize("name", ["standardize", "scale_range", "linear"])
def test_transform_nodes_and_sidecar_equal(name, runs):
    j, p = runs[name]["jax"], runs[name]["port"]
    assert sorted(j.transform_nodes) == sorted(p.transform_nodes)
    for i, node in j.transform_nodes.items():
        assert vars(node) == vars(p.transform_nodes[i])
    assert runs[name]["jax_side"] == runs[name]["port_side"]
    assert (runs[name]["port_side"] is None) == (name == "linear")


def test_need_dict_loads_the_dict_file(tmp_path):
    cfg = write_convex_case(str(tmp_path), "linear", 200, 50, 3, vocab=80)
    dpath = tmp_path / "dict"
    dpath.write_text("f5\nf1\n\nf5\nf70\nzz\n")
    cfg["model"]["need_dict"] = True
    cfg["model"]["dict_path"] = str(dpath)
    j = _ingest(JIngest, JParams, cfg, "linear")
    p = _ingest(PIngest, PParams, cfg, "linear")
    assert list(p.feature_map) == ["_bias_", "f5", "f1", "f70", "zz"]
    assert j.feature_map == p.feature_map
    _same_ds(j.train, p.train)


def test_too_many_error_lines_raise(tmp_path):
    cfg = write_convex_case(str(tmp_path), "linear", 20, 5, 3)
    _odd_lines(cfg["data"]["train"]["data_path"], 2)
    cfg["data"]["train"]["max_error_tol"] = 0
    for cls, pcls in ((JIngest, JParams), (PIngest, PParams)):
        with pytest.raises(ValueError):
            _ingest(cls, pcls, cfg, "linear")
