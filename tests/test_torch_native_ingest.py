"""The port's native C++ ingest (io/native.py, io/csrc/ytk_parse.cpp) against
the JAX package's native path, bit for bit.

Every case of tests/test_native_ingest.py and
tests/test_native_convex_ingest.py runs through both packages' native
paths, called directly (`_parse_native`, `_load_fast`, `parse_block`,
`parse_paths`): the JAX package's `load()` keeps the first answer its
process got about the native library, so its dispatch is never relied on
here. Compared exactly: rows, labels, `label_ptr`, weights, name order,
error counts, the dense GBDT matrix (NaN-aware), the ELL arrays, transform
nodes, hashed sums, y-sampling draws, FFM fields and label statistics. The
port's Python paths stay held to the JAX package's (`_parse_python`,
`_load_python`), and YTK_NO_NATIVE takes effect at every call.
"""

import dataclasses

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import CommonParams as JCommon
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.gbdt.data import GBDTIngest as JIngest
from ytklearn_tpu.io import native as jnative
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.io.reader import DataIngest as JDataIngest
from ytklearn_tpu_torch.config.params import CommonParams, GBDTParams
from ytklearn_tpu_torch.gbdt.data import GBDTIngest
from ytklearn_tpu_torch.io import native
from ytklearn_tpu_torch.io.fs import LocalFileSystem
from ytklearn_tpu_torch.io.reader import DataIngest

pytestmark = pytest.mark.skipif(
    not (native.native_available() and jnative.native_available()),
    reason="g++ is not available: neither native parser builds")

MESSY = (
    "1###0###f1:1.5,f2:2\n"
    "2###1###f3:+3.5,f1:0.25\n"
    "garbage line\n"
    "1### 1 ### f2 : 7 \n"
    "\n"
    "   \n"
    "1###0###\n"
    "0.5###1###f9:1e-3,f1:-2.5,f9:4\n"
    "1###0###fx:nan,f2:inf\n"
    "1###notanumber###f1:1\n"
    "1###1###f1\n"
    "--1###0###f1:1\n"
    "+-2###1###f2:2\n"
    "1###--5###f3:3\n"
    "1###0###f1:1_5\n"
    "1###0###f1:_5\n"
    "1###1###f4:0.1,f5:3.4028236e38,f6:1e-46\n"  # f32 rounding at the ends
)


def _gbdt_pair(tmp_path, text, K=1, F=8, tol=10, name="data.txt"):
    p = tmp_path / name
    p.write_text(text)
    out = []
    for cls, pcls in ((GBDTIngest, GBDTParams), (JIngest, JParams)):
        params = pcls(loss_function="softmax" if K > 1 else "sigmoid",
                      class_num=K)
        params.data.max_feature_dim = F
        params.data.train_paths = [str(p)]
        params.data.train_max_error_tol = tol
        out.append(cls(params))
    return out, [str(p)]


def _same_gbdt(a, b):
    assert a.n_real == b.n_real
    np.testing.assert_array_equal(a.weight, b.weight)
    np.testing.assert_array_equal(a.y, b.y)
    assert a.X.dtype == b.X.dtype == np.float32
    np.testing.assert_array_equal(a.X, b.X)  # NaN-aware
    assert a.feature_names == b.feature_names


def _native_both(tmp_path, text, *args, **kw):
    (port, ref), paths = _gbdt_pair(tmp_path, text, **kw)
    tol = kw.get("tol", 10)
    a = port._parse_native(paths, tol, *args)
    b = ref._parse_native(paths, tol, *args)
    assert port._fmap == ref._fmap
    return a, b, port, ref, paths


def test_messy_parity(tmp_path):
    a, b, port, _, paths = _native_both(tmp_path, MESSY)
    _same_gbdt(a, b)
    # the Python parser reads the last line's 3.4028236e38 in float64 and
    # stores inf; the float32 parse finds it out of range, an error line
    # (the JAX package's two paths differ the same way)
    py = port._parse_python(paths, 10)
    assert py.n_real == a.n_real + 1 == 8
    assert py.feature_names[:5] == a.feature_names[:5]


def test_messy_python_path_matches_reference_python(tmp_path):
    (port, ref), paths = _gbdt_pair(tmp_path, MESSY)
    _same_gbdt(port._parse_python(paths, 10), ref._parse_python(paths, 10))
    assert port._fmap == ref._fmap


def test_error_tolerance_exceeded(tmp_path):
    (port, ref), paths = _gbdt_pair(tmp_path, MESSY, tol=1)
    for ing in (port, ref):
        with pytest.raises(ValueError, match="max_error_tol"):
            ing._parse_native(paths, 1)


def test_multiclass_parity(tmp_path):
    text = ("1###2###f1:1,f2:2\n"
            "1###0,0,1###f2:3\n"
            "1###5###f1:1\n"
            "1###0,1###f1:1\n"
            "1###1.7###f3:4\n"
            "1###-1###f1:2\n")
    a, b, *_ = _native_both(tmp_path, text, K=3)
    _same_gbdt(a, b)
    assert a.n_real == 4 and a.y.shape == (4, 3)


def test_max_feature_dim_overflow(tmp_path):
    (port, ref), paths = _gbdt_pair(tmp_path, "1###0###a:1,b:2,c:3\n", F=2,
                                    tol=0)
    for ing in (port, ref):
        with pytest.raises(ValueError, match="max_feature_dim"):
            ing._parse_native(paths, 0)


def test_overflow_rows_tolerated_as_error_lines(tmp_path):
    text = "1###0###a:1\n1###1###b:2,c:3,dd:4\n1###0###b:5\n"
    a, b, *_ = _native_both(tmp_path, text, F=2, tol=5)
    _same_gbdt(a, b)
    assert a.n_real == 2


def test_multichar_delim_falls_back_to_python(tmp_path):
    p = tmp_path / "d.txt"
    p.write_text("1###0###a:1||b:2\n")
    params = GBDTParams(loss_function="sigmoid")
    params.data.max_feature_dim = 4
    params.data.train_paths = [str(p)]
    params.data.delim.features_delim = "||"
    ing = GBDTIngest(params)
    out = ing._parse([str(p)], 0)
    assert out.n_real == 1 and set(ing._fmap) == {"a", "b"}
    assert ing.parser == "python"
    params.data.delim.features_delim = ","
    params.data.delim.x_delim = "###"
    assert native.use_native(params.data.delim)


def test_frozen_test_set(tmp_path):
    (port, ref), paths = _gbdt_pair(tmp_path,
                                    "1###0###a:1,b:2\n1###1###c:3\n")
    port._parse_native(paths, 0)
    ref._parse_native(paths, 0)
    assert port._fmap == ref._fmap
    tp = tmp_path / "test.txt"
    tp.write_text("1###1###b:5,zz:9,a:1\n")
    a = port._parse_native([str(tp)], 0, fmap=dict(port._fmap), frozen=True)
    b = ref._parse_native([str(tp)], 0, fmap=dict(ref._fmap), frozen=True)
    _same_gbdt(a, b)
    assert np.isnan(a.X[0, port._fmap["c"]]) and "zz" not in port._fmap


def test_line_modulo_shard():
    data = b"".join(f"1###0###f:{i}\n".encode() for i in range(10))
    for d, r in ((3, 1), (4, 0), (2, 1)):
        a = native.parse_block(data, divisor=d, remainder=r)
        b = jnative.parse_block(data, divisor=d, remainder=r)
        _same_block(a, b)
    np.testing.assert_array_equal(
        native.parse_block(data, divisor=3, remainder=1).feat_vals,
        [1.0, 4.0, 7.0])


def _same_block(a, b):
    assert a.names == b.names and a.n_errors == b.n_errors
    for f in ("weights", "label_ptr", "labels", "row_ptr", "feat_ids",
              "feat_vals"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


def test_parse_block_threads_deterministic():
    data = b"".join(
        f"1###{i % 2}###f{i % 17}:{i},g{i % 5}:{i * 2}\n".encode()
        for i in range(5000))
    one = native.parse_block(data, n_threads=1)
    for t in (2, 7):
        _same_block(native.parse_block(data, n_threads=t), one)
    _same_block(one, jnative.parse_block(data, n_threads=3))


def test_parse_paths_matches_concatenated_parse(tmp_path):
    files = {
        "a.txt": "1###0###x:1,y:2\n1###1###bad-line\n\n1###0###y:3,z:4",
        "b.txt": "1###1###z:5,w:6\n1###0###x:7\n1###1###q:8,y:9\n",
        "c.txt": "1###0###w:10\n1###1###x:11,n:12\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    paths = [str(tmp_path / n) for n in sorted(files)]
    concat = b"".join(
        (files[n].encode() + (b"" if files[n].endswith("\n") else b"\n"))
        for n in sorted(files))
    for divisor, remainder in [(1, 0), (2, 0), (2, 1), (3, 2)]:
        merged = native.parse_paths(LocalFileSystem(), paths,
                                    divisor=divisor, remainder=remainder)
        _same_block(merged, native.parse_block(concat, divisor=divisor,
                                               remainder=remainder))
        _same_block(merged, jnative.parse_paths(JFS(), paths,
                                                divisor=divisor,
                                                remainder=remainder))


def test_expand_labels_columnar_matches():
    ptr = np.asarray([0, 1, 4, 5, 7, 8, 9], np.int64)
    labels = np.asarray([2, 0, 0, 1, 5, 0, 1, -1, 1.7], np.float32)
    for K in (1, 3):
        a = native.expand_labels_columnar(ptr, labels, 6, K)
        b = jnative.expand_labels_columnar(ptr, labels, 6, K)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_no_latch_ytk_no_native_takes_effect_at_every_call(tmp_path,
                                                         monkeypatch):
    """A native parse first, then YTK_NO_NATIVE=1: the next dispatch takes
    the Python parser, and unsetting it brings the native one back (the
    JAX package would keep its first answer for the process)."""
    (port, _), paths = _gbdt_pair(tmp_path, MESSY)
    port._parse(paths, 10)
    assert port.parser == "native"
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    assert not native.native_available()
    port._parse(paths, 10)
    assert port.parser == "python"
    monkeypatch.delenv("YTK_NO_NATIVE")
    port._parse(paths, 10)
    assert port.parser == "native"


def test_gbdt_load_records_the_parser(tmp_path, monkeypatch):
    from ytklearn_tpu_torch.config.params import ApproximateSpec
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    rng = np.random.RandomState(3)
    lines = [f"1###{int(x[0] > 0)}###a:{x[0]:.6g},b:{x[1]:.6g}"
             for x in rng.randn(400, 2)]
    (tmp_path / "t.txt").write_text("\n".join(lines) + "\n")
    for env, want in ((None, "native"), ("1", "python")):
        if env:
            monkeypatch.setenv("YTK_NO_NATIVE", env)
        p = GBDTParams(approximate=[ApproximateSpec(max_cnt=15)],
                       round_num=1, max_depth=2, max_leaf_cnt=4)
        p.data.max_feature_dim = 2
        p.data.train_paths = [str(tmp_path / "t.txt")]
        p.model.data_path = str(tmp_path / f"m{want}")
        tr = GBDTTrainer(p, device="cpu", hist_precision="int8")
        tr.train()
        assert tr.time_stats["parser"] == want


# -- the convex ingest (DataIngest._load_fast) -------------------------------

TRAIN = (
    "1###1###a:1.5,b:2,c:0.5\n"
    "2###0###b:1,d:4\n"
    "junk\n"
    "1###1###a:-1,c:3,c:7\n"
    "1###0###d:2.5,e:1\n"
    "0.5###1###a:2,b:0.1\n"
)
TEST = "1###1###a:1,zz:9,b:2\n1###0###d:1\n"


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _convex_params(tmp_path, train, test=None, **kw):
    out = []
    for cls in (CommonParams, JCommon):
        p = cls()
        p.data.train_paths = [train]
        p.data.test_paths = [test] if test else []
        p.data.train_max_error_tol = kw.get("tol", 10)
        p.data.test_max_error_tol = 10
        p.model.data_path = str(tmp_path / f"model_{cls.__module__[:14]}")
        p.model.need_bias = kw.get("need_bias", True)
        for k, v in kw.items():
            if k in ("tol", "need_bias"):
                continue
            obj = p
            parts = k.split("__")
            for part in parts[:-1]:
                obj = getattr(obj, part)
            setattr(obj, parts[-1], v)
        out.append(p)
    return out


def _fast_both(pp, jp, **ingest_kw):
    a = DataIngest(dataclasses.replace(pp), **ingest_kw)._load_fast()
    b = JDataIngest(dataclasses.replace(jp), **ingest_kw)._load_fast()
    return a, b


def _same_result(a, b):
    assert a.feature_map == b.feature_map
    for sa, sb in ((a.train, b.train), (a.test, b.test)):
        if sa is None or sb is None:
            assert sa is None and sb is None
            continue
        assert sa.n_real == sb.n_real and sa.dim == sb.dim
        for f in ("idx", "val", "y", "weight", "field"):
            x, y = getattr(sa, f), getattr(sb, f)
            if x is None or y is None:
                assert x is None and y is None, f
                continue
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    np.testing.assert_array_equal(a.y_real_stat, b.y_real_stat)
    np.testing.assert_array_equal(a.y_weight_stat, b.y_weight_stat)
    assert a.transform_nodes.keys() == b.transform_nodes.keys()
    for k in a.transform_nodes:
        assert vars(a.transform_nodes[k]) == vars(b.transform_nodes[k])


def test_convex_basic_parity(tmp_path):
    tr, te = _write(tmp_path, "tr.txt", TRAIN), _write(tmp_path, "te.txt",
                                                       TEST)
    a, b = _fast_both(*_convex_params(tmp_path, tr, te))
    _same_result(a, b)
    assert a.parser == "native"


def test_convex_no_bias_and_filter_threshold(tmp_path):
    tr = _write(tmp_path, "tr.txt", TRAIN)
    pp, jp = _convex_params(tmp_path, tr, need_bias=False,
                            feature__filter_threshold=2)
    a, b = _fast_both(pp, jp)
    _same_result(a, b)
    assert "e" not in a.feature_map


@pytest.mark.parametrize("mode", ["standardization", "scale_range"])
def test_convex_transforms_exact(tmp_path, mode):
    """float32-parsed values give the same stats and nodes in both
    packages, and the same sidecar text."""
    tr = _write(tmp_path, "tr.txt", TRAIN)
    pp, jp = _convex_params(tmp_path, tr, feature__transform__switch_on=True,
                            feature__transform__mode=mode)
    a, b = _fast_both(pp, jp)
    _same_result(a, b)
    assert a.transform_nodes
    with open(pp.model.data_path + "_feature_transform_stat") as f, \
            open(jp.model.data_path + "_feature_transform_stat") as g:
        assert f.read() == g.read()


def test_convex_feature_hash_parity(tmp_path):
    tr = _write(tmp_path, "tr.txt", TRAIN)
    pp, jp = _convex_params(tmp_path, tr,
                            feature__feature_hash__need_feature_hash=True,
                            feature__feature_hash__bucket_size=8,
                            feature__feature_hash__seed=17)
    a, b = _fast_both(pp, jp)
    _same_result(a, b)
    assert any(n.startswith("hash_") for n in a.feature_map)


def test_convex_y_sampling_rng_parity(tmp_path):
    lines = [f"1###{i % 2}###a:{i},b:{i * 2}" for i in range(200)]
    tr = _write(tmp_path, "tr.txt", "\n".join(lines) + "\n")
    pp, jp = _convex_params(tmp_path, tr,
                            data__y_sampling=[("0", 0.5), ("1", 2.0)])
    a, b = _fast_both(pp, jp)
    _same_result(a, b)
    assert 100 < a.train.n_real < 200


def test_convex_multiclass_labels(tmp_path):
    text = ("1###2###a:1\n"
            "1###0,0,1###b:1\n"
            "1###7###a:1\n"
            "1###-1###b:2\n"
            "1###0,1###a:3\n")
    tr = _write(tmp_path, "tr.txt", text)
    a, b = _fast_both(*_convex_params(tmp_path, tr), n_labels=3)
    _same_result(a, b)
    assert a.train.y.shape == (3, 3)


def test_convex_ffm_field_map(tmp_path):
    text = "1###1###f1^a:1,f2^b:2,zz^c:3\n1###0###f1^d:4\n"
    tr = _write(tmp_path, "tr.txt", text)
    pp, jp = _convex_params(tmp_path, tr, data__delim__field_delim="^")
    a, b = _fast_both(pp, jp, field_map={"f1": 0, "f2": 1})
    _same_result(a, b)
    assert a.train.field is not None


def test_convex_error_tol_exceeded(tmp_path):
    tr = _write(tmp_path, "tr.txt", TRAIN)
    pp, jp = _convex_params(tmp_path, tr, tol=0)
    for ing in (DataIngest(pp), JDataIngest(jp)):
        with pytest.raises(ValueError, match="max_error_tol"):
            ing._load_fast()


def test_convex_dispatch_and_python_path(tmp_path, monkeypatch):
    """load() takes the native path, or the Python one under YTK_NO_NATIVE
    (set after a native load), which equals the reference's Python path."""
    tr, te = _write(tmp_path, "tr.txt", TRAIN), _write(tmp_path, "te.txt",
                                                       TEST)
    pp, jp = _convex_params(tmp_path, tr, te)
    assert DataIngest(dataclasses.replace(pp)).load().parser == "native"
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    got = DataIngest(dataclasses.replace(pp)).load()
    assert got.parser == "python"
    _same_result(got, JDataIngest(dataclasses.replace(jp))._load_python())
