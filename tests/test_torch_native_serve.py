"""The port's native serve library (serve/csrc/ytk_serve.cpp, bound in
serve/kernels.py) against its plain versions and the JAX package's native
library, on the CPU.

Tables: a seeded ensemble whose split values lie on a grid, served in
thresholds mode (its own split values) and in edges mode (the grid as the
`.bins.json` edges), with a grid of 120 values (uint8 bins) and of 600
(uint16 bins). Rows: random values, rows planted exactly on split values,
on edges and on edge midpoints, rows past both ends, and NaN rows.

Everything is exact: the native `bin_rows` equals `bin_rows_plain` and
the reference's `bin_rows` (native and numpy); `native_binned_scores`
equals K7's plain version (`binned_walk` on CPU tensors) and the
reference's native walk; the CPU binned rung reports `binned-native`, and
under YTK_NO_NATIVE (read at every call) takes the plain path and
reports `binned-plain`, with the same scores.
"""

import json
import os

import numpy as np
import pytest
import torch

from ytklearn_tpu.predict import create_predictor as jcreate
from ytklearn_tpu.serve import CompiledScorer as JScorer
from ytklearn_tpu.serve import kernels as jk
from ytklearn_tpu_torch import obs
from ytklearn_tpu_torch.gbdt import binning
from ytklearn_tpu_torch.gbdt.tree import GBDTModel, Tree
from ytklearn_tpu_torch.predict import create_predictor
from ytklearn_tpu_torch.serve import CompiledScorer, kernels

NAMES = [f"f{i}" for i in range(5)]
LADDER = (4, 32)
CASES = [("thresholds", 120), ("thresholds", 600), ("edges", 120),
         ("edges", 600)]


def _grid(n):
    return np.round(np.linspace(-3.0, 3.0, n), 6)


def _ensemble(n_grid, depth=4, seed=11):
    """Enough trees that a 600-value grid gives more than 254 distinct
    split values on a feature (a uint16 thresholds table)."""
    rng = np.random.RandomState(seed + n_grid)
    n_trees = 40 if n_grid < 250 else 400
    grid = _grid(n_grid)
    trees = []
    for _ in range(n_trees):
        t = Tree()

        def grow(nid, d):
            if d >= depth or (d > 1 and rng.rand() < 0.2):
                t.leaf_value[nid] = float(rng.randn() * 0.1)
                return
            t.feat[nid] = 0
            t.feat_name[nid] = NAMES[rng.randint(len(NAMES))]
            t.split[nid] = float(grid[rng.randint(1, n_grid - 1)])
            t.default_left[nid] = bool(rng.rand() < 0.5)
            left, right = t.add_children(nid)
            grow(left, d + 1)
            grow(right, d + 1)

        grow(0, 0)
        trees.append(t)
    return GBDTModel(base_prediction=0.125, trees=trees)


def _vocab(trees):
    names = sorted({t.feat_name[i] for t in trees for i in range(t.n_nodes())
                    if not t.is_leaf(i)})
    return {n: i for i, n in enumerate(names)}


def _tables(mode, n_grid):
    model = _ensemble(n_grid)
    vocab = _vocab(model.trees)
    edges = ({n: _grid(n_grid) for n in vocab} if mode == "edges" else None)
    table, why = kernels.build_bin_table(model.trees, vocab, edges)
    jtable, _ = jk.build_bin_table(model.trees, vocab, edges)
    assert table is not None, why
    assert table.mode == mode
    assert str(table.dtype) == ("uint8" if n_grid < 250 else "uint16")
    return model, vocab, table, jtable


def _planted(table, rng, n=300):
    """(n + planted, F) f64 rows: random, on every split/edge value, on
    edge midpoints, past both ends, and NaN (single cells and whole rows)."""
    F = len(table.values)
    X = rng.uniform(-3.5, 3.5, (n, F))
    X[rng.rand(n, F) < 0.1] = np.nan
    extra = []
    for f, v in enumerate(table.values):
        for val in np.concatenate([v, 0.5 * (v[:-1] + v[1:]),
                                   [v[0] - 1.0, v[-1] + 1.0]]):
            row = rng.uniform(-3.0, 3.0, F)
            row[f] = val
            extra.append(row)
    extra.append(np.full(F, np.nan))
    return np.ascontiguousarray(np.vstack([X, np.asarray(extra)]))


@pytest.mark.parametrize("mode,n_grid", CASES)
def test_native_bin_rows_equal_plain_and_the_reference(mode, n_grid,
                                                       monkeypatch):
    assert kernels.native_serve_available()
    _model, _vocab_, table, jtable = _tables(mode, n_grid)
    X = _planted(table, np.random.RandomState(n_grid))
    got = kernels.bin_rows(X, table)
    plain = kernels.bin_rows_plain(X, table)
    assert got.dtype == plain.dtype == table.dtype
    np.testing.assert_array_equal(got, plain)
    assert (got == table.sentinel).any()
    np.testing.assert_array_equal(got, jk.bin_rows(X, jtable))
    # the reference's numpy loop (its library set aside for this call)
    monkeypatch.setattr(jk, "_lib", None)
    monkeypatch.setattr(jk, "_lib_failed", True)
    np.testing.assert_array_equal(got, jk.bin_rows(X, jtable))
    # a batch under 64 rows runs on one thread
    np.testing.assert_array_equal(kernels.bin_rows(X[:7], table), plain[:7])


@pytest.mark.parametrize("mode,n_grid", CASES)
def test_native_binned_scores_equal_k7_plain_and_the_reference(mode, n_grid):
    model, vocab, table, jtable = _tables(mode, n_grid)
    heap, why = kernels.build_heap(model.trees, vocab)
    assert heap is not None, why
    packed = kernels.pack_heap_nodes(heap, table)
    X = _planted(table, np.random.RandomState(n_grid + 1))
    bins = kernels.bin_rows(X, table)
    leaf = np.ascontiguousarray(heap.leaf)
    for threads in (1, 3):
        got = kernels.native_binned_scores(bins, packed, leaf, heap.depth,
                                           table.sentinel, threads)
        before = kernels.binned_walk.launches
        plain = kernels.binned_walk(
            torch.from_numpy(bins), torch.from_numpy(packed),
            torch.from_numpy(leaf), heap.depth, table.sentinel).numpy()
        assert kernels.binned_walk.launches == before  # CPU: plain version
        assert np.array_equal(got, plain)
        jheap, _ = jk.build_heap(model.trees, vocab)
        want = jk.native_binned_scores(
            bins, jk.pack_heap_nodes(jheap, jtable),
            np.ascontiguousarray(jheap.leaf), jheap.depth, jtable.sentinel,
            threads)
        assert np.array_equal(got, want)
    with pytest.raises(TypeError, match="not u8/u16"):
        kernels.native_binned_scores(bins.astype(np.int32), packed, leaf,
                                     heap.depth, table.sentinel, 1)
    with pytest.raises(ValueError, match="past the"):
        kernels.native_binned_scores(bins[:, :1], packed, leaf, heap.depth,
                                     table.sentinel, 1)
    with pytest.raises(ValueError, match="one heap layout"):
        kernels.native_binned_scores(bins, packed, leaf, heap.depth + 1,
                                     table.sentinel, 1)


def test_ytk_no_native_takes_the_plain_path_at_every_call(monkeypatch):
    """YTK_NO_NATIVE is read at every call, in both directions (the
    reference latches its first answer for the process)."""
    _model, _vocab_, table, _jt = _tables("edges", 120)
    X = _planted(table, np.random.RandomState(5), n=80)
    calls = []
    plain = kernels.bin_rows_plain

    def spy(*a):
        calls.append(1)
        return plain(*a)

    monkeypatch.setattr(kernels, "bin_rows_plain", spy)
    want = plain(X, table)
    for flag, n_plain in (("1", 1), ("0", 0), ("1", 1), (None, 0)):
        if flag is None:
            monkeypatch.delenv("YTK_NO_NATIVE", raising=False)
        else:
            monkeypatch.setenv("YTK_NO_NATIVE", flag)
        calls.clear()
        np.testing.assert_array_equal(kernels.bin_rows(X, table), want)
        assert len(calls) == n_plain
        assert kernels.native_serve_available() == (n_plain == 0)
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    with pytest.raises(RuntimeError, match="unavailable"):
        kernels.native_binned_scores(want, np.zeros((1, 1), np.int32),
                                     np.zeros((1, 1)), 0, table.sentinel, 1)


@pytest.mark.parametrize("mode", ["thresholds", "edges"])
def test_cpu_binned_rung_is_native_and_equals_plain(tmp_path, monkeypatch,
                                                    mode):
    """device="cpu": the rung reports binned-native; under YTK_NO_NATIVE
    the same rung walks the plain version (binned-plain), with no
    downgrade. Scores equal each other bit for bit, and the reference's
    binned rung (its native backend)."""
    model = _ensemble(120)
    path = tmp_path / "m.model"
    path.write_text(model.dumps())
    if mode == "edges":
        (tmp_path / "m.model.bins.json").write_text(json.dumps({
            "schema": binning.BIN_EDGES_SCHEMA, "version": 1,
            "split_type": "mean",
            "model_digest": binning.model_text_digest(path.read_text()),
            "features": {n: _grid(120).tolist()
                         for n in _vocab(model.trees)},
        }))
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": "sigmoid", "round_num": 1000}}
    pred = create_predictor("gbdt", cfg)
    rng = np.random.RandomState(9)
    rows = [{n: float(v) for n, v in zip(NAMES, r) if not np.isnan(v)}
            for r in _planted(
                kernels.build_bin_table(model.trees, _vocab(model.trees))[0],
                rng, n=60)]
    monkeypatch.setenv("YTK_SERVE_BINNED", "1")
    native = CompiledScorer(pred, ladder=LADDER, device="cpu")
    info = native.rung_info()
    assert (info["mode"], info["backend"], info["bin_mode"]) == \
        ("binned", "binned-native", mode)
    assert not info["downgraded"]
    s, p = native.score_and_predict(rows)
    monkeypatch.setenv("YTK_NO_NATIVE", "1")
    plain = CompiledScorer(pred, ladder=LADDER, device="cpu")
    assert plain.rung_info()["backend"] == "binned-plain"
    assert not plain.rung_info()["downgraded"]
    s2, p2 = plain.score_and_predict(rows)
    assert np.array_equal(s, s2) and np.array_equal(p, p2)
    monkeypatch.delenv("YTK_NO_NATIVE")
    js, jp = JScorer(jcreate("gbdt", cfg), ladder=LADDER, mode="binned"
                     ).score_and_predict(rows)
    assert np.array_equal(s, js)
    np.testing.assert_allclose(p, jp, rtol=1e-14, atol=0)
    if mode == "thresholds":
        assert np.array_equal(s, pred.batch_scores(rows))


def test_missing_toolchain_downgrades_to_plain_and_counts(monkeypatch,
                                                          tmp_path):
    """No g++ (the library cannot build): the CPU binned rung walks the
    plain version and counts serve.downgrade.binned_native_to_plain; host
    binning takes the numpy loop. Nothing raises."""
    model = _ensemble(120)
    path = tmp_path / "m.model"
    path.write_text(model.dumps())
    cfg = {"model": {"data_path": str(path)},
           "optimization": {"loss_function": "sigmoid", "round_num": 1000}}
    monkeypatch.setattr(kernels, "_load_native", lambda: None)
    monkeypatch.setenv("YTK_SERVE_BINNED", "1")
    was = obs.enabled()
    obs.configure(enabled=True)
    try:
        before = obs.snapshot()["counters"].get(
            "serve.downgrade.binned_native_to_plain", 0.0)
        scorer = CompiledScorer(create_predictor("gbdt", cfg), ladder=LADDER,
                                device="cpu")
        after = obs.snapshot()["counters"].get(
            "serve.downgrade.binned_native_to_plain", 0.0)
    finally:
        obs.configure(enabled=was)
    assert scorer.rung_info()["backend"] == "binned-plain"
    assert after == before + 1
    rows = [{"f0": 0.5, "f1": -1.0}, {}]
    pred = create_predictor("gbdt", cfg)
    assert np.array_equal(scorer.score_batch(rows), pred.batch_scores(rows))


def test_native_library_builds_into_the_ignored_build_dir():
    assert kernels.native_serve_available()
    so = kernels._SERVE_SO
    assert os.path.basename(os.path.dirname(so)) == "build"
    assert os.path.dirname(os.path.dirname(so)) == os.path.dirname(
        kernels._SERVE_SRC)
    assert os.path.getmtime(so) >= os.path.getmtime(kernels._SERVE_SRC)
