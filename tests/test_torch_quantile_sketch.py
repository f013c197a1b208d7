"""The port's weighted quantile sketch (gbdt/quantile_sketch.py) against the
JAX package's, bit for bit on the same seeded columns: exact chunk
summaries, the rank-combining merge (ties across sides included), the
prune, the level cascade over many chunks, and the queries."""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.gbdt import quantile_sketch as jqs
from ytklearn_tpu_torch.gbdt import quantile_sketch as pqs


def _same(a, b):
    for f in ("value", "rmin", "rmax", "w"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)
    assert a.total == b.total


def _column(n, seed, kind):
    rng = np.random.RandomState(seed)
    if kind == "normal":
        return rng.randn(n).astype(np.float32)
    if kind == "ties":
        return np.round(rng.randn(n), 1).astype(np.float32)
    return rng.randint(0, 5, n).astype(np.float32)  # low cardinality


@pytest.mark.parametrize("kind", ["normal", "ties", "few"])
@pytest.mark.parametrize("weighted", [False, True])
def test_summary_merge_and_prune_match(kind, weighted):
    a = _column(3000, 1, kind)
    b = _column(2000, 2, kind)
    rng = np.random.RandomState(3)
    wa = rng.rand(3000) + 0.1 if weighted else None
    wb = rng.rand(2000) + 0.1 if weighted else None
    sa, sb = pqs.Summary.from_exact(a, wa), pqs.Summary.from_exact(b, wb)
    ja, jb = jqs.Summary.from_exact(a, wa), jqs.Summary.from_exact(b, wb)
    _same(sa, ja)
    merged = pqs.merge_summaries(sa, sb)
    _same(merged, jqs.merge_summaries(ja, jb))
    for k in (4, 64, 500):
        _same(pqs.prune_summary(merged, k),
              jqs.prune_summary(jqs.merge_summaries(ja, jb), k))
    for q in (1, 7, 255):
        np.testing.assert_array_equal(merged.query_values(q),
                                      jqs.merge_summaries(ja, jb)
                                      .query_values(q))


@pytest.mark.parametrize("b,chunk", [(16, 100), (64, 777), (256, 5000)])
def test_sketch_cascade_matches(b, chunk):
    col = _column(20000, 4, "normal")
    w = np.random.RandomState(5).rand(20000)
    ps = pqs.WeightedQuantileSketch(b=b, chunk_rows=chunk)
    js = jqs.WeightedQuantileSketch(b=b, chunk_rows=chunk)
    for i in range(0, 20000, 1234):  # pushes that straddle chunks
        ps.push(col[i:i + 1234], w[i:i + 1234])
        js.push(col[i:i + 1234], w[i:i + 1234])
    assert ps.is_exact == js.is_exact
    assert len(ps.levels) == len(js.levels)
    _same(ps.summary(), js.summary())
    np.testing.assert_array_equal(ps.query_values(50), js.query_values(50))
    # the summary's bounds stay valid: rmin <= true rank <= rmax
    s = ps.summary()
    assert (s.rmin <= s.rmax).all() and s.total == pytest.approx(w.sum())


def test_low_cardinality_sketch_stays_exact():
    col = _column(50000, 6, "few")
    ps = pqs.WeightedQuantileSketch(b=64, chunk_rows=4096)
    ps.push(col)
    assert ps.is_exact and ps.summary().size == 5
    np.testing.assert_array_equal(ps.summary().value, np.arange(5))


def test_empty_summary():
    s = pqs.WeightedQuantileSketch().summary()
    assert s.size == 0 and s.query_values(10).size == 0
    _same(s, jqs.WeightedQuantileSketch().summary())
