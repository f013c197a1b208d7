"""The port's int8 histograms (K2/K4 plain versions, compaction) against
the JAX package.

The JAX side runs as its own tests run it on the CPU: `hist_wave_q` with
`force_dense=True` (the int32 einsum `_hist_dense_q`), and the fused gather
kernel K4 under the Pallas interpreter (`interpret=True`,
tests/test_hist_fused.py). K2's Pallas body (`_hist_pallas_q`) has no
interpret switch of its own, so its test calls the unjitted body with
`pallas_call` bound to the interpreter. Int32 sums do not depend on
order, so every comparison is exact (np.array_equal).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental import pallas as pl

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.gbdt import hist as jhist
from ytklearn_tpu_torch.gbdt import hist


def _case(n, F, B, N, seed, bins_dtype):
    """Bins, positions over 2N+3 tree nodes with dead rows (-1), quantized
    grads touching +-127, and N wave ids with -2 pads."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(bins_dtype)
    M = 2 * N + 3
    pos = rng.randint(-1, M, size=n).astype(np.int32)
    gq = rng.randint(-127, 128, size=n).astype(np.float32)
    hq = rng.randint(0, 128, size=n).astype(np.float32)
    gq[:4] = [127, -127, 127, -127]
    hq[:2] = 127
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    if N > 2:
        ids[rng.rand(N) < 0.25] = -2
    return bins, pos, gq, hq, ids, M


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _k2_interpreted(monkeypatch, bins, pos, gq, hq, ids, B, bm=1024):
    """K2's Pallas body under the interpreter, in hist_wave_q's output
    layout; rows padded to the block with dead rows (pos -1)."""
    F, n = bins.shape
    n_pad = -(-n // bm) * bm
    pad = n_pad - n
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))
    out = jhist._hist_pallas_q.__wrapped__(
        jnp.asarray(np.pad(bins, ((0, 0), (0, pad))).reshape(
            F, n_pad // bm, 1, bm)),
        jnp.asarray(np.pad(pos, (0, pad), constant_values=-1)),
        jnp.asarray(np.pad(gq, (0, pad))), jnp.asarray(np.pad(hq, (0, pad))),
        jnp.asarray(ids), B, bm, F)
    N = ids.shape[0]
    return np.asarray(out).reshape(F, 3, N, B).transpose(2, 0, 3, 1)


@pytest.mark.parametrize("bins_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("B", [16, 256])
def test_hist_wave_q_matches_dense_exact(bins_dtype, N, B, monkeypatch):
    """K2's plain version against the dense int32 einsum and against the
    Pallas kernel body (interpreter)."""
    bins, pos, gq, hq, ids, M = _case(3000, 5, B, N, N * 1000 + B,
                                      bins_dtype)
    want = np.asarray(jhist.hist_wave_q(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos), jnp.asarray(gq),
        jnp.asarray(hq), jnp.asarray(ids), B, force_dense=True))
    np.testing.assert_array_equal(
        _k2_interpreted(monkeypatch, bins, pos, gq, hq, ids, B), want)
    before = hist.hist_wave_q.launches
    got = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                           max_nodes=M)
    assert hist.hist_wave_q.launches == before  # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (N, 5, B, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def _compacted(bins, pos, gq, hq, ids, R):
    """The engine's compaction on the host: wave rows first, dead slots
    (pos -1, idx 0) after."""
    mask = np.isin(pos, ids[ids >= 0])
    sel = np.nonzero(mask)[0]
    assert len(sel) <= R
    idx = np.zeros(R, np.int32)
    idx[: len(sel)] = sel
    pg = np.full(R, -1, np.int32)
    pg[: len(sel)] = pos[sel]
    gg = np.zeros(R, np.float32)
    gg[: len(sel)] = gq[sel]
    hg = np.zeros(R, np.float32)
    hg[: len(sel)] = hq[sel]
    return np.ascontiguousarray(bins.T), idx, pg, gg, hg


@pytest.mark.parametrize("bins_dtype,B", [(np.uint8, 16), (np.int32, 256)])
def test_hist_wave_gather_matches_pallas_interpreter_exact(bins_dtype, B):
    """K4's plain version against the JAX kernel body itself (Pallas
    interpreter) and against the dense gather path."""
    bins, pos, gq, hq, ids, M = _case(2048, 4, B, 7, 5 + B, bins_dtype)
    rows, idx, pg, gg, hg = _compacted(bins, pos, gq, hq, ids, 1024)
    args = [jnp.asarray(a) for a in (rows, idx, pg, gg, hg, ids)]
    want = np.asarray(jhist.hist_wave_gather(*args, B, mode="int8", bm_g=256,
                                             interpret=True))
    dense = np.asarray(jhist.hist_wave_gather(*args, B, mode="int8",
                                              force_dense=True))
    np.testing.assert_array_equal(want, dense)
    before = hist.hist_wave_gather.launches
    got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg), _t(hg),
                                _t(ids), B, max_nodes=M)
    assert hist.hist_wave_gather.launches == before
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,B", [(1, 256), (7, 16), (64, 256)])
def test_hist_wave_gather_matches_full_scan(N, B):
    """Gathering the wave's rows and histogramming them equals the full
    scan over all rows: the fused rungs grow the full-scan tree."""
    bins, pos, gq, hq, ids, M = _case(4096, 6, B, N, 77 + N, np.uint8)
    rows, idx, pg, gg, hg = _compacted(bins, pos, gq, hq, ids, 4096)
    full = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                            max_nodes=M)
    got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg), _t(hg),
                                _t(ids), B, max_nodes=M)
    assert torch.equal(got, full)
    dense = np.asarray(jhist.hist_wave_gather(
        *[jnp.asarray(a) for a in (rows, idx, pg, gg, hg, ids)], B,
        mode="int8", force_dense=True))
    np.testing.assert_array_equal(got.numpy(), dense)


@pytest.mark.parametrize("density,R", [(0.3, 4096), (0.3, 2048),
                                       (0.0, 512), (1.0, 1024)])
def test_compact_indices_matches_jax(density, R):
    """Order-preserving compaction, including a count past the budget
    (the overflow entries drop)."""
    rng = np.random.RandomState(int(density * 10) + R)
    mask = rng.rand(5000) < density
    want_idx, want_cnt = jhist.compact_indices(jnp.asarray(mask), R)
    idx, cnt = hist.compact_indices(_t(mask), R)
    assert idx.dtype == torch.int32 and idx.shape == (R,)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(cnt) == int(want_cnt)


def test_pad_inputs_matches_jax():
    rng = np.random.RandomState(3)
    bins = rng.randint(0, 200, size=(1000, 5)).astype(np.int32)
    for kw in ({}, {"bm": 128}, {"n_pad": 2048, "F_pad": 8}):
        got, n_pad = hist.pad_inputs(bins, **kw)
        want, want_pad = jhist.pad_inputs(bins, **kw)
        assert n_pad == want_pad
        np.testing.assert_array_equal(got, want)


def _dup_case(B):
    """Duplicated id 2 (slots 0 and 1), a pad, an id past max_nodes (9) and
    id 4, over rows whose positions lie in [-1, 4]."""
    bins, pos, gq, hq, _, _ = _case(512, 3, B, 1, 9, np.uint8)
    pos = np.clip(pos, -1, 4).astype(np.int32)
    ids = np.asarray([2, 2, -2, 9, 4], np.int32)
    return bins, pos, gq, hq, ids, 5


def test_duplicate_and_out_of_range_ids(monkeypatch):
    """A duplicated node id feeds each of its slots, as the reference's
    one-hot does (the dense einsum and K2's Pallas body); ids at or past
    max_nodes and negative ids match nothing."""
    B = 16
    bins, pos, gq, hq, ids, M = _dup_case(B)
    want = np.asarray(jhist._hist_dense_q(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos), jnp.asarray(gq),
        jnp.asarray(hq), jnp.asarray(ids), B))
    want = want.reshape(3, 3, 5, B).transpose(2, 0, 3, 1)
    np.testing.assert_array_equal(
        _k2_interpreted(monkeypatch, bins, pos, gq, hq, ids, B), want)
    got = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                           max_nodes=M).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[1], got[0])
    assert got[0].any() and got[4].any()
    assert not got[2].any() and not got[3].any()


@pytest.mark.parametrize("kernel", ["K1 bf16", "K1 f32", "K3 bf16", "K3 f32",
                                    "K4"])
def test_duplicate_ids_feed_every_slot(kernel):
    """The same case for K1 (against the dense f32/bf16 einsum) and for the
    gather kernels K3/K4 (against the reference's gather kernels under the
    Pallas interpreter): counts and int8 sums exact, f32 sums at the
    tolerance of test_torch_hist_float.py."""
    from test_torch_hist_float import assert_hist_close

    B = 16
    bins, pos, gq, hq, ids, M = _dup_case(B)
    g, h = gq / 37.0, hq / 53.0 + 0.1
    bf16 = kernel.endswith("bf16")
    if kernel.startswith("K1"):
        want = np.asarray(jhist.hist_wave(
            jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos),
            jnp.asarray(g), jnp.asarray(h), jnp.asarray(ids), B,
            use_bf16=bf16, force_dense=True))
        got = hist.hist_wave(_t(bins), _t(pos), _t(g), _t(h), _t(ids), B,
                             max_nodes=M, use_bf16=bf16).numpy()
    else:
        q = kernel == "K4"
        gv, hv = (gq, hq) if q else (g, h)
        rows, idx, pg, gg, hg = _compacted(bins, pos, gv, hv, ids, 512)
        want = np.asarray(jhist.hist_wave_gather(
            *[jnp.asarray(a) for a in (rows, idx, pg, gg, hg, ids)], B,
            mode="int8" if q else "mxu", use_bf16=bf16, bm_g=256,
            interpret=True))
        got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg),
                                    _t(hg), _t(ids), B,
                                    mode="int8" if q else "mxu",
                                    max_nodes=M, use_bf16=bf16).numpy()
    if kernel == "K4":
        np.testing.assert_array_equal(got, want)
    else:
        assert_hist_close(got, want)
    np.testing.assert_array_equal(got[1], got[0])
    assert want[1].any() and not got[2].any() and not got[3].any()


def test_per_row_lengths_are_checked():
    """A bin matrix of another row count than pos (K2), or per-slot arrays
    of another length than idx (K4), raise before any kernel runs."""
    bins, pos, gq, hq, ids, M = _case(600, 3, 16, 7, 4, np.uint8)
    with pytest.raises(ValueError, match="pos must have shape"):
        hist.hist_wave_q(_t(bins[:, :512]), _t(pos), _t(gq[:512]),
                         _t(hq[:512]), _t(ids), 16, max_nodes=M)
    with pytest.raises(ValueError, match="gq must have shape"):
        hist.hist_wave_q(_t(bins), _t(pos), _t(gq[:512]), _t(hq), _t(ids),
                         16, max_nodes=M)
    rows, idx, pg, gg, hg = _compacted(bins, pos, gq, hq, ids, 1024)
    with pytest.raises(ValueError, match="pos_g must have shape"):
        hist.hist_wave_gather(_t(rows), _t(idx), _t(pg[:512]), _t(gg),
                              _t(hg), _t(ids), 16, max_nodes=M)
    with pytest.raises(ValueError, match="max_nodes"):
        hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 16,
                         max_nodes=0)


@pytest.mark.parametrize("N,F,B,M,n", [
    (1, 28, 256, 509, 4_194_304), (64, 28, 256, 509, 4_194_304),
    (7, 5, 16, 31, 49_152), (64, 28, 256, 509, 1024), (3, 2, 8192, 7, 100),
])
def test_tile_plan_covers_the_histogram_and_fits(N, F, B, M, n):
    plan = hist.tile_plan(N, F, B, M, n, sm_count=132)
    assert plan["smem"] <= hist.SMEM_MAX
    assert plan["fg"] * plan["n_ftiles"] >= F
    assert plan["ng"] * (plan["n_tiles"] // plan["n_ftiles"]) >= N
    assert plan["n_chunks"] * plan["rows_per_chunk"] >= n
    assert 1 <= plan["n_chunks"] <= 65535
    assert plan["threads"] in (512, 1024)
    if N == 1 and B == 256:
        assert (plan["fg"], plan["ng"]) == (28, 1)  # root: one tile
    if N == 64 and B == 256:  # a whole wave per tile, one feature each
        assert (plan["fg"], plan["ng"], plan["threads"]) == (1, 64, 1024)


@pytest.mark.parametrize("B,M", [(1 << 15, 8), (256, 57_345)])
def test_tile_plan_cuts_a_tile_past_shared_memory_into_bin_ranges(B, M):
    """Too many bins for one slot x feature tile: the tile holds one of
    the fewest equal ranges of bins that fit (two of 16,384 at B = 2^15),
    each a tile of its own, on the global lookup kind (no lookup in shared
    memory); a node lookup too large for shared memory (a tree of more
    than 57,344 nodes at B = 256) takes the global lookup kind, whose tile
    holds no lookup, over one range. Both pass check_plan."""
    plan = hist.tile_plan(1, 1, B, M, 100, sm_count=132)
    assert hist.check_plan(plan, 1, 1, B, M, 100) == plan
    assert (plan["fg"], plan["ng"]) == (1, 1)
    if B * 12 > hist.SMEM_MAX:
        assert hist.lookup_kind(B, M) == "global"
        assert plan["nb"] == hist.bin_ranges(B) == 2
        assert plan["n_tiles"] == 2
        assert plan["smem"] == 12 * (B // 2) <= hist.SMEM_MAX
        return
    assert hist.lookup_kind(B, M) == "global"
    assert hist.lookup_kind(B, M - 1) == "shared"
    assert plan["nb"] == hist.bin_ranges(B) == 1
    assert plan["smem"] == 12 * B


def test_tile_plan_takes_the_largest_lookup_that_fits():
    plan = hist.tile_plan(64, 28, 256, 57_344, 1 << 20, sm_count=132)
    assert plan["smem"] <= hist.SMEM_MAX and plan["ng"] == 1


@pytest.mark.parametrize("N,F,B,M,n", [
    (1, 28, 256, 509, 4_194_304), (64, 28, 256, 509, 10_502_144),
    (7, 5, 16, 31, 49_152), (3, 2, 8192, 7, 100), (100, 3, 1024, 4096, 5000),
])
def test_check_plan_accepts_tile_plan(N, F, B, M, n):
    plan = hist.tile_plan(N, F, B, M, n, sm_count=132)
    assert hist.check_plan(plan, N, F, B, M, n) == plan
    short = {k: plan[k] for k in ("fg", "ng", "threads", "rows_per_chunk")}
    assert hist.check_plan(short, N, F, B, M, n) == plan


@pytest.mark.parametrize("bad,match", [
    ({"n_ftiles": 27}, "does not cover the histogram"),
    ({"n_tiles": 1}, "does not cover the histogram"),
    ({"rows_per_chunk": 1000, "n_chunks": 3}, "does not cover the rows"),
    ({"fg": 28, "ng": 64}, "shared memory"),
    ({"smem": 1024}, "smem"),
    ({"threads": 2048}, "threads"),
    ({"threads": 100}, "threads"),
    ({"fg": 0}, "must be >= 1"),
    ({"bm": 8192}, "unknown fields"),
    ({"rows_per_chunk": 1}, "chunks"),
])
def test_check_plan_refuses_before_any_launch(bad, match):
    """A plan that does not cover the histogram or its rows, or does not fit
    a block, raises ValueError, here and through the wrappers (whose
    launch counts do not move)."""
    N, F, B, M, n = 64, 28, 256, 509, 70_000
    plan = hist.tile_plan(N, F, B, M, n, sm_count=132)
    if "fg" in bad or "ng" in bad:  # a new tile: drop what the old implied
        plan = {k: plan[k] for k in ("threads", "rows_per_chunk")}
    plan.update(bad)
    with pytest.raises(ValueError, match=match):
        hist.check_plan(plan, N, F, B, M, n)
    bins, pos, gq, hq, _, _ = _case(n, F, B, 1, 3, np.uint8)
    ids = np.arange(N, dtype=np.int32)
    before = hist.hist_wave_q.launches
    with pytest.raises(ValueError, match=match):
        hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                         max_nodes=M, plan=plan)
    assert hist.hist_wave_q.launches == before


def test_explicit_plan_gives_the_same_sums_on_the_cpu():
    bins, pos, gq, hq, ids, M = _case(3000, 5, 16, 7, 11, np.uint8)
    want = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 16,
                            max_nodes=M)
    got = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 16,
                           max_nodes=M, plan={"fg": 2, "ng": 3,
                                              "n_chunks": 4})
    assert torch.equal(got, want)
