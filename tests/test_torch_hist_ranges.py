"""K1-K4 past one shared-memory tile of bins (gbdt/hist.py: bin_ranges,
range_bins and the planners and checkers with `nb`), on the CPU.

Planners at B = 20,000, 2^15 and 2^16, for K1-K4 and every kind their
checkers take: a tile holds one slot x feature x one of the fewest equal
bin ranges that fit (2 ranges at 20,000 and 2^15, 4 at 2^16), the tiles
cover each (slot, feature, bin) once, every plan fits SMEM_MAX and passes
its checker; red plans cover every bin in one range. A replay of the
kernels' item walk (tile = (slot tile, bin range, feature tile), the flush
at bin b0 + i) in numpy adds up to the plain version. Each plain version
at B = 2^15 and 2^16 against the JAX package's CPU path (dense einsums,
the gather forms too), on a small wave with a duplicated id and a pad:
int8 exact, f32/bf16 at HIST_RTOL (rtol 1e-5, atol 1e-5 of the largest
|sum|), counts exact. The plans are pure integer arithmetic, so every plan
check is exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.gbdt import hist as jhist
from ytklearn_tpu_torch.gbdt import hist

SM = 132
WIDE = (20_000, 1 << 15, 1 << 16)
NS = (1, 2, 16, 64)
FS = (2, 28)
HIST_RTOL = 1e-5


def _spans(count, width, total):
    return [(i * width, min(total, (i + 1) * width)) for i in range(count)]


def _partition(spans, total):
    """The spans cover [0, total) once, none empty."""
    assert spans[0][0] == 0 and spans[-1][1] == total
    assert all(a < b for a, b in spans)
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))


def _tiles(plan, N, F):
    """(slot tile, bin range, feature tile) of every tile, as the kernels
    decode a tile index: feature tile fastest, then range, then slots."""
    nf, nb = plan["n_ftiles"], plan["nb"]
    out = []
    for t in range(plan["n_tiles"]):
        rest = t // nf
        out.append((rest // nb, rest % nb, t % nf))
    return out


def _check_covers(plan, N, F, B, n):
    """Every (slot, feature, bin) in one tile, every row in one chunk."""
    nb = plan["nb"]
    bt = hist.range_bins(B, nb)
    _partition(_spans(nb, bt, B), B)
    if plan["kind"] == "red":
        assert (plan["ng"], plan["fg"], nb, plan["n_tiles"]) == (N, F, 1, 1)
    else:
        n_st = -(-N // plan["ng"])
        assert plan["n_ftiles"] == -(-F // plan["fg"])
        assert plan["n_tiles"] == plan["n_ftiles"] * n_st * nb
        _partition(_spans(n_st, plan["ng"], N), N)
        _partition(_spans(plan["n_ftiles"], plan["fg"], F), F)
        assert sorted(_tiles(plan, N, F)) == [
            (s, b, f) for s in range(n_st) for b in range(nb)
            for f in range(plan["n_ftiles"])]
        assert plan["smem"] == plan["ng"] * plan["fg"] * bt * 12
    assert plan["smem"] <= hist.SMEM_MAX
    _partition(_spans(plan["n_chunks"], plan["rows_per_chunk"], n), n)
    assert 1 <= plan["n_chunks"] <= 65535
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024


def test_bin_ranges_are_one_below_one_tile():
    cap = hist.SMEM_MAX // 12
    assert cap == 19_370
    for B in (1, 256, 1024, 8192, cap):
        assert hist.bin_ranges(B) == 1 and hist.range_bins(B, 1) == B
    assert [hist.bin_ranges(B) for B in (cap + 1, 20_000, 1 << 15,
                                         1 << 16)] == [2, 2, 2, 4]
    assert [hist.range_bins(B, hist.bin_ranges(B))
            for B in (20_000, 1 << 15, 1 << 16)] == [10_000, 16_384, 16_384]
    for B in (20_000, 1 << 15, 1 << 16, 1 << 20):
        nb = hist.bin_ranges(B)
        assert hist.range_bins(B, nb) * 12 <= hist.SMEM_MAX
        assert nb == 1 or -(-B // (nb - 1)) * 12 > hist.SMEM_MAX  # fewest
        assert hist.lookup_kind(B, 1) == "global"


@pytest.mark.parametrize("B,nb,match", [
    (10, 0, r"in \[1, B"), (10, 11, r"in \[1, B"), (10, 6, "empty")])
def test_range_bins_refuses_ranges_that_do_not_cover(B, nb, match):
    with pytest.raises(ValueError, match=match):
        hist.range_bins(B, nb)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("M", [61, 200_001])
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("B", WIDE)
def test_wide_planners_cover_fit_and_check(B, N, F, M, gather):
    """float_plan (K1 / K3) and q_plan (K2 / K4) at wide B: coverage,
    shared memory, and the checkers take the planners' output and its
    short form."""
    n = 1 << 19 if not gather else 65_536
    fp = hist.float_plan(N, F, B, M, n, SM, gather)
    qp = hist.q_plan(N, F, B, M, n, SM, gather)
    for plan, check in ((fp, lambda p: hist.check_float_plan(
            p, N, F, B, M, n, gather)),
            (qp, lambda p: hist.check_q_plan(p, N, F, B, M, n))):
        _check_covers(plan, N, F, B, n)
        assert check(plan) == plan
        short = {k: plan[k] for k in ("kind", "fg", "ng", "threads",
                                      "rows_per_chunk")}
        assert check(short) == plan
        if plan["kind"] != "red":
            assert plan["nb"] == hist.bin_ranges(B)
    if gather:
        assert fp["kind"] == "red"  # K3 takes the red kind only
        assert qp["kind"] == "red" or qp["fg"] == 1  # K4: one feature
    # K1 past one tile: at least two ranges a feature, so its tiles cost
    # more than RED_WEIGHT vector atomics a row: red at any wave
    assert fp["kind"] == "red"
    if qp["kind"] != "red":
        assert qp["ng"] == 1 and qp["n_tiles"] < F * hist.Q_RED_WEIGHT \
            or gather


@pytest.mark.parametrize("B", WIDE)
@pytest.mark.parametrize("N", [1, 16, 64])
def test_every_kind_plans_at_wide_bins(B, N):
    """Explicit plans of every kind each checker takes at wide B (the card
    tests' and chip_smoke's shapes): K1 tile / auto / red, K3 red, K2 tile
    / auto / red, K4 tile / red, over the default ranges and over more;
    a tile past shared memory and one range of all B bins are refused."""
    F, M, n = 8, 61, 1 << 19
    nb = hist.bin_ranges(B)
    for kind in ("tile", "auto"):
        for ranges in (nb, nb + 1):
            plan = {"kind": kind, "fg": 1, "ng": 1, "nb": ranges,
                    "rows_per_chunk": 8192, "threads": 1024}
            fp = hist.check_float_plan(plan, N, F, B, M, n)
            qp = hist.check_q_plan(plan, N, F, B, M, n)
            for p in (fp, qp):
                _check_covers(p, N, F, B, n)
                assert p["nb"] == ranges and p["kind"] == kind
        for check in (lambda p: hist.check_float_plan(p, N, F, B, M, n),
                      lambda p: hist.check_q_plan(p, N, F, B, M, n)):
            with pytest.raises(ValueError, match="shared memory"):
                check({"kind": kind, "fg": 1, "ng": 1, "nb": 1,
                       "n_chunks": 4})
            with pytest.raises(ValueError, match="shared memory"):
                check({"kind": kind, "fg": 2, "ng": 1, "n_chunks": 4})
            with pytest.raises(ValueError, match="does not cover"):
                check({"kind": kind, "fg": 1, "ng": 1, "n_chunks": 4,
                       "n_tiles": N * F})
    for gather in (False, True):
        red = hist.check_float_plan({"kind": "red", "n_chunks": 264}, N, F,
                                    B, M, n, gather)
        _check_covers(red, N, F, B, n)
        with pytest.raises(ValueError, match="every slot, feature and bin"):
            hist.check_float_plan({"kind": "red", "n_chunks": 264, "nb": 2},
                                  N, F, B, M, n, gather)
    qred = hist.check_q_plan({"kind": "red", "n_chunks": 264}, N, F, B, M, n)
    _check_covers(qred, N, F, B, n)
    k4 = hist.check_q_plan({"kind": "tile", "fg": 1, "ng": 1,
                            "n_chunks": hist.Q_STORE_CHUNKS}, N, F, B, M,
                           65_536)
    _check_covers(k4, N, F, B, 65_536)


@pytest.mark.parametrize("B", WIDE)
def test_tile_plan_at_wide_bins(B):
    for N, F in ((1, 1), (3, 28), (64, 8)):
        plan = hist.tile_plan(N, F, B, 61, 1 << 20, SM)
        _check_covers(dict(plan, kind="tile"), N, F, B, 1 << 20)
        assert hist.check_plan(plan, N, F, B, 61, 1 << 20) == plan


def _case(n, F, B, N, seed):
    """Bins over [0, B) with every range's edges present, positions over
    2N + 3 nodes with dead rows, a duplicated id and a pad."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(np.int32)
    bt = hist.range_bins(B, hist.bin_ranges(B))
    edges = sorted({0, B - 1} | {e for i in range(1, hist.bin_ranges(B))
                                 for e in (i * bt - 1, i * bt)})
    for f in range(F):
        bins[f, :len(edges)] = edges
    M = 2 * N + 3
    pos = rng.randint(-1, M, size=n).astype(np.int32)
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    ids[N - 1] = ids[0]  # a duplicated id: the same sums in both slots
    ids = np.concatenate([ids, [-2]]).astype(np.int32)  # a pad
    pos[:len(edges)] = ids[0]
    g = (rng.randn(n) * 3).astype(np.float32)
    h = (rng.rand(n) + 0.1).astype(np.float32)
    gq = np.clip(np.round(g * 40), -127, 127).astype(np.float32)
    hq = np.clip(np.round(h * 100), -127, 127).astype(np.float32)
    return bins, pos, g, h, gq, hq, ids, M


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    scale = max(float(np.abs(want[..., :2]).max()), 1e-30)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=HIST_RTOL,
                               atol=HIST_RTOL * scale)


def _gathered(bins, pos, g, h, gq, hq, ids):
    """The engine's compaction: the wave's rows first, one dead slot."""
    sel = np.nonzero(np.isin(pos, ids[ids >= 0]))[0]
    R = len(sel) + 1
    idx = np.zeros(R, np.int32)
    idx[:-1] = sel
    out = [np.ascontiguousarray(bins.T), idx]
    for a, fill in ((pos, -1), (g, 0), (h, 0), (gq, 0), (hq, 0)):
        v = np.full(R, fill, a.dtype)
        v[:-1] = a[sel]
        out.append(v)
    return out


@pytest.mark.parametrize("which", ["k1_bf16", "k1_f32", "k2", "k3", "k4"])
@pytest.mark.parametrize("B", [1 << 15, 1 << 16])
def test_wide_plain_versions_match_jax(B, which):
    n, F, N = 512, 2, 3
    bins, pos, g, h, gq, hq, ids, M = _case(n, F, B, N, B % 97)
    j = jnp.asarray
    if which in ("k1_bf16", "k1_f32"):
        bf16 = which == "k1_bf16"
        want = jhist.hist_wave(j(bins), j(pos), j(g), j(h), j(ids), B,
                               use_bf16=bf16, force_dense=True)
        got = hist.hist_wave(_t(bins), _t(pos), _t(g), _t(h), _t(ids), B,
                             max_nodes=M, use_bf16=bf16)
    elif which == "k2":
        want = jhist.hist_wave_q(j(bins), j(pos), j(gq), j(hq), j(ids), B,
                                 force_dense=True)
        got = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids),
                               B, max_nodes=M)
    else:
        rows, idx, pg, gg, hg, gqg, hqg = _gathered(bins, pos, g, h, gq, hq,
                                                    ids)
        mode = "mxu" if which == "k3" else "int8"
        vg, vh = (gg, hg) if which == "k3" else (gqg, hqg)
        want = jhist.hist_wave_gather(j(rows), j(idx), j(pg), j(vg), j(vh),
                                      j(ids), B, mode=mode, use_bf16=False,
                                      force_dense=True)
        got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(vg),
                                    _t(vh), _t(ids), B, mode=mode,
                                    max_nodes=M, use_bf16=False)
    want = np.asarray(want)
    assert got.shape == (N + 1, F, B, 3) and want[..., 2].sum() > 0
    bt = hist.range_bins(B, hist.bin_ranges(B))
    assert want[0, :, bt - 1:bt + 1, 2].min() > 0  # both sides of a range
    if which in ("k2", "k4"):
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        _close(got.numpy(), want)
    assert torch.equal(got[0], got[N - 1])  # the duplicated id
    assert not got[N].any()  # the pad


def _replay(plan, bins, pos, gq, hq, ids, B, M, store):
    """The tile kernels' item walk in numpy (csrc/hist.cu tile_kernel):
    each item's tile over its chunk's rows, slots, features and bin range,
    then its flush (or, store mode, its partial sums) at bin b0 + i. The
    duplicated id's later slots copied as the finish kernel does."""
    F, n = bins.shape
    N = ids.shape[0]
    slot, ok = hist.node_slots(_t(pos), _t(ids), M)
    slot, ok = slot.numpy(), ok.numpy()
    nb, bt = plan["nb"], hist.range_bins(B, plan["nb"])
    fg, ng, rpc = plan["fg"], plan["ng"], plan["rows_per_chunk"]
    acc = np.zeros((N, F, B, 3), np.int64)
    partial = np.zeros((plan["n_chunks"], N, F, B, 3), np.int64)
    for item in range(plan["n_tiles"] * plan["n_chunks"]):
        tile, chunk = item % plan["n_tiles"], item // plan["n_tiles"]
        rest = tile // plan["n_ftiles"]
        f0, s0, b0 = tile % plan["n_ftiles"] * fg, rest // nb * ng, \
            rest % nb * bt
        bcnt = min(bt, B - b0)
        t = np.zeros((ng, fg, bt, 3), np.int64)
        for r in range(chunk * rpc, min(n, (chunk + 1) * rpc)):
            s = slot[r] - s0
            if not ok[r] or not 0 <= s < min(ng, N - s0):
                continue
            for fl in range(min(fg, F - f0)):
                b = bins[f0 + fl, r] - b0
                if 0 <= b < bcnt:
                    t[s, fl, b] += (int(gq[r]), int(hq[r]), 1)
        dst = partial[chunk] if store else acc
        for sl in range(min(ng, N - s0)):
            for fl in range(min(fg, F - f0)):
                dst[s0 + sl, f0 + fl, b0:b0 + bcnt] += t[sl, fl, :bcnt]
    if store:
        acc = partial.sum(0)
    first = hist._first_slots(_t(ids)).numpy()
    return acc[first].astype(np.int32)


@pytest.mark.parametrize("store", [False, True])
@pytest.mark.parametrize("nb", [1, 3, 5])
def test_replay_of_the_range_tiles_is_the_plain_version(nb, store):
    """The kernels' index arithmetic over ranges (the tile index decoded
    as (slot tile, range, feature tile), a row outside the range skipped,
    the flush or stored run at cell ((s F + f) B + b0 + i)) adds up to the
    plain version, at a small B cut into nb ranges (the last one short)."""
    B, F, N, n = 23, 3, 4, 300
    rng = np.random.RandomState(nb + 10 * store)
    bins = rng.randint(0, B, size=(F, n)).astype(np.int32)
    M = 2 * N + 3
    pos = rng.randint(-1, M, size=n).astype(np.int32)
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    ids[3] = ids[1]
    gq = rng.randint(-127, 128, size=n).astype(np.float32)
    hq = rng.randint(-127, 128, size=n).astype(np.float32)
    plan = hist.check_q_plan({"kind": "tile", "fg": 2, "ng": 3, "nb": nb,
                              "n_chunks": 3}, N, F, B, M, n)
    assert plan["n_tiles"] == 2 * 2 * nb
    want = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                            max_nodes=M).numpy()
    got = _replay(plan, bins, pos, gq, hq, ids, B, M, store)
    np.testing.assert_array_equal(got, want)
    # on the CPU an explicit range plan is checked and the plain version
    # runs: the same sums
    again = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                             max_nodes=M, plan=plan)
    np.testing.assert_array_equal(again.numpy(), want)
