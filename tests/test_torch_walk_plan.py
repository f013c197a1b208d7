"""K6's and K7's launch shape (serve/kernels.py: walk_plan,
check_walk_plan) and K6's node records on the CPU.

walk_plan is integer arithmetic, so every check is exact. The schedule
checks replay the kernel's index arithmetic (csrc/heap_walk.cu): row
tiles of `rows` rows, chunks of `chunk` trees, walk threads taking pairs
p = tl * nr + r at WALK_UNROLL chains a thread, and the fold warps adding
each chunk in tree order. The kernel itself runs only on the card:
tests/test_torch_cuda.py holds it equal to the plain versions."""

import numpy as np
import pytest
import torch

from ytklearn_tpu_torch.serve import kernels

SM = 132
RUNGS = (1, 8, 64, 512, 513)
TREES = (1, 8, 24, 504, 4096, 20000)
WIDTHS = (1, 28, 1000, 4094)


def _pairs(nc, nr, plan):
    """(tree in chunk, row in tile) of every pair the walk threads store,
    in the kernel's order: thread w, pass j, chain u takes
    p = w + (j * WALK_UNROLL + u) * n_walk."""
    n_walk = plan["threads"] - plan["fold"]
    step = kernels.WALK_UNROLL * n_walk
    out = []
    for w in range(n_walk):
        for p0 in range(w, nc * nr, step):
            for u in range(kernels.WALK_UNROLL):
                p = p0 + u * n_walk
                if p < nc * nr:
                    out.append(divmod(p, nr))
    return out


def _covers_once(plan, B, T):
    """Every (row, tree) pair walked once, and each row's fold over the
    trees in ascending order."""
    R, C = plan["rows"], plan["chunk"]
    assert plan["blocks"] == -(-B // R)
    assert plan["n_chunks"] == -(-T // C)
    tiles = [min(R, B - b * R) for b in range(plan["blocks"])]
    assert sum(tiles) == B and all(nr >= 1 for nr in tiles)
    chunks = [min(C, T - k * C) for k in range(plan["n_chunks"])]
    assert sum(chunks) == T and all(nc >= 1 for nc in chunks)
    # the fold: chunk k's values in c order, chunks in k order
    order = [k * C + c for k, nc in enumerate(chunks) for c in range(nc)]
    assert order == list(range(T))
    # a (tile, chunk) shape occurs at most four ways: full or ragged each
    for nr in set(tiles):
        for nc in set(chunks):
            got = _pairs(nc, nr, plan)
            assert len(got) == nc * nr
            assert set(got) == {(t, r) for t in range(nc) for r in range(nr)}
            assert all(r < plan["rows"] for _t, r in got)


@pytest.mark.parametrize("bin_bytes", [1, 2, 8])
@pytest.mark.parametrize("T", TREES)
@pytest.mark.parametrize("B", RUNGS)
def test_walk_plan_fits_and_covers_every_pair(B, T, bin_bytes):
    for depth in range(1, kernels.HEAP_DEPTH_CAP + 1):
        for F in WIDTHS:
            p = kernels.walk_plan(B, T, depth, F, bin_bytes, SM)
            assert kernels.check_walk_plan(p, B, T, depth, F, bin_bytes) == p
            assert p["smem"] == kernels.walk_smem(p["rows"], p["chunk"], F,
                                                  bin_bytes)
            assert p["smem"] <= kernels.SMEM_MAX == 232448
            assert p["threads"] % 32 == 0
            assert p["fold"] + 32 <= p["threads"] <= kernels.WALK_MAX_THREADS
            assert p["fold"] >= p["rows"]  # one fold thread a row
            assert 1 <= p["rows"] <= kernels.WALK_MAX_ROWS
            assert 1 <= p["chunk"] <= min(max(T, 1), kernels.WALK_CHUNK_CAP)
            # the grid: at least min(SMs, row tiles), one block a tile
            assert p["blocks"] >= min(SM, -(-B // p["rows"]))
            if F <= 1000:  # rows fit: one row a block up to the SM count
                assert p["rows"] == max(1, min(kernels.WALK_MAX_ROWS,
                                               -(-B // SM)))
        # the schedule at one width (it does not depend on F or depth)
        _covers_once(kernels.walk_plan(B, T, 6, 28, bin_bytes, SM), B, T)


def test_walk_plan_at_the_serving_rungs():
    """Rung 1 is one block walking all 504 trees in one chunk; rung 512
    covers the SMs with 128 tiles of 4 rows; a 20,000-tree model is
    chunks of WALK_CHUNK_CAP trees."""
    p1 = kernels.walk_plan(1, 504, 6, 28, 8, SM)
    assert (p1["rows"], p1["chunk"], p1["blocks"], p1["n_chunks"]) == \
        (1, 504, 1, 1)
    p512 = kernels.walk_plan(512, 504, 6, 28, 8, SM)
    assert (p512["rows"], p512["blocks"]) == (4, 128)
    p = kernels.walk_plan(1, 20000, 6, 28, 8, SM)
    assert (p["chunk"], p["n_chunks"]) == (kernels.WALK_CHUNK_CAP,
                                           -(-20000 // kernels.WALK_CHUNK_CAP))
    # wide f64 rows take shared memory from the tile, not from correctness
    wide = kernels.walk_plan(5000, 504, 10, 4094, 8, SM)
    assert wide["rows"] < kernels.WALK_MAX_ROWS
    assert wide["smem"] <= kernels.SMEM_MAX


@pytest.mark.parametrize("bad,match", [
    ({"rows": 0, "chunk": 8, "threads": 64}, "rows"),
    ({"rows": 1, "chunk": 0, "threads": 64}, "chunk"),
    ({"rows": 1, "chunk": 505, "threads": 64}, "chunk"),
    ({"rows": 1, "chunk": 8, "threads": 32}, "threads"),
    ({"rows": 1, "chunk": 8, "threads": 100}, "threads"),
    ({"rows": 33, "chunk": 8, "threads": 64}, "threads"),
    ({"rows": 1, "chunk": 8, "threads": 1056}, "threads"),
    ({"rows": 32, "chunk": 504, "threads": 1024}, "shared memory"),
    ({"rows": 1, "chunk": 8, "threads": 64, "smem": 1}, "smem"),
    ({"rows": 4, "chunk": 8, "threads": 64, "blocks": 1}, "blocks"),
])
def test_check_walk_plan_refuses(bad, match):
    with pytest.raises(ValueError, match=match):
        kernels.check_walk_plan(bad, 512, 504, 6, 28, 8)


@pytest.mark.parametrize("args", [
    (-1, 8, 6, 28, 8), (1, -1, 6, 28, 8), (1, 8, 0, 28, 8),
    (1, 8, 11, 28, 8), (1, 8, 6, 0, 8), (1, 8, 6, 28, 4),
])
def test_walk_plan_refuses_bad_arguments(args):
    with pytest.raises(ValueError, match="walk plan"):
        kernels.walk_plan(*args, SM)
    with pytest.raises(ValueError, match="sm_count"):
        kernels.walk_plan(1, 8, 6, 28, 8, 0)


def test_node_records_hold_split_feat_and_dleft():
    """One 16-byte record a slot, read by the kernel as an int4: the
    split's f64 bits, feat, dleft (little-endian), for every value a heap
    holds: +-inf pads, -0.0, NaN-free splits, feat up to 4094; and
    unpack_records gives the three arrays back bit for bit."""
    rng = np.random.RandomState(1)
    T, H = 5, 15
    split = rng.randn(T, H)
    split[0, :3] = [np.inf, -np.inf, -0.0]
    feat = rng.randint(0, 4095, (T, H)).astype(np.int32)
    dleft = rng.randint(0, 2, (T, H)).astype(np.int32)
    leaf = rng.randn(T, 8)
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, 3, T, "cpu")
    rec = ht.nodes
    assert rec.dtype == torch.int64 and tuple(rec.shape) == (T, H, 2)
    assert rec.is_contiguous()
    words = rec.numpy().view(np.int32).reshape(T, H, 4)
    np.testing.assert_array_equal(
        rec.numpy()[..., 0].view(np.float64).view(np.int64),
        split.view(np.int64))  # bit for bit, -0.0 and infinities included
    np.testing.assert_array_equal(words[..., 2], feat)
    np.testing.assert_array_equal(words[..., 3], dleft)
    back = kernels.unpack_records(rec)
    for got, want in zip(back, (feat, split, dleft)):
        assert got.dtype == torch.from_numpy(want).dtype
        assert got.is_contiguous()
        np.testing.assert_array_equal(got.numpy().view(np.uint8),
                                      want.view(np.uint8))
    assert torch.equal(rec, kernels.node_records(*back))


def test_cpu_wrappers_check_a_given_plan_and_walk_plain():
    """On CPU tensors a given plan is checked, then the plain version
    runs (no launch)."""
    rng = np.random.RandomState(2)
    T, depth, F, B = 16, 3, 4, 9
    H = (1 << (depth + 1)) - 1
    feat = rng.randint(0, F, (T, H)).astype(np.int32)
    split = np.round(rng.randn(T, H), 1)
    dleft = rng.randint(0, 2, (T, H)).astype(np.int32)
    leaf = rng.randn(T, 1 << depth)
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, depth, T, "cpu")
    X = torch.from_numpy(np.round(rng.randn(B, F), 1))
    args = (X, ht.nodes, ht.leaf, depth)
    ok = {"rows": 2, "chunk": 5, "threads": 64}
    before = kernels.heap_walk.launches
    got = kernels.heap_walk(*args, plan=ok)
    want = kernels.heap_walk_plain(
        X, *(torch.from_numpy(a) for a in (feat, split, dleft)), ht.leaf,
        depth)
    assert torch.equal(got, want)
    assert kernels.heap_walk.launches == before
    with pytest.raises(ValueError, match="chunk"):
        kernels.heap_walk(*args, plan={"rows": 2, "chunk": 17,
                                       "threads": 64})
    bins = torch.from_numpy(rng.randint(0, 255, (B, F)).astype(np.uint8))
    packed = torch.from_numpy(
        (feat.astype(np.int64) | (rng.randint(0, 256, (T, H)) << 12)
         ).astype(np.int32))
    got = kernels.binned_walk(bins, packed, ht.leaf, depth, 255, plan=ok)
    assert torch.equal(got, kernels.binned_walk_plain(bins, packed, ht.leaf,
                                                      depth, 255))
    with pytest.raises(ValueError, match="threads"):
        kernels.binned_walk(bins, packed, ht.leaf, depth, 255,
                            plan={"rows": 2, "chunk": 5, "threads": 48})
