"""K1/K3's launch shapes (gbdt/hist.py: float_plan, check_float_plan), on
the CPU: every plan covers each (slot, feature) of the histogram and each
row once, fits one block's shared memory, keeps its grid in range, and
passes its own checker; the checker refuses, before any launch, a plan
that does not cover, does not fit or has bad threads (ValueError). Past
the shared node lookup's cap the plans take the global lookup kind; past
one tile's bins their tiles hold ranges of bins
(tests/test_torch_hist_ranges.py holds those plans at every kind).
The plans are pure integer arithmetic, so every check is exact."""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.gbdt import hist

SM = 132
NS = (1, 2, 7, 32, 42, 64)
FS = (7, 28)
BS = (64, 256, 1024)
ROWS = {"ragged": 70001, "padded": 10_502_144}


def cap(B):
    """The largest max_nodes whose lookup fits beside a 1 x 1 tile."""
    return (hist.SMEM_MAX - 12 * B) // 16 * 4


def _cells(plan, N, F, n):
    """The (slot, feature) pairs and the rows each block covers."""
    pairs, rows = [], []
    if plan["kind"] == "red":
        pairs = [(s, f) for s in range(N) for f in range(F)]
    else:
        fg, ng, nf = plan["fg"], plan["ng"], plan["n_ftiles"]
        for t in range(plan["n_tiles"]):
            f0, s0 = (t % nf) * fg, (t // nf) * ng
            pairs += [(s, f) for s in range(s0, min(N, s0 + ng))
                      for f in range(f0, min(F, f0 + fg))]
    rpc = plan["rows_per_chunk"]
    for c in range(plan["n_chunks"]):
        rows.append((c * rpc, min(n, (c + 1) * rpc)))
    return pairs, rows


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("nodes", ["wave", "cap"])
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("N", NS)
def test_float_plan_covers_fits_and_checks(N, F, B, nodes, rows, gather):
    M = 2 * N + 3 if nodes == "wave" else cap(B)
    n = ROWS[rows] if not gather else -(-ROWS[rows] // 64)
    plan = hist.float_plan(N, F, B, M, n, SM, gather)
    assert plan["kind"] in hist.FLOAT_KINDS
    if gather:
        assert plan["kind"] == "red"  # K3 takes the red kind only
    # every (slot, feature) once, every row once
    pairs, spans = _cells(plan, N, F, n)
    assert sorted(pairs) == [(s, f) for s in range(N) for f in range(F)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans)  # no empty chunk
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))
    assert plan["rows_per_chunk"] % 4 == 0  # the four-row path can run
    # shared memory: what the kernel needs, within one block's limit
    need = (hist._lut_bytes(M, N) if plan["kind"] == "red"
            else hist.tile_bytes(N, plan["ng"], plan["fg"], B, M))
    assert plan["smem"] == need <= hist.SMEM_MAX
    # the grid and the block
    assert 1 <= plan["n_chunks"] <= 65535
    assert 1 <= plan["n_tiles"] <= 2 ** 31 - 1
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    if plan["kind"] == "tile":  # the whole histogram in one tile
        assert plan["n_tiles"] == 1
    if plan["kind"] == "auto":  # tile or red, by the wave's rows
        assert 1 < plan["n_tiles"] < F * hist.RED_WEIGHT
    if plan["kind"] == "red" and not gather:  # red whatever the wave holds
        ng, fg = hist._float_tile(N, F, B, M)
        assert -(-N // ng) * -(-F // fg) >= F * hist.RED_WEIGHT
    # the checker takes the planner's output as it is, and its short form
    assert hist.check_float_plan(plan, N, F, B, M, n, gather) == plan
    short = {k: plan[k] for k in ("kind", "fg", "ng", "threads",
                                  "rows_per_chunk")}
    assert hist.check_float_plan(short, N, F, B, M, n, gather) == plan


@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("gather", [False, True])
def test_past_the_cap_and_past_one_tile_plans_bin_ranges(B, gather):
    """Past the shared lookup's cap the plan takes the global kind: no
    shared memory for the lookup, every (slot, feature) and row covered,
    its own checker passes; the cap itself keeps the shared kind. Bins
    past one tile (B = 2^15) plan too: K1's tiles cut into two bin ranges
    at most (so the planner takes red), K3 red, every plan passing its
    checker, a red plan over one range."""
    M = cap(B) + 4
    assert hist.lookup_kind(B, cap(B)) == "shared"
    assert hist.lookup_kind(B, M) == "global"
    plan = hist.float_plan(7, 28, B, M, 1000, SM, gather)
    pairs, spans = _cells(plan, 7, 28, 1000)
    assert sorted(pairs) == [(s, f) for s in range(7) for f in range(28)]
    assert spans[0][0] == 0 and spans[-1][1] == 1000
    need = (0 if plan["kind"] == "red"
            else plan["ng"] * plan["fg"] * B * 12)
    assert plan["smem"] == need == (
        0 if plan["kind"] == "red"
        else hist.tile_bytes(7, plan["ng"], plan["fg"], B, M))
    assert hist.check_float_plan(plan, 7, 28, B, M, 1000, gather) == plan
    red = hist.check_float_plan({"kind": "red", "n_chunks": 1}, 7, 28, B, M,
                                1000, gather)
    assert red["smem"] == 0 and red["nb"] == 1
    wide = 1 << 15
    assert hist.bin_ranges(wide) == 2
    for p in (hist.float_plan(7, 28, wide, M, 1000, SM, gather),
              hist.check_float_plan({"kind": "red", "n_chunks": 1}, 7, 28,
                                    wide, M, 1000, gather)):
        assert p["kind"] == "red" and p["nb"] == 1 and p["smem"] == 0
        assert hist.check_float_plan(p, 7, 28, wide, M, 1000, gather) == p
    hist.float_plan(7, 28, B, cap(B), 1000, SM, gather)  # the cap itself fits


def _tile(N=32, F=28, B=256, M=65, n=70001):
    return hist.float_plan(N, F, B, M, n, SM), (N, F, B, M, n)


@pytest.mark.parametrize("bad,match", [
    ({"n_ftiles": 1}, "does not cover the histogram"),
    ({"n_tiles": 1}, "does not cover the histogram"),
    ({"rows_per_chunk": 100, "n_chunks": 3}, "does not cover the rows"),
    ({"n_chunks": 70001, "rows_per_chunk": 1}, r"not in \[1, 65535\]"),
    ({"fg": 28, "ng": 32, "n_ftiles": None, "n_tiles": None,
      "smem": None}, "shared memory"),
    ({"smem": 1024}, "smem"),
    ({"threads": 33}, "threads"),
    ({"threads": 2048}, "threads"),
    ({"fg": 0}, ">= 1"),
    ({"kind": "mxu"}, "kind must be one of"),
    ({"tile": 3}, "unknown fields"),
])
def test_check_float_plan_refuses_a_tile(bad, match):
    """A tile plan (N = 16: the planner's) with one field made wrong."""
    plan, (N, F, B, M, n) = _tile(N=16)
    assert plan["kind"] == "auto"
    plan = {k: v for k, v in dict(plan, **bad).items() if v is not None}
    with pytest.raises(ValueError, match=match):
        hist.check_float_plan(plan, N, F, B, M, n)


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("bad,match", [
    ({"fg": 7}, "does not cover the histogram"),
    ({"ng": 1}, "does not cover the histogram"),
    ({"n_tiles": 2}, "does not cover the histogram"),
    ({"rows_per_chunk": 10, "n_chunks": 2}, "does not cover the rows"),
    ({"threads": 0}, "threads"),
    ({"threads": 1056}, "threads"),
    ({"smem": 16}, "smem"),
    ({"rows_per_chunk": None, "n_chunks": None}, "rows_per_chunk or"),
])
def test_check_float_plan_refuses_a_red_plan(gather, bad, match):
    N, F, B, M, n = 64, 28, 256, 129, 70001
    plan = dict(hist.float_plan(N, F, B, M, n, SM, True), **bad)
    plan = {k: v for k, v in plan.items() if v is not None}
    with pytest.raises(ValueError, match=match):
        hist.check_float_plan(plan, N, F, B, M, n, gather)


def test_k3_takes_the_red_kind_only():
    plan, (N, F, B, M, n) = _tile(N=8)
    with pytest.raises(ValueError, match=r"kind must be one of \('red',\)"):
        hist.check_float_plan(plan, N, F, B, M, n, gather=True)
    short = {"n_chunks": 4}  # the kind defaults to red for K3
    assert hist.check_float_plan(short, N, F, B, M, n, True)["kind"] == "red"
    with pytest.raises(ValueError, match="must be >= 1"):  # K1: a tile
        hist.check_float_plan(short, N, F, B, M, n)


def test_the_planner_takes_tiles_for_narrow_waves_and_auto_for_wide():
    """At Higgs width (F = 28, B = 256): the root wave and a wave of two
    are one tile; wider waves hold every slot in a tile of fewer features
    and pick tile or red on the device; a lookup at its cap leaves 1 x 1
    tiles, so red. Blocks come in whole waves, nearly."""
    n = 10_502_144
    plans = {N: hist.float_plan(N, 28, 256, 2 * N + 1, n, SM)
             for N in (1, 2, 8, 16, 32, 42, 64)}
    assert [plans[N]["kind"] for N in sorted(plans)] == \
        ["tile"] * 2 + ["auto"] * 5
    assert [(plans[N]["ng"], plans[N]["fg"]) for N in sorted(plans)] == \
        [(1, 28), (2, 28), (8, 7), (16, 4), (32, 2), (42, 1), (64, 1)]
    for N, p in plans.items():
        res = (2 if p["threads"] == hist.THREADS else 1) * SM
        blocks = p["n_tiles"] * p["n_chunks"]
        assert blocks >= res
        assert blocks % res == 0 or blocks % res > res - p["n_tiles"]
    assert hist.float_plan(64, 28, 256, 57_344, n, SM)["kind"] == "red"


def _inputs(n, F, B, N, M, seed):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, size=(F, n)).astype(np.uint8))
    pos = torch.from_numpy(rng.randint(-1, M, size=n).astype(np.int32))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy(rng.rand(n).astype(np.float32))
    ids = torch.from_numpy(rng.choice(M, size=N, replace=False)
                           .astype(np.int32))
    return bins, pos, g, h, ids


@pytest.mark.parametrize("plan", [
    {"kind": "tile", "fg": 2, "ng": 3, "rows_per_chunk": 100},
    {"kind": "red", "n_chunks": 7, "threads": 256},
])
def test_explicit_float_plans_give_the_same_sums_on_the_cpu(plan):
    """On the CPU an explicit plan is checked and the plain version runs:
    the sums do not depend on the plan."""
    n, F, B, N, M = 999, 5, 16, 6, 15
    bins, pos, g, h, ids = _inputs(n, F, B, N, M, 3)
    want = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M)
    got = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M, plan=plan)
    assert torch.equal(got, want)
    if plan["kind"] == "red":
        rows = bins.t().contiguous()
        idx = torch.arange(0, n, 3, dtype=torch.int32)
        li = idx.long()
        args = (rows, idx, pos[li], g[li], h[li], ids, B)
        assert torch.equal(
            hist.hist_wave_gather_mxu(*args, max_nodes=M, plan=plan),
            hist.hist_wave_gather_mxu(*args, max_nodes=M))


def test_a_bad_float_plan_raises_before_the_plain_version():
    """The wrappers check an explicit plan on the CPU too, so a plan that
    would not launch on the card is not hidden by the plain version."""
    n, F, B, N, M = 500, 4, 256, 64, 200
    bins, pos, g, h, ids = _inputs(n, F, B, N, M, 4)
    before = hist.hist_wave.launches
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                       plan={"fg": 4, "ng": 64, "rows_per_chunk": 512})
    rows = bins.t().contiguous()
    idx = torch.arange(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="kind must be one of"):
        hist.hist_wave_gather(rows, idx, pos, g, h, ids, B, mode="mxu",
                              max_nodes=M, plan={"kind": "tile", "fg": 1,
                                                 "ng": 1, "n_chunks": 1})
    assert hist.hist_wave.launches == before
