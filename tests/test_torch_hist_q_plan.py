"""K2/K4's launch shapes (gbdt/hist.py: q_plan, check_q_plan) and the
exactness bounds of their lanes, on the CPU: every plan covers each (slot,
feature) of the histogram and each row once, fits one block's shared
memory, keeps its grid in range and each packed lane within its bits at
|g| = |h| = 127, and passes its own checker; the checker refuses, before
any launch, a plan that does not cover, does not fit or has bad threads
(ValueError), and past the node lookup's cap raises check_tile_fits'
NotImplementedError. The plans are pure integer arithmetic, so every check
is exact."""

import inspect

import numpy as np
import pytest
import torch

from ytklearn_tpu_torch.gbdt import engine, hist

SM = 132
NS = (1, 2, 7, 32, 42, 64)
FS = (7, 28)
BS = (64, 256, 1024)
ROWS = {"ragged": 70001, "padded": 10_502_144}
INT32_MAX = 2 ** 31 - 1


def cap(B):
    """The largest max_nodes whose lookup fits beside a 1 x 1 tile."""
    return (hist.SMEM_MAX - 12 * B) // 16 * 4


def _cells(plan, N, F, n):
    """The (slot, feature) pairs and the row spans the plan's blocks
    cover."""
    fg, ng, nf = plan["fg"], plan["ng"], plan["n_ftiles"]
    pairs = []
    for t in range(plan["n_tiles"]):
        f0, s0 = (t % nf) * fg, (t // nf) * ng
        pairs += [(s, f) for s in range(s0, min(N, s0 + ng))
                  for f in range(f0, min(F, f0 + fg))]
    rpc = plan["rows_per_chunk"]
    spans = [(c * rpc, min(n, (c + 1) * rpc)) for c in range(plan["n_chunks"])]
    return pairs, spans


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("nodes", ["wave", "cap"])
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("N", NS)
def test_q_plan_covers_fits_and_checks(N, F, B, nodes, rows, gather):
    M = 2 * N + 3 if nodes == "wave" else cap(B)
    n = ROWS[rows] if not gather else -(-ROWS[rows] // 64)
    plan = hist.q_plan(N, F, B, M, n, SM, gather)
    assert plan["kind"] in hist.Q_KINDS
    # K4's pack pass gathers its rows (which are the wave's): a tile of
    # one feature and K2's slots, in at most Q_STORE_CHUNKS chunks
    if gather and plan["kind"] != "red":
        k2 = hist.q_plan(N, F, B, M, n, SM, False)
        assert plan["kind"] == "tile" and plan["fg"] == 1
        assert plan["ng"] == hist._q_tile(N, F, B)[0] == k2["ng"]
        assert plan["n_chunks"] <= hist.Q_STORE_CHUNKS
    # every (slot, feature) once, every row once
    pairs, spans = _cells(plan, N, F, n)
    assert sorted(pairs) == [(s, f) for s in range(N) for f in range(F)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans)  # no empty chunk
    assert all(spans[i][1] == spans[i + 1][0] for i in range(len(spans) - 1))
    assert plan["rows_per_chunk"] % 4 == 0  # the four-row path can run
    # shared memory: what the kernel needs, within one block's limit; the
    # pack pass holds the lookup, so a tile or red block does not
    need = 0 if plan["kind"] == "red" else \
        hist.q_tile_bytes(plan["ng"], plan["fg"], B)
    assert plan["smem"] == need <= hist.SMEM_MAX
    assert hist._lut_bytes(M, N) <= hist.SMEM_MAX  # the pack pass's lookup
    # the packed word's 16-bit slot field holds every slot, 0xFFFF none
    assert N < hist.Q_MAX_SLOTS
    # the grid and the block
    assert 1 <= plan["n_chunks"] <= 65535
    assert 1 <= plan["n_tiles"] <= 2 ** 31 - 1
    assert plan["threads"] % 32 == 0 and 32 <= plan["threads"] <= 1024
    if plan["kind"] == "tile" and not gather:  # the histogram in one tile
        assert plan["n_tiles"] == 1
    if plan["kind"] == "auto":  # tile or red, by the wave's rows
        assert 1 < plan["n_tiles"] < F * hist.Q_RED_WEIGHT
    if plan["kind"] != "red":  # at most one wave of resident blocks
        per_sm = 2 if plan["threads"] == hist.THREADS else 1
        assert plan["n_tiles"] * plan["n_chunks"] <= \
            max(per_sm * SM, plan["n_tiles"])
    if plan["kind"] == "red":  # red whatever the wave holds
        ng, fg = hist._q_tile(N, F, B, gather)
        assert -(-N // ng) * -(-F // fg) >= F * hist.Q_RED_WEIGHT
    # the checker takes the planner's output as it is, and its short form
    assert hist.check_q_plan(plan, N, F, B, M, n) == plan
    short = {k: plan[k] for k in ("kind", "fg", "ng", "threads",
                                  "rows_per_chunk")}
    assert hist.check_q_plan(short, N, F, B, M, n) == plan


@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("gather", [False, True])
def test_q_past_the_cap_raises_as_check_tile_fits(B, gather):
    M = cap(B) + 4
    with pytest.raises(NotImplementedError) as want:
        hist.check_tile_fits(B, M)
    for call in (lambda: hist.q_plan(7, 28, B, M, 1000, SM, gather),
                 lambda: hist.check_q_plan({"kind": "red", "n_chunks": 1},
                                           7, 28, B, M, 1000)):
        with pytest.raises(NotImplementedError, match=r"ROADMAP.md 1\.8") \
                as got:
            call()
        assert str(got.value) == str(want.value)
    hist.q_plan(7, 28, B, cap(B), 1000, SM, gather)  # the cap itself fits


def test_the_lookup_cap_keeps_every_slot_in_the_packed_word():
    """A wave wider than the 16-bit slot field cannot pass check_tile_fits:
    its lookup alone (N entries) would not fit shared memory."""
    for B in (1, 16, 256):
        widest = (hist.SMEM_MAX - 12 * B) // 4
        assert widest < hist.Q_MAX_SLOTS
        with pytest.raises(NotImplementedError):
            hist.q_plan(hist.Q_MAX_SLOTS, 1, B, 8, 100, SM)


@pytest.mark.parametrize("g", [-127, 127])
def test_lanes_hold_the_saturating_sums(g):
    """The bounds the kernels rely on (csrc/hist.cu): g and h fit their
    int8 lanes; over Q_MAX_ROWS rows at |g| = |h| = 127 every sum (g, h and
    the count) fits int32, one row more does not; the engine's quantizer
    keeps qmax * n within int32 at every row count, so the int32 lanes
    never wrap on its gradients."""
    assert -128 <= g <= 127 and hist.Q_MAX_ABS == 127
    word = np.int8(np.uint8(np.int64(g) & 0xFF))
    assert int(word) == g  # the packed word's lane gives g back
    assert abs(g) * hist.Q_MAX_ROWS <= INT32_MAX
    assert abs(g) * (hist.Q_MAX_ROWS + 1) > INT32_MAX
    assert hist.Q_MAX_ROWS <= INT32_MAX  # the count lane
    for n in (1, 10_502_144, hist.Q_MAX_ROWS, hist.Q_MAX_ROWS + 1, 10 ** 9):
        qmax = min(127, INT32_MAX // n)
        assert qmax * n <= INT32_MAX and 1 <= qmax <= hist.Q_MAX_ABS
    # the table shape's saturating sums, as the card tests check them
    n = 10_502_144
    assert abs(g) * n <= INT32_MAX and n <= hist.Q_MAX_ROWS
    # engine._quantize's qmax is this rule (its int8 gradients stay within
    # the lanes at any row count)
    src = inspect.getsource(engine._quantize)
    assert "min(127, (2 ** 31 - 1) // max(n, 1))" in src


def _tile(N=32, F=28, B=256, M=65, n=70001):
    return hist.q_plan(N, F, B, M, n, SM), (N, F, B, M, n)


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
def test_check_q_plan_refuses_a_tile(bad, match):
    """A tile plan (N = 16: the planner's) with one field made wrong."""
    plan, (N, F, B, M, n) = _tile(N=16)
    assert plan["kind"] == "auto"
    plan = {k: v for k, v in dict(plan, **bad).items() if v is not None}
    with pytest.raises(ValueError, match=match):
        hist.check_q_plan(plan, N, F, B, M, n)


@pytest.mark.parametrize("n", [70001, 164_864])
@pytest.mark.parametrize("bad,match", [
    ({"fg": 7}, "does not cover the histogram"),
    ({"ng": 1}, "does not cover the histogram"),
    ({"n_tiles": 2}, "does not cover the histogram"),
    ({"rows_per_chunk": 10, "n_chunks": 2}, "does not cover the rows"),
    ({"threads": 0}, "threads"),
    ({"threads": 1056}, "threads"),
    ({"rows_per_chunk": None, "n_chunks": None}, "rows_per_chunk or"),
])
def test_check_q_plan_refuses_a_red_plan(n, bad, match):
    N, F, B, M = 64, 28, 256, 129
    plan = hist.check_q_plan({"kind": "red", "n_chunks": 64}, N, F, B, M, n)
    assert plan["kind"] == "red" and (plan["fg"], plan["ng"]) == (F, N)
    plan = {k: v for k, v in dict(plan, **bad).items() if v is not None}
    with pytest.raises(ValueError, match=match):
        hist.check_q_plan(plan, N, F, B, M, n)


@pytest.mark.parametrize("smem", [0, 4096, None])
def test_red_plans_need_no_shared_memory(smem):
    """The pack pass holds the node lookup, so a red block needs none; a
    plan that names more passes and is completed to 0."""
    N, F, B, M, n = 64, 28, 256, 129, 70001
    plan = {"kind": "red", "n_chunks": 4, "smem": smem}
    got = hist.check_q_plan({k: v for k, v in plan.items() if v is not None},
                            N, F, B, M, n)
    assert got["smem"] == 0 and got["kind"] == "red"


def test_check_q_plan_kinds():
    """The planner's auto plan passes as it is; a plan with no kind is a
    tile (so it names fg and ng); no kind but K2/K4's three passes."""
    plan, (N, F, B, M, n) = _tile(N=8)
    assert plan["kind"] == "auto"
    assert hist.check_q_plan(plan, N, F, B, M, n) == plan
    short = {"n_chunks": 4}
    with pytest.raises(ValueError, match="must be >= 1"):
        hist.check_q_plan(short, N, F, B, M, n)
    with pytest.raises(ValueError, match="kind must be one of"):
        hist.check_q_plan(dict(short, kind="mxu"), N, F, B, M, n)


def test_the_q_planner_at_higgs_width():
    """At Higgs width (F = 28, B = 256): the root wave and a wave of two
    are one tile; wider waves hold every slot in a tile of fewer features
    and pick tile or red on the device. One item a resident block: fewer
    idle blocks than a chunk has tiles. K4 at the first fused rung: one
    feature a tile, every slot, at most Q_STORE_CHUNKS chunks."""
    n = 10_502_144
    plans = {N: hist.q_plan(N, 28, 256, 2 * N + 1, n, SM)
             for N in (1, 2, 8, 16, 32, 42, 64)}
    assert [plans[N]["kind"] for N in sorted(plans)] == \
        ["tile"] * 2 + ["auto"] * 5
    assert [(plans[N]["ng"], plans[N]["fg"]) for N in sorted(plans)] == \
        [(1, 28), (2, 28), (8, 7), (16, 4), (32, 2), (42, 1), (64, 1)]
    for N, p in plans.items():
        res = (2 if p["threads"] == hist.THREADS else 1) * SM
        blocks = p["n_tiles"] * p["n_chunks"]
        assert res - p["n_tiles"] < blocks <= res
        assert p["smem"] == hist.q_tile_bytes(p["ng"], p["fg"], 256)
    k4 = {N: hist.q_plan(N, 28, 256, 2 * N + 1, 164_864, SM, True)
          for N in (1, 8, 64)}
    assert [(p["kind"], p["ng"], p["fg"], p["n_chunks"])
            for p in k4.values()] == [("tile", 1, 1, 8), ("tile", 8, 1, 8),
                                      ("tile", 64, 1, 4)]


def _inputs(n, F, B, N, M, seed):
    rng = np.random.RandomState(seed)
    bins = torch.from_numpy(rng.randint(0, B, size=(F, n)).astype(np.uint8))
    pos = torch.from_numpy(rng.randint(-1, M, size=n).astype(np.int32))
    gq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.float32))
    hq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.float32))
    ids = torch.from_numpy(rng.choice(M, size=N, replace=False)
                           .astype(np.int32))
    return bins, pos, gq, hq, ids


@pytest.mark.parametrize("plan", [
    {"kind": "tile", "fg": 2, "ng": 3, "rows_per_chunk": 100},
    {"kind": "auto", "fg": 5, "ng": 1, "n_chunks": 3},
    {"kind": "red", "n_chunks": 7, "threads": 256},
])
def test_explicit_q_plans_give_the_same_sums_on_the_cpu(plan):
    """On the CPU an explicit plan is checked and the plain version runs:
    the sums do not depend on the plan."""
    n, F, B, N, M = 999, 5, 16, 6, 15
    bins, pos, gq, hq, ids = _inputs(n, F, B, N, M, 3)
    want = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M, plan=plan)
    assert torch.equal(got, want)
    if plan["kind"] == "red":
        rows = bins.t().contiguous()
        idx = torch.arange(0, n, 3, dtype=torch.int32)
        li = idx.long()
        args = (rows, idx, pos[li], gq[li], hq[li], ids, B)
        assert torch.equal(
            hist.hist_wave_gather(*args, max_nodes=M, plan=plan),
            hist.hist_wave_gather(*args, max_nodes=M))


def test_a_bad_q_plan_raises_before_the_plain_version():
    """The wrappers check an explicit plan on the CPU too, so a plan that
    would not launch on the card is not hidden by the plain version."""
    n, F, B, N, M = 500, 4, 256, 64, 200
    bins, pos, gq, hq, ids = _inputs(n, F, B, N, M, 4)
    before = (hist.hist_wave_q.launches, hist.hist_wave_gather.launches)
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M,
                         plan={"fg": 4, "ng": 64, "rows_per_chunk": 512})
    rows = bins.t().contiguous()
    idx = torch.arange(n, dtype=torch.int32)
    with pytest.raises(ValueError, match="kind must be one of"):
        hist.hist_wave_gather(rows, idx, pos, gq, hq, ids, B, max_nodes=M,
                              plan={"kind": "mxu", "fg": 1, "ng": 1,
                                    "n_chunks": 1})
    assert (hist.hist_wave_q.launches,
            hist.hist_wave_gather.launches) == before
