"""K8's launch shape (gbdt/hist.py: u8_plan, check_u8_plan) on the CPU.

The persistent kernel (csrc/hist_u8.cu) walks items (fg features x a
chunk of rows) and, within an item, its units (feature, n-tile of PV rows,
m-group of 64-bin tiles) in rounds of U8_CONSUMERS warpgroups. `_walk`
replays that walk from the plan as the kernel's Cursor does, so each test
holds the plan to what the kernel will do: every (feature, PV row, bin,
row) is covered exactly once, the shared memory and the register budget
fit, the grid and the items stay in range, and the checker refuses a plan
that does not. Pure integer arithmetic: every check is exact."""

import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.gbdt import hist

SM = 132
NS = (1, 2, 5, 10, 11, 21, 22, 32, 33, 42, 43, 64, 65, 85, 86, 100, 171,
      597, 600)
FS = (1, 3, 28)
BS = (1, 16, 64, 65, 160, 256)
ROWS = {"ragged": 200_003, "tune": 1280 * 8192, "tiny": 777}


def _walk(plan, F, n):
    """{(feature, n-tile, m-group) -> the row spans the kernel's items
    cover with it}."""
    upf = plan["n_ntiles"] * plan["n_mgroups"]
    spans = {}
    for item in range(plan["items"]):
        fgi, chunk = item % plan["n_fgroups"], item // plan["n_fgroups"]
        f0, f1 = fgi * plan["fg"], min(F, (fgi + 1) * plan["fg"])
        r0 = chunk * plan["rows_per_block"]
        r1 = min(n, r0 + plan["rows_per_block"])
        for u in range(f0 * upf, f1 * upf):
            f, rem = divmod(u, upf)
            nt, mg = divmod(rem, plan["n_mgroups"])
            key = (f, nt, mg)
            spans.setdefault(key, []).append((r0, r1))
    return spans


def _check_cover(plan, F, N, B, n):
    W, mtw = plan["W"], plan["mtw"]
    spans = _walk(plan, F, n)
    # every feature, n-tile and m-group once a chunk, the chunks tile [0, n)
    want = {(f, nt, mg) for f in range(F) for nt in range(plan["n_ntiles"])
            for mg in range(plan["n_mgroups"])}
    assert set(spans) == want
    for key, sp in spans.items():
        sp = sorted(sp)
        assert sp[0][0] == 0 and sp[-1][1] == max(n, 0)
        assert all(a[1] == b[0] for a, b in zip(sp, sp[1:])), key
    # the n-tiles hold every PV row (c*N + s) once, the m-groups every bin
    rows = [nt * W + i for nt in range(plan["n_ntiles"]) for i in range(W)]
    assert sorted(rows) == list(range(plan["n_ntiles"] * W))
    assert plan["n_ntiles"] * W >= 3 * N > (plan["n_ntiles"] - 1) * W
    assert plan["n_mgroups"] * mtw * 64 >= B > (plan["n_mgroups"] - 1) \
        * mtw * 64


@pytest.mark.parametrize("rows", sorted(ROWS))
@pytest.mark.parametrize("B", BS)
@pytest.mark.parametrize("F", FS)
@pytest.mark.parametrize("N", NS)
def test_u8_plan_covers_fits_and_checks(N, F, B, rows):
    n = ROWS[rows]
    plan = hist.u8_plan(N, F, B, n, SM)
    _check_cover(plan, F, N, B, n)
    W, mtw = plan["W"], plan["mtw"]
    assert W in hist.U8_WIDTHS and W % 32 == 0
    # shared memory: the ring's stages (PV, the consumers' bins, two
    # mbarriers), the staged rows and the row tables
    kt = plan["kt"]
    stage = plan["regions"] * kt * W + hist.U8_CONSUMERS * kt
    raw = kt * 14 + hist.U8_CONSUMERS * kt
    assert plan["smem"] == plan["ring"] * (stage + 16) \
        + (hist.u8_ahead(kt) + 1) * raw + 2 * W * 5
    assert plan["smem"] <= hist.SMEM_MAX
    assert 2 <= plan["ring"] <= hist.U8_RING
    # the longest stage whose ring holds U8_RING_MIN stages, and a kernel
    # instance for it; the producer loads 1024 rows ahead at least
    assert (W, mtw, kt) in hist.U8_INSTANCES
    assert kt == hist.U8_KTS[-1] or plan["ring"] >= hist.U8_RING_MIN
    longer = [k for k in hist.U8_KTS if k > kt]
    assert all(hist._u8_ring(W, plan["regions"], k) < hist.U8_RING_MIN
               for k in longer)
    assert hist.u8_ahead(kt) * kt >= 1024 and hist.u8_ahead(kt) >= 2
    # registers: the accumulators and A fragments of one consumer thread
    assert mtw * W // 2 + 16 * mtw <= hist.U8_REGS
    assert mtw * W // 2 <= 128
    # the grid: persistent, at most one block an SM, no more than the items
    assert plan["blocks"] == min(plan["items"], SM)
    assert plan["items"] == plan["n_fgroups"] * plan["n_chunks"]
    assert plan["threads"] == hist.U8_THREADS == 384
    # the default fills whole rounds where a feature's units are odd
    upf = plan["n_ntiles"] * plan["n_mgroups"]
    if upf % 2 and F >= 2:
        assert plan["fg"] == 2
    else:
        assert plan["fg"] == 1
    assert plan["rows_per_block"] % kt == 0
    assert hist.check_u8_plan(dict(plan), N, F, B, n) == plan


@pytest.mark.parametrize("fg", [1, 2, 4, 7, 16])
@pytest.mark.parametrize("rows_per_block", [1, 33, 4096, 131072])
@pytest.mark.parametrize("N", [1, 32, 64, 100])
def test_u8_plan_takes_the_tools_knobs(N, fg, rows_per_block):
    """The sweep of scripts/tune_hist_kernel.py: fg features an item and
    rows_per_block rows a chunk, each taken as given and covering."""
    F, B, n = 28, 256, 2_003
    plan = hist.u8_plan(N, F, B, n, SM, fg, rows_per_block)
    assert plan["fg"] == fg and plan["rows_per_block"] == rows_per_block
    assert plan["n_chunks"] == -(-n // rows_per_block)
    _check_cover(plan, F, N, B, n)


@pytest.mark.parametrize("N,W,n_ntiles,mtw,regions", [
    (1, 32, 1, 2, 1), (10, 32, 1, 2, 1), (11, 64, 1, 2, 1),
    (32, 96, 1, 2, 1), (33, 128, 1, 1, 1), (64, 192, 1, 1, 1),
    (85, 256, 1, 1, 1), (86, 192, 2, 1, 2), (171, 192, 3, 1, 2),
    (597, 256, 7, 1, 2),
])
def test_u8_tiles_at_the_wave_widths(N, W, n_ntiles, mtw, regions):
    """3N PV rows in the fewest n-tiles of at most 256, rounded up to a
    wgmma width; two 64-bin m-tiles a consumer up to W = 96."""
    plan = hist.u8_plan(N, 28, 256, 1 << 20, SM)
    assert (plan["W"], plan["n_ntiles"], plan["mtw"], plan["regions"]) == \
        (W, n_ntiles, mtw, regions)


@pytest.mark.parametrize("sm", [1, 66, 114, 132])
@pytest.mark.parametrize("F", [1, 7, 28])
def test_u8_default_chunks_balance_the_grid(sm, F):
    """The default chunks give a makespan (items a block, in chunks) within
    2% of the best over chunks of U8_MIN_ROWS rows or more."""
    n = 1280 * 8192
    plan = hist.u8_plan(32, F, 256, n, sm)
    top = n // hist.U8_MIN_ROWS
    best = min(-(-plan["n_fgroups"] * c // sm) / c for c in range(1, top + 1))
    got = -(-plan["items"] // plan["blocks"]) / plan["n_chunks"]
    assert got <= best * 1.02 + 1e-12
    assert plan["rows_per_block"] >= min(n, hist.U8_MIN_ROWS)


@pytest.mark.parametrize("field,value,match", [
    ("W", 48, "W"), ("W", 32, "n-tiles"), ("n_ntiles", 2, "n-tiles"),
    ("mtw", 4, "m-tiles"), ("n_mgroups", 1, "m-groups"),
    ("fg", 17, "fg"), ("fg", 0, "fg"), ("n_fgroups", 3, "groups"),
    ("rows_per_block", 0, "chunks"), ("n_chunks", 1, "chunks"),
    ("items", 5, "items"), ("blocks", 0, "blocks"),
    ("blocks", 10 ** 9, "blocks"), ("regions", 2, "regions"),
    ("ring", 1, "ring"), ("smem", 1024, "shared memory"),
    ("kt", 64, "instance"), ("kt", 256, "instance"),
    ("threads", 512, "threads"),
])
def test_check_u8_plan_refuses(field, value, match):
    N, F, B, n = 32, 28, 256, 200_003
    plan = dict(hist.u8_plan(N, F, B, n, SM))
    plan[field] = value
    with pytest.raises(ValueError, match=match):
        hist.check_u8_plan(plan, N, F, B, n)


def test_check_u8_plan_refuses_a_ring_past_shared_memory():
    N, F, B, n = 600, 4, 256, 5000
    plan = dict(hist.u8_plan(N, F, B, n, SM))
    assert plan["W"] == 256 and plan["regions"] == 2
    plan["ring"] = plan["ring"] + 1
    plan["smem"] = hist._u8_smem(256, 2, plan["ring"], plan["kt"])
    with pytest.raises(ValueError, match="shared memory"):
        hist.check_u8_plan(plan, N, F, B, n)


def test_check_u8_plan_refuses_the_register_budget():
    """W = 128 with two m-tiles a consumer would hold 128 accumulators and
    32 A registers a thread, past U8_REGS."""
    N, F, B, n = 42, 28, 256, 200_003
    plan = dict(hist.u8_plan(N, F, B, n, SM))
    assert (plan["W"], plan["mtw"]) == (128, 1)
    plan.update(mtw=2, n_mgroups=2)
    with pytest.raises(ValueError, match="registers"):
        hist.check_u8_plan(plan, N, F, B, n)
