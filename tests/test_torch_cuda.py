"""The port's training and serving kernels on the card, against their
plain versions, K8 against K2, and one tiny `cli train` on cuda.

Marked `cuda`: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The int8 kernel sums (K2, K4, K8) are int32, routing (K5) is exact, the
walks (K6, K7) fold each row in tree order as their plain versions do,
and the split scans run in a fixed order, so those comparisons are exact
(torch.equal; the walks' sums bit for bit, signs of zero included), int8
trees included, and so are l1's LAD leaves at unit and integer weights
(at fractional weights a leaf may move one cell of the rank grid). The
f32/bf16 histograms (K1, K3) add floats with atomics in an order that
changes from run to run: counts are exact, g/h held at rtol 1e-5 with an
absolute floor of 1e-5 of the largest |sum|. The convex stack (plain torch, no kernel of
its own) is held to its CPU run: FM/FFM loss and gradient at rtol 1e-5,
five L-BFGS iterations with the same statuses, and `cli train` of each
family with every evaluation on the card. GBST training and every
family's serving lowering (plain torch too) are held to their CPU runs:
GBST at tests/test_torch_gbst.py's bounds, the f64 rung at rtol 1e-10,
the bf16 rung within torch_bf16_bound.py's stated bound.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ytklearn_tpu_torch.config.params import (
    ApproximateSpec,
    GBDTParams,
    ModelParams,
)
from ytklearn_tpu_torch.gbdt import engine, hist, prng, route
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import LAD_Q, GBDTTrainer, _lad_refine
from ytklearn_tpu_torch.serve import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(7)


def _inputs(gen, F, n, B, N, dtype, M):
    bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    bins = bins.to(torch.uint8) if dtype == "u8" else bins
    pos = torch.randint(-1, M, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    gq = torch.randint(-127, 128, (n,), generator=gen, device="cuda").float()
    hq = torch.randint(0, 128, (n,), generator=gen, device="cuda").float()
    ids = torch.randperm(M, generator=gen, device="cuda")[:N].to(torch.int32)
    if N > 2:
        ids[:: 4] = -2
    return bins, pos, gq, hq, ids


@pytest.mark.parametrize("F,n,B,N,dtype,M", [
    (28, 70000, 256, 1, "u8", 509), (28, 70000, 256, 64, "u8", 509),
    (5, 49152, 16, 7, "i32", 31), (3, 5000, 1024, 100, "i32", 4096),
    (6, 777, 64, 33, "u8", 100),
    # wide: bins past one tile, each tile one of 2 (4) bin ranges
    (4, 70004, 1 << 15, 3, "i32", 15), (2, 30000, 1 << 16, 16, "i32", 61),
])
def test_hist_kernels_match_plain(gen, F, n, B, N, dtype, M):
    bins, pos, gq, hq, ids = _inputs(gen, F, n, B, N, dtype, M)
    before = hist.hist_wave_q.launches
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    assert hist.hist_wave_q.launches == before + 1
    assert torch.equal(got, hist.hist_wave_q_plain(bins, pos, gq, hq, ids,
                                                   B, M))
    rows = bins.t().contiguous()
    R = 4096
    idx = torch.randint(0, n, (R,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pg = pos[idx.long()].clone()
    pg[R // 2:] = -1
    gg, hg = gq[idx.long()].contiguous(), hq[idx.long()].contiguous()
    before = hist.hist_wave_gather.launches
    got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B, max_nodes=M)
    assert hist.hist_wave_gather.launches == before + 1
    assert torch.equal(got, hist.hist_gather_q_plain(rows, idx, pg, gg, hg,
                                                     ids, B, M))


def test_hist_wrapper_refuses_bad_inputs(gen):
    bins, pos, gq, hq, ids = _inputs(gen, 4, 1000, 16, 3, "u8", 9)
    with pytest.raises(ValueError, match="gq"):
        hist.hist_wave_q(bins, pos, gq.double(), hq, ids, 16, max_nodes=9)
    with pytest.raises(ValueError, match="pos"):
        hist.hist_wave_q(bins, pos.long(), gq, hq, ids, 16, max_nodes=9)
    with pytest.raises(ValueError, match="pos must have shape"):
        hist.hist_wave_q(bins, pos[:500].contiguous(), gq[:500].contiguous(),
                         hq[:500].contiguous(), ids, 16, max_nodes=9)
    # bins past one tile run (tiles of bin ranges): the same sums
    wide = hist.hist_wave_q(bins, pos, gq, hq, ids, 1 << 15, max_nodes=9)
    assert torch.equal(wide, hist.hist_wave_q_plain(bins, pos, gq, hq, ids,
                                                    1 << 15, 9))
    # a tree past the shared lookup's cap runs (the global lookup kind)
    got = hist.hist_wave_q(bins, pos, gq, hq, ids, 16, max_nodes=60000)
    assert torch.equal(got, hist.hist_wave_q_plain(bins, pos, gq, hq, ids,
                                                   16, 60000))


def test_route_wrapper_refuses_a_bad_out(gen):
    bins, pos, *_ = _inputs(gen, 3, 1000, 16, 1, "u8", 9)
    one = torch.ones(1, dtype=torch.int32, device="cuda")
    args = (bins, pos, one.bool(), one, one, one, one + 2, one + 3)
    before = route.route_wave.launches
    for bad in (pos.long(), pos[:999], pos.cpu()):
        with pytest.raises(ValueError, match="out must be"):
            route.route_wave(*args, out=bad)
    assert route.route_wave.launches == before


@pytest.mark.parametrize("NW,dtype", [(1, "u8"), (64, "u8"), (17, "i32")])
def test_route_kernel_matches_plain_in_place(gen, NW, dtype):
    F, n, B, M = 6, 100003, 256, 2 * NW + 5
    bins, pos, *_ = _inputs(gen, F, n, B, 1, dtype, M)
    nid = torch.randperm(M, generator=gen, device="cuda")[:NW].to(
        torch.int32)
    valid = torch.rand((NW,), generator=gen, device="cuda") < 0.7
    feat = torch.randint(-1, F, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slot = torch.randint(0, B, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (M + 2 * torch.arange(NW, device="cuda")).to(torch.int32)
    lo = torch.randint(0, 64, (NW,), generator=gen, device="cuda",
                       dtype=torch.int32)
    hi = lo + 150
    want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                  lch + 1, lo, hi)
    before = route.route_wave.launches
    got = route.route_wave(bins, pos, valid, nid, feat, slot, lch, lch + 1,
                           lo=lo, hi=hi, out=pos)
    assert route.route_wave.launches == before + 1
    assert got.data_ptr() == pos.data_ptr() and torch.equal(got, want)


K5_CASES = {
    # name: (F, n, B, NW, id base, id spread, dup, view, alias, i32, i64)
    "dup_valid": (28, 100003, 256, 64, 0, 129, "valid", False, False,
                  False, False),
    "dup_later_invalid": (28, 100003, 256, 64, 0, 129, "invalid", False,
                          True, False, False),
    "ids_past_57344": (28, 100003, 256, 64, 60000, 129, None, False, False,
                       False, False),
    "sorted_lookup": (8, 100003, 256, 64, 60000, 10 ** 6, None, False, True,
                      False, True),
    "misaligned_out_separate": (8, 100003, 256, 64, 0, 129, None, True,
                                False, False, False),
    "misaligned_out_aliased": (8, 100003, 256, 64, 0, 129, None, True, True,
                               False, False),
    "i32_bins_aliased": (6, 100003, 1024, 17, 0, 39, None, False, True, True,
                         False),
    "empty_wave": (3, 1001, 16, 0, 0, 9, None, False, True, False, False),
    "wide_wave": (4, 20003, 256, 3000, 0, 300000, "valid", False, False,
                  False, True),
}


@pytest.mark.parametrize("case", sorted(K5_CASES))
def test_route_kernel_edge_cases(gen, case):
    """K5's lookup (direct map, sorted ids), row (quads, the scalar path)
    and store paths against its plain version, exact, one launch each."""
    F, n, B, NW, base, spread, dup, view, alias, i32, i64 = K5_CASES[case]
    bins = torch.randint(0, B, (F, n), generator=gen, device="cuda",
                         dtype=torch.int32)
    bins = bins if i32 else bins.to(torch.uint8)
    nid = (torch.randperm(spread, generator=gen, device="cuda")[:NW]
           + base).to(torch.int32)
    full = nid[torch.randint(0, max(NW, 1), (n + 1,), generator=gen,
                             device="cuda")] if NW else \
        torch.zeros(n + 1, dtype=torch.int32, device="cuda")
    full[torch.rand((n + 1,), generator=gen, device="cuda") < 0.2] = -1
    pos = full[1:] if view else full[:n].clone()
    valid = torch.rand((NW,), generator=gen, device="cuda") < 0.8
    if dup:
        nid[NW - 1] = nid[1]
        valid[1] = True
        valid[NW - 1] = dup == "valid"
    feat = torch.randint(-1, F + 1, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    slot = torch.randint(0, B, (NW,), generator=gen, device="cuda",
                         dtype=torch.int32)
    lch = (base + 2 * spread + 2 * torch.arange(NW, device="cuda")).to(
        torch.int32)
    lo = torch.randint(0, B // 4, (NW,), generator=gen, device="cuda",
                       dtype=torch.int32)
    hi = lo + B // 2
    if i64:
        nid, feat, slot, lo, hi = (x.long() for x in (nid, feat, slot, lo,
                                                       hi))
    want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                  lch + 1, lo, hi)
    before = route.route_wave.launches
    got = route.route_wave(bins, pos, valid, nid, feat, slot, lch, lch + 1,
                           lo=lo, hi=hi, out=pos if alias else None)
    assert route.route_wave.launches == before + 1
    assert (got.data_ptr() == pos.data_ptr()) == alias
    assert torch.equal(got, want)


def test_grow_on_the_card_equals_the_cpu(gen):
    rng = np.random.RandomState(3)
    n, F, B = 50000, 6, 64
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    h = (rng.rand(n) + 0.5).astype(np.float32)
    spec = engine.GrowSpec(
        F=F, B=B, max_nodes=127, wave=16, policy="loss", max_depth=10,
        max_leaves=64, lr=0.1, l1=0.0, l2=1.0, min_h=1.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, ladder=(4, 16))
    out = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out[dev] = engine.grow(
            spec, t(bins), torch.ones(n, dtype=torch.bool, device=dev),
            t(g), t(h), torch.ones(F, dtype=torch.bool, device=dev))
    (tc, pc, _, wc), (tg, pg, _, wg) = out["cpu"], out["cuda"]
    for a, b in zip(tc, tg):
        assert torch.equal(a, b.cpu())
    assert torch.equal(pc, pg.cpu()) and torch.equal(wc, wg.cpu())
    assert int(tg.n_nodes) == 127
    spec = dataclasses.replace(spec, fused=False)  # the gather rungs (K2)
    tg2, *_ = engine.grow(spec, torch.from_numpy(bins).cuda(),
                          torch.ones(n, dtype=torch.bool, device="cuda"),
                          torch.from_numpy(g).cuda(),
                          torch.from_numpy(h).cuda(),
                          torch.ones(F, dtype=torch.bool, device="cuda"))
    for a, b in zip(tg, tg2):
        assert torch.equal(a, b)


def test_trainer_dump_on_the_card_equals_the_cpu(gen, tmp_path):
    rng = np.random.RandomState(5)
    n, F = 40000, 5
    X = rng.randn(n, F).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + rng.randn(n) * 0.5) > 0).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    text = {}
    for dev in ("cpu", "cuda"):
        path = str(tmp_path / f"{dev}.model")
        p = GBDTParams(round_num=3, max_depth=6, max_leaf_cnt=31,
                       tree_grow_policy="loss", learning_rate=0.2,
                       loss_function="l2", eval_metric=["rmse"],
                       approximate=[ApproximateSpec(max_cnt=127)],
                       model=ModelParams(data_path=path, dump_freq=0))
        GBDTTrainer(p, hist_precision="int8", device=dev, wave=8).train(
            GBDTData(X, y, np.ones(n, np.float32), n, names))
        with open(path) as f:
            text[dev] = f.read()
    assert text["cpu"] == text["cuda"]


def test_trainer_dump_at_wide_bins_on_the_card_equals_the_cpu(gen, tmp_path):
    """int8 trees over features of 2^15 bins (max_cnt 30,000: tiles of
    two bin ranges on the card): the card's dump is the CPU's byte for
    byte."""
    rng = np.random.RandomState(6)
    n, F = 40000, 3
    X = rng.randn(n, F).astype(np.float32)
    y = ((X[:, 0] * X[:, 1] + rng.randn(n) * 0.5) > 0).astype(np.float32)
    names = [f"f{i}" for i in range(F)]
    text, before = {}, hist.hist_wave_q.launches
    for dev in ("cpu", "cuda"):
        path = str(tmp_path / f"{dev}.model")
        p = GBDTParams(round_num=3, max_depth=6, max_leaf_cnt=15,
                       tree_grow_policy="loss", learning_rate=0.2,
                       loss_function="l2", eval_metric=["rmse"],
                       approximate=[ApproximateSpec(max_cnt=30000)],
                       model=ModelParams(data_path=path, dump_freq=0))
        tr = GBDTTrainer(p, hist_precision="int8", device=dev, wave=8)
        assert tr._grow_spec(F, 1 << 15).B == 1 << 15
        tr.train(GBDTData(X, y, np.ones(n, np.float32), n, names))
        with open(path) as f:
            text[dev] = f.read()
    assert hist.hist_wave_q.launches > before
    assert text["cpu"] == text["cuda"]


@pytest.mark.parametrize("goss", [(0.2, 0.125), (0.3, 0.0)])
def test_grow_with_goss_on_the_card_equals_the_cpu(gen, goss):
    """GOSS's stable sorts, threefry draw and compaction on the card: the
    same fit rows, tree, positions and wave log as on the CPU."""
    rng = np.random.RandomState(8)
    n, F, B = 60000, 6, 64
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    test = rng.randint(0, B, size=(F, 7000)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    g[rng.rand(n) < 0.1] = 2.5  # ties in |g|
    h = np.ones(n, np.float32)
    include = rng.rand(n) < 0.9
    spec = engine.GrowSpec(
        F=F, B=B, max_nodes=127, wave=16, policy="loss", max_depth=10,
        max_leaves=64, lr=0.1, l1=0.0, l2=1.0, min_h=1.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, ladder=(4, 16), bm=128,
        hist_mode="int8", goss_a=goss[0], goss_b=goss[1], goss_scale=0.95)
    out = {}
    for dev in ("cpu", "cuda"):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        out[dev] = engine.grow(spec, t(bins), t(include), t(g), t(h),
                               torch.ones(F, dtype=torch.bool, device=dev),
                               aux=(t(test),), key=prng.PRNGKey(77))
    (tc, pc, ac, wc), (tg, pg, ag, wg) = out["cpu"], out["cuda"]
    for a, b in zip(tc, tg):
        assert torch.equal(a, b.cpu())
    assert torch.equal(pc, pg.cpu()) and torch.equal(wc, wg.cpu())
    assert len(ac) == len(ag) == 2
    for a, b in zip(ac, ag):
        assert torch.equal(a, b.cpu())
    assert float(wg[0, 4]) < 0.5 * n


def test_prng_uniform_on_the_card_equals_the_cpu(gen):
    """The threefry twin's int32 ops give the same bits on both devices,
    over more than 2^24 draws."""
    key = prng.fold_in(prng.PRNGKey(20170425), 39)
    for n in (1, 1000, (1 << 24) + 5):
        a = prng.uniform(key, n, device="cuda").cpu()
        assert torch.equal(a.view(torch.int32),
                           prng.uniform(key, n).view(torch.int32))
    assert torch.equal(prng.split(key.cuda(), 3).cpu(), prng.split(key, 3))


@pytest.mark.parametrize("case", ["goss+rates", "efb", "goss+efb"])
def test_trainer_sampling_and_efb_on_the_card_equal_the_cpu(gen, tmp_path,
                                                           case):
    """GOSS with the sample rates, EFB on a one-hot block, and both: the
    dumped model on the card is the CPU's byte for byte (int8, l2)."""
    rng = np.random.RandomState(6)
    n, F_d, F_s = 40000, 5, 40
    X = np.zeros((n, F_d + F_s), np.float32)
    X[:, :F_d] = rng.randn(n, F_d)
    X[np.arange(n), F_d + rng.randint(0, F_s, n)] = rng.rand(n) + 0.5
    y = (X[:, 0] * X[:, 1] + X[:, F_d:F_d + 10].sum(1)
         + rng.randn(n) * 0.5).astype(np.float32)
    names = [f"f{i}" for i in range(F_d + F_s)]
    over = {"instance_sample_rate": 0.8, "feature_sample_rate": 0.7} \
        if case == "goss+rates" else {}
    ctor = {"efb": "efb" in case}
    if "goss" in case:
        ctor["goss"] = (0.2, 0.125)
    text = {}
    for dev in ("cpu", "cuda"):
        path = str(tmp_path / f"{dev}.model")
        p = GBDTParams(round_num=4, max_depth=6, max_leaf_cnt=31,
                       tree_grow_policy="loss", learning_rate=0.2,
                       loss_function="l2", eval_metric=["rmse"],
                       approximate=[ApproximateSpec(max_cnt=63)],
                       model=ModelParams(data_path=path, dump_freq=0),
                       **over)
        tr = GBDTTrainer(p, hist_precision="int8", device=dev, wave=8,
                         **ctor)
        tr.train(GBDTData(X, y, np.ones(n, np.float32), n, names))
        assert (tr._efb_plan is not None) == ("efb" in case)
        with open(path) as f:
            text[dev] = f.read()
    assert text["cpu"] == text["cuda"]


@pytest.mark.parametrize("n", [1500, 200000])  # the grid holds every row; not
@pytest.mark.parametrize("weights", ["unit", "int", "frac"])
def test_lad_refine_on_the_card_equals_the_cpu(gen, n, weights):
    """l1's approximate LAD refine on cuda against the CPU, on one grown
    tree, its positions, the labels, scores and weights, padding rows
    included. Unit and integer weights sum exactly (below 2^24), so the
    leaves are the CPU's bit for bit. Fractional weights add in atomic
    order on the card: a leaf is the CPU's, or one cell of the rank grid
    away where its running weight lies within rounding of half its total
    (rare: at least nine leaves in ten equal)."""
    rng = np.random.RandomState(7)
    X = rng.randn(n, 5).astype(np.float32)
    y = (X[:, 0] * 1.5 + np.abs(X[:, 1]) + 0.1 * rng.randn(n)).astype(
        np.float32)
    w = {"unit": np.ones(n), "int": rng.randint(1, 4, n),
         "frac": 0.5 + rng.rand(n)}[weights].astype(np.float32)
    n_pad = -(-n // 16384) * 16384
    bins = rng.randint(0, 16, size=(5, n_pad)).astype(np.uint8)
    bins[0, :n] = np.clip((X[:, 0] * 3 + 8).astype(int), 0, 15)
    yp, wp = np.pad(y, (0, n_pad - n)), np.pad(w, (0, n_pad - n))
    real = np.arange(n_pad) < n
    scores = np.pad((0.3 * rng.randn(n)).astype(np.float32), (0, n_pad - n))
    g = (np.sign(scores - yp) * wp).astype(np.float32)
    spec = engine.GrowSpec(F=5, B=16, max_nodes=63, wave=8, policy="loss",
                           max_depth=6, max_leaves=32, lr=0.3, l1=0.0,
                           l2=1.0, min_h=1e-6, max_abs=0.0,
                           min_split_loss=0.0, min_split_samples=0.0,
                           hist_mode="int8", ladder=(8, 32))
    t = torch.from_numpy
    tr, pos, _, _ = engine.grow(spec, t(bins), t(real), t(g), t(wp.copy()),
                                torch.ones(5, dtype=torch.bool))
    args = (t(yp), t(scores), t(wp), t(real))
    want = _lad_refine(tr, pos, *args, 0.3)
    got = _lad_refine(type(tr)(*(a.cuda() for a in tr)), pos.cuda(),
                      *(a.cuda() for a in args), 0.3).cpu()
    is_leaf = (tr.feat == -1) & (torch.arange(63) < tr.n_nodes)
    assert int(is_leaf.sum()) >= 16
    assert not torch.equal(want[is_leaf], tr.leaf[is_leaf])
    if weights != "frac":
        assert torch.equal(got, want)
        return
    assert torch.equal(got[~is_leaf], want[~is_leaf])
    assert float((got[is_leaf] == want[is_leaf]).float().mean()) >= 0.9
    # the grid of LAD_Q residuals at evenly spaced ranks, times lr
    rs = torch.sort((args[0] - args[1])[args[3]]).values
    i = torch.arange(LAD_Q, dtype=torch.int64)
    grid = rs[i * (n - 1) // (LAD_Q - 1)] * 0.3
    for a, b in zip(got[is_leaf].tolist(), want[is_leaf].tolist()):
        ca = torch.nonzero(grid == a).flatten()
        cb = torch.nonzero(grid == b).flatten()
        assert len(ca) and len(cb)
        assert int((ca[:, None] - cb[None, :]).abs().min()) <= 1, (a, b)


def test_route_with_efb_ranges_of_every_dtype(gen):
    """K5 with real member lo/hi read from the range tables (int32), as
    int64 and int16 views too, against its plain version."""
    from ytklearn_tpu_torch.gbdt.binning import BundlePlan

    plan = BundlePlan(n_features=6, col_fid=np.arange(2, dtype=np.int32),
                      bundles=[[2, 3, 4, 5]], member_lo=[[1, 9, 10, 40]],
                      member_hi=[[8, 9, 39, 200]])
    rlo, rhi = (torch.from_numpy(r).cuda() for r in plan.range_tables(256))
    n, NW, M = (1 << 20) + 3, 48, 97
    bins = torch.randint(0, 256, (3, n), generator=gen, device="cuda",
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(-1, M, (n,), generator=gen, device="cuda",
                        dtype=torch.int32)
    feat = torch.full((NW,), 2, dtype=torch.int32, device="cuda")
    slot_r = torch.randint(1, 201, (NW,), generator=gen, device="cuda")
    lo, hi = rlo[feat.long(), slot_r], rhi[feat.long(), slot_r]
    slot = torch.maximum(lo - 1, slot_r.to(torch.int32) - 3)
    nid = torch.randperm(M, generator=gen, device="cuda")[:NW].to(
        torch.int32)
    valid = torch.ones(NW, dtype=torch.bool, device="cuda")
    lch = (M + 2 * torch.arange(NW, device="cuda")).to(torch.int32)
    want = route.route_wave_plain(bins, pos, valid, nid, feat, slot, lch,
                                  lch + 1, lo, hi)
    assert lo.dtype == torch.int32
    for dt in (torch.int32, torch.int64, torch.int16):
        got = route.route_wave(bins, pos, valid, nid, feat, slot, lch,
                               lch + 1, lo=lo.to(dt), hi=hi.to(dt))
        assert torch.equal(got, want), dt
    assert bool(((want != pos) & (want % 2 == 0)).any())


def _close(got, want):
    assert torch.equal(got[..., 2], want[..., 2])
    scale = float(want[..., :2].abs().max())
    torch.testing.assert_close(got[..., :2], want[..., :2], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("F,n,B,N,dtype,M", [
    (28, 70000, 256, 1, "u8", 509), (28, 70000, 256, 64, "u8", 509),
    (5, 49152, 16, 7, "i32", 31), (6, 777, 64, 33, "u8", 100),
    # wide: bins past one tile
    (4, 70004, 1 << 15, 3, "i32", 15), (2, 30000, 1 << 16, 16, "i32", 61),
])
def test_float_hist_kernels_match_plain(gen, use_bf16, F, n, B, N, dtype, M):
    bins, pos, _, _, ids = _inputs(gen, F, n, B, N, dtype, M)
    g = torch.randn((n,), generator=gen, device="cuda") * 3
    h = torch.rand((n,), generator=gen, device="cuda")
    before = hist.hist_wave.launches
    got = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                         use_bf16=use_bf16)
    assert hist.hist_wave.launches == before + 1
    _close(got, hist.hist_wave_plain(bins, pos, g, h, ids, B, M, use_bf16))
    rows = bins.t().contiguous()
    R = 4096
    idx = torch.randint(0, n, (R,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pg = pos[idx.long()].clone()
    pg[R // 2:] = -1
    gg, hg = g[idx.long()].contiguous(), h[idx.long()].contiguous()
    before = hist.hist_wave_gather_mxu.launches
    got = hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B, mode="mxu",
                                max_nodes=M, use_bf16=use_bf16)
    assert hist.hist_wave_gather_mxu.launches == before + 1
    _close(got, hist.hist_gather_plain(rows, idx, pg, gg, hg, ids, B, M,
                                       use_bf16))


# -- K6/K7 (serve/csrc/heap_walk.cu): every rung, depth 1-10, T past a chunk --

#: (B, depth, T): every ladder rung and B = 513 (a ragged row tile), depth
#: 1, 6 and 10, T from 8 to a few thousand trees, one past a chunk included
WALK_GRID = [(B, depth, T) for B in (1, 8, 64, 512, 513)
             for depth in (1, 6, 10)
             for T in (8, 504, kernels.WALK_CHUNK_CAP + 1, 2600)]
WALK_F = 28


@functools.lru_cache(maxsize=4)
def _walk_heap(T, depth):
    """Seeded perfect-heap arrays: a quarter of the slots always-left pads,
    the last quarter of the trees -0.0 pad trees, splits on a coarse grid
    so rows land on them."""
    rng = np.random.RandomState(T * 16 + depth)
    H, LL = (1 << (depth + 1)) - 1, 1 << depth
    feat = rng.randint(0, WALK_F, (T, H)).astype(np.int32)
    split = np.round(rng.randn(T, H), 1)
    dleft = rng.randint(0, 2, (T, H)).astype(np.int32)
    pad = rng.rand(T, H) < 0.25
    pad[T - T // 4:] = True
    feat[pad], split[pad], dleft[pad] = 0, np.inf, 1
    leaf = rng.randn(T, LL)
    leaf[T - T // 4:] = -0.0
    return feat, split, dleft, leaf


def _walk_rows(rng, B, split):
    """Rows with NaN, +-inf, -0.0 and values exactly at split thresholds."""
    X = np.round(rng.randn(B, WALK_F), 1)
    r = rng.rand(B, WALK_F)
    X[r < 0.15] = np.nan
    X[(r >= 0.15) & (r < 0.2)] = np.inf
    X[(r >= 0.2) & (r < 0.25)] = -np.inf
    at = (r >= 0.25) & (r < 0.45)
    X[at] = rng.choice(split[np.isfinite(split)], size=int(at.sum()))
    X[(r >= 0.45) & (r < 0.5)] = -0.0
    return X


def _same_bits(a, b):
    """Equal values with equal signs of zero (torch.equal takes -0.0 ==
    +0.0)."""
    return torch.equal(a, b) and torch.equal(a.view(torch.int64),
                                             b.view(torch.int64))


def _k6_inputs(B, depth, T):
    """K6's inputs on the card: rows, the heap's tensors (node records and
    leaves) and heap_walk_plain's arguments, the three arrays taken from
    the numpy heap itself."""
    feat, split, dleft, leaf = _walk_heap(T, depth)
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, depth, T, "cuda")
    X = torch.from_numpy(_walk_rows(np.random.RandomState(B), B,
                                    split)).cuda()
    plain = (X, *(torch.from_numpy(a).cuda() for a in (feat, split, dleft)),
             ht.leaf, depth)
    return X, ht, plain


@pytest.mark.parametrize("B,depth,T", WALK_GRID)
def test_heap_walk_matches_plain(gen, B, depth, T):
    """K6 at walk_plan's launch shape equals heap_walk_plain bit for bit."""
    X, ht, plain = _k6_inputs(B, depth, T)
    before = kernels.heap_walk.launches
    got = kernels.heap_walk(X, ht.nodes, ht.leaf, depth,
                            max_feat=ht.max_feat)
    assert kernels.heap_walk.launches == before + 1
    assert _same_bits(got, kernels.heap_walk_plain(*plain))


@pytest.mark.parametrize("case", ["negzero", "cancel"])
def test_heap_walk_signed_zero_sums(gen, case):
    """Sums that must come out +0.0: every leaf -0.0 (each add a no-op on
    the fold's +0.0 start), and trees in pairs whose leaves cancel (x then
    -x at every pair's end); over two chunks, at a ragged row tile."""
    B, depth, T = 513, 6, 2 * kernels.WALK_CHUNK_CAP + 2
    feat, split, dleft, leaf = _walk_heap(T, depth)
    if case == "negzero":
        leaf = np.full_like(leaf, -0.0)
    else:  # tree 2i+1 walks as tree 2i and adds its leaves negated
        feat, split, dleft = (np.repeat(a[::2], 2, axis=0)
                              for a in (feat, split, dleft))
        leaf = np.repeat(leaf[::2], 2, axis=0)
        leaf[1::2] *= -1.0
    ht = kernels.heap_from_numpy(feat, split, dleft, leaf, depth, T, "cuda")
    X = torch.from_numpy(_walk_rows(np.random.RandomState(3), B,
                                    split)).cuda()
    got = kernels.heap_walk(X, ht.nodes, ht.leaf, depth,
                            max_feat=ht.max_feat)
    want = kernels.heap_walk_plain(
        X, *(torch.from_numpy(a).cuda() for a in (feat, split, dleft)),
        ht.leaf, depth)
    assert _same_bits(want, torch.zeros_like(want))  # +0.0 everywhere
    assert _same_bits(got, want)


def _k7_inputs(B, depth, T, dtype, sentinel, seed=11):
    rng = np.random.RandomState(seed + B + depth + T)
    feat, split, dleft, leaf = _walk_heap(T, depth)
    hi = 300 if dtype == torch.uint16 else 250
    rank1 = rng.randint(0, hi + 1, size=feat.shape).astype(np.int64)
    rank1[~np.isfinite(split)] = 0xFFFF  # pads: non-missing rows go left
    packed = (feat.astype(np.int64) | (rank1 << 12)
              | (dleft.astype(np.int64) << 28)).astype(np.int32)
    b = rng.randint(0, hi, size=(B, WALK_F))
    b[rng.rand(B, WALK_F) < 0.1] = sentinel
    b[rng.rand(B, WALK_F) < 0.1] = 0
    bins = torch.from_numpy(b.astype(np.uint16 if dtype == torch.uint16
                                     else np.uint8)).cuda()
    return bins, torch.from_numpy(packed).cuda(), \
        torch.from_numpy(leaf).cuda()


#: the case this test held before the walk grid, with its own generator
K7_ORIGINAL = (700, 6, 64)


def _k7_original(dtype, sentinel):
    """K7_ORIGINAL's inputs as the test first drew them: 64 real trees,
    the last 9 slots of every tree pads, 10% missing bins."""
    rng = np.random.RandomState(11)
    B, depth, T = K7_ORIGINAL
    F = WALK_F
    H, LL = (1 << (depth + 1)) - 1, 1 << depth
    hi = 300 if dtype == torch.uint16 else 250
    rank1 = rng.randint(0, hi + 1, size=(T, H))
    rank1[:, -9:] = 0xFFFF  # pad slots: every non-missing row goes left
    packed = (rng.randint(0, F, size=(T, H)) | (rank1 << 12)
              | (rng.randint(0, 2, size=(T, H)) << 28)).astype(np.int32)
    b = rng.randint(0, hi, size=(B, F))
    b[rng.rand(B, F) < 0.1] = sentinel
    bins = torch.from_numpy(b.astype(np.uint16 if dtype == torch.uint16
                                     else np.uint8)).cuda()
    return bins, torch.from_numpy(packed).cuda(), \
        torch.from_numpy(rng.randn(T, LL)).cuda()


@pytest.mark.parametrize("B,depth,T", WALK_GRID + [K7_ORIGINAL])
@pytest.mark.parametrize("dtype,sentinel", [(torch.uint8, 255),
                                            (torch.uint16, 65535)])
def test_binned_walk_matches_plain(gen, dtype, sentinel, B, depth, T):
    """K7 at walk_plan's launch shape equals binned_walk_plain bit for bit,
    on uint8 and uint16 bins with the sentinel and bin 0."""
    if (B, depth, T) == K7_ORIGINAL:
        bins, packed, leaf = _k7_original(dtype, sentinel)
    else:
        bins, packed, leaf = _k7_inputs(B, depth, T, dtype, sentinel)
    before = kernels.binned_walk.launches
    got = kernels.binned_walk(bins, packed, leaf, depth, sentinel,
                              max_feat=WALK_F - 1)
    assert kernels.binned_walk.launches == before + 1
    assert _same_bits(got, kernels.binned_walk_plain(bins, packed, leaf,
                                                     depth, sentinel))


@pytest.mark.parametrize("plan", [
    {"rows": 1, "chunk": 1, "threads": 64},
    {"rows": 3, "chunk": 7, "threads": 64},
    {"rows": 4, "chunk": 64, "threads": 1024},
    {"rows": 33, "chunk": 100, "threads": 96},
    {"rows": 8, "chunk": 600, "threads": 160},
])
def test_walks_at_explicit_plans_match_plain(gen, plan):
    """Launch shapes other than walk_plan's (one tree a chunk, a ragged
    row tile, two fold warps, more walkers than pairs, a chunk past
    WALK_CHUNK_CAP) give the same bits."""
    B, depth, T = 70, 6, 600
    X, ht, plain = _k6_inputs(B, depth, T)
    got = kernels.heap_walk(X, ht.nodes, ht.leaf, depth,
                            max_feat=ht.max_feat, plan=plan)
    assert _same_bits(got, kernels.heap_walk_plain(*plain))
    bins, packed, leaf = _k7_inputs(B, depth, T, torch.uint8, 255)
    got = kernels.binned_walk(bins, packed, leaf, depth, 255,
                              max_feat=WALK_F - 1, plan=plan)
    assert _same_bits(got, kernels.binned_walk_plain(bins, packed, leaf,
                                                     depth, 255))


def test_heap_walk_needs_its_node_records(gen):
    """On the card the kernel reads node_records, built on the host from
    the three arrays and moved to the device once; a node table of another
    layout, or records off 16-byte alignment, is refused before any
    launch."""
    X, ht, plain = _k6_inputs(64, 6, 504)
    assert torch.equal(ht.nodes, kernels.node_records(*plain[1:4]))
    before = kernels.heap_walk.launches
    with pytest.raises(ValueError, match="nodes must be"):
        kernels.heap_walk(X, plain[1], ht.leaf, 6, max_feat=ht.max_feat)
    shifted = torch.empty(ht.nodes.numel() + 1, dtype=torch.int64,
                          device="cuda")[1:].view(ht.nodes.shape)
    shifted.copy_(ht.nodes)
    with pytest.raises(ValueError, match="aligned"):
        kernels.heap_walk(X, shifted, ht.leaf, 6, max_feat=ht.max_feat)
    assert kernels.heap_walk.launches == before


def test_walks_raise_on_a_bad_launch(gen, monkeypatch):
    """A plan past shared memory is refused before any launch; one that
    gets past the checker makes the launch fail on the card, and the
    wrapper raises: neither returns the plain version's sums."""
    B, depth, T = 512, 6, 4096
    X, ht, _ = _k6_inputs(B, depth, T)
    bins, packed, leaf = _k7_inputs(B, depth, T, torch.uint8, 255)
    big = {"rows": 32, "chunk": 1024, "threads": 1024}
    assert kernels.walk_smem(32, 1024, WALK_F, 8) > kernels.SMEM_MAX
    k6 = (X, ht.nodes, ht.leaf, depth)
    before = (kernels.heap_walk.launches, kernels.binned_walk.launches)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.heap_walk(*k6, max_feat=ht.max_feat, plan=big)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.binned_walk(bins, packed, leaf, depth, 255,
                            max_feat=WALK_F - 1, plan=big)
    monkeypatch.setattr(kernels, "check_walk_plan",
                        lambda plan, *a, **k: dict(plan))
    with pytest.raises(RuntimeError, match="heap_walk launch failed"):
        kernels.heap_walk(*k6, max_feat=ht.max_feat, plan=big)
    with pytest.raises(RuntimeError, match="binned_walk launch failed"):
        kernels.binned_walk(bins, packed, leaf, depth, 255,
                            max_feat=WALK_F - 1, plan=big)
    assert (kernels.heap_walk.launches,
            kernels.binned_walk.launches) == before


def test_cli_train_on_the_card(gen, tmp_path):
    """python -m ytklearn_tpu_torch.cli train gbdt <conf> on cuda, bf16."""
    rng = np.random.RandomState(2)
    for name, n in (("train", 20000), ("test", 4000)):
        X = rng.randn(n, 6)
        y = (X[:, 0] * X[:, 1] + rng.randn(n) * 0.5 > 0).astype(int)
        with open(tmp_path / f"{name}.txt", "w") as f:
            for i in range(n):
                feats = ",".join(f"f{j}:{X[i, j]:.6f}" for j in range(6))
                f.write(f"1###{y[i]}###{feats}\n")
    model = tmp_path / "gbdt.model"
    cmd = [sys.executable, "-m", "ytklearn_tpu_torch.cli", "train", "gbdt",
           "experiment/higgs/local_gbdt.conf",
           "--set", f"data.train.data_path={tmp_path / 'train.txt'}",
           "--set", f"data.test.data_path={tmp_path / 'test.txt'}",
           "--set", "data.max_feature_dim=6",
           "--set", f"model.data_path={model}",
           "--set", f"model.feature_importance_path={tmp_path / 'imp'}",
           "--set", "optimization.round_num=4",
           "--set", "optimization.max_depth=8"]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["trees"] == 4 and res["test_metrics"]["auc"] > 0.6
    assert model.exists() and (tmp_path / "gbdt.model.bins.json").exists()


def _dup_ids(gen, N, M):
    """N wave ids with a duplicated id (at slots 1 and N-1, or 0 and 1) and
    a -2 pad."""
    ids = torch.randperm(M, generator=gen, device="cuda")[:N].to(torch.int32)
    if N >= 3:
        ids[N - 1] = ids[1]
        ids[0] = -2
    elif N == 2:
        ids[1] = ids[0]
    return ids


@pytest.mark.parametrize("N,F,n,B,fg,rows", [
    (1, 28, 70001, 256, None, None), (7, 28, 70001, 256, 2, 4096),
    (32, 28, 200003, 256, None, None), (32, 5, 99999, 256, 7, 1000),
    (64, 28, 70001, 256, 4, None), (100, 6, 20000, 64, 1, 128),
    (5, 3, 777, 16, 16, 33),
    # slice 7's wgmma kernel: 3N past 256 (two n-tiles, two PV regions in
    # a round), an odd number of units a feature (rounds across features,
    # an idle consumer in the last), every wgmma width, 16-byte bins
    (100, 28, 70016, 256, None, None), (300, 3, 20000, 256, None, 4096),
    (50, 5, 30001, 160, None, None), (21, 7, 65536, 256, None, None),
    (42, 4, 65536, 256, 3, 8192), (85, 4, 65536, 1, None, None),
])
def test_hist_u8_matches_plain_and_k2(gen, N, F, n, B, fg, rows):
    """K8 against its plain version and against K2 permuted to its layout,
    exact, on a ragged n with a duplicated id and a pad."""
    bins, pos, gq, hq, _ = _inputs(gen, F, n, B, 1, "u8", 2 * N + 5)
    ids = _dup_ids(gen, N, 2 * N + 5)
    before = hist.hist_q_u8.launches
    got = hist.hist_q_u8(bins, pos, gq, hq, ids, B, fg=fg,
                         rows_per_block=rows)
    assert hist.hist_q_u8.launches == before + 1
    assert got.shape == (F, 3 * N, B) and got.dtype == torch.int32
    assert torch.equal(got, hist.hist_q_u8_plain(bins, pos, gq, hq, ids, B))
    k2 = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=2 * N + 5)
    assert torch.equal(got, k2.permute(1, 3, 0, 2).reshape(F, 3 * N, B))
    if N >= 3:
        assert torch.equal(k2[1], k2[N - 1]) and k2[1].any()


def test_hist_u8_refuses_bad_inputs(gen):
    bins, pos, gq, hq, ids = _inputs(gen, 4, 1000, 16, 3, "u8", 9)
    before = hist.hist_q_u8.launches
    with pytest.raises(ValueError, match="uint8"):
        hist.hist_q_u8(bins.int(), pos, gq, hq, ids, 16)
    with pytest.raises(ValueError, match="256"):
        hist.hist_q_u8(bins, pos, gq, hq, ids, 257)
    with pytest.raises(ValueError, match="gq"):
        hist.hist_q_u8(bins, pos, gq.double(), hq, ids, 16)
    with pytest.raises(ValueError, match="fg"):
        hist.hist_q_u8(bins, pos, gq, hq, ids, 16, fg=17)
    assert hist.hist_q_u8.launches == before


@pytest.mark.parametrize("use_bf16", [None, True, False])
def test_duplicate_ids_on_the_card(gen, use_bf16):
    """K1-K4 (use_bf16 None: the int8 K2/K4) with a duplicated id: each of
    its slots gets the sums, as in the plain versions."""
    F, n, B, M = 28, 70001, 256, 509
    bins, pos, gq, hq, _ = _inputs(gen, F, n, B, 1, "u8", M)
    ids = _dup_ids(gen, 64, M)
    rows = bins.t().contiguous()
    R = 4096
    idx = torch.randint(0, n, (R,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pg = pos[idx.long()].clone()
    pg[R // 2:] = -1
    if use_bf16 is None:
        g, h = gq, hq
        full = hist.hist_wave_q(bins, pos, g, h, ids, B, max_nodes=M)
        full_p = hist.hist_wave_q_plain(bins, pos, g, h, ids, B, M)
        gath = hist.hist_wave_gather(rows, idx, pg, g[idx.long()].contiguous(),
                                     h[idx.long()].contiguous(), ids, B,
                                     max_nodes=M)
        gath_p = hist.hist_gather_q_plain(rows, idx, pg, g[idx.long()],
                                          h[idx.long()], ids, B, M)
        assert torch.equal(full, full_p) and torch.equal(gath, gath_p)
        assert torch.equal(full[1], full[63]) and torch.equal(gath[1],
                                                              gath[63])
    else:
        g = torch.randn((n,), generator=gen, device="cuda") * 3
        h = torch.rand((n,), generator=gen, device="cuda")
        gg, hh = g[idx.long()].contiguous(), h[idx.long()].contiguous()
        full = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                              use_bf16=use_bf16)
        _close(full, hist.hist_wave_plain(bins, pos, g, h, ids, B, M,
                                          use_bf16))
        gath = hist.hist_wave_gather(rows, idx, pg, gg, hh, ids, B,
                                     mode="mxu", max_nodes=M,
                                     use_bf16=use_bf16)
        _close(gath, hist.hist_gather_plain(rows, idx, pg, gg, hh, ids, B, M,
                                            use_bf16))
        _close(full[63], full[1])
        _close(gath[63], gath[1])
    assert full[1].any() and not full[0].any()


def test_explicit_plans_on_the_card(gen):
    """K2 under launch shapes other than tile_plan's gives the same sums;
    a plan that does not fit raises before any launch."""
    F, n, B, N, M = 28, 70001, 256, 32, 65
    bins, pos, gq, hq, ids = _inputs(gen, F, n, B, N, "u8", M)
    want = hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M)
    for plan in ({"fg": 2, "ng": 32, "threads": 1024, "rows_per_chunk": 4096},
                 {"fg": 7, "ng": 8, "threads": 512, "n_chunks": 3},
                 {"fg": 28, "ng": 1, "threads": 256, "rows_per_chunk": n}):
        got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M,
                               plan=plan)
        assert torch.equal(got, want), plan
    before = hist.hist_wave_q.launches
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M,
                         plan={"fg": 28, "ng": 32, "rows_per_chunk": 4096})
    assert hist.hist_wave_q.launches == before


# -- K1/K3 (csrc/hist_float.cu): both kinds at the edges of their inputs ------

#: the largest tree whose node lookup fits beside a 1 x 1 tile at B = 256
CAP_256 = 57_344
#: a tree past it (K1-K4's global lookup kind)
PAST_CAP = 65_535


def _past_cap(gen, pos, ids, N, M):
    """A wave of a tree past the shared lookup's cap: ids near M, a
    duplicated id, a pad and an id past M; the rows' positions drawn from
    the ids, a tenth dead (-1) and some at or past M (no node)."""
    ids = (M - 1 - torch.randperm(4 * N, generator=gen, device="cuda")[:N]
           ).to(torch.int32)
    ids[N - 1] = ids[1]
    ids[0] = -2
    ids[2] = M + 9
    n = pos.shape[0]
    pick = torch.randint(0, N, (n,), generator=gen, device="cuda")
    pos = ids[pick].clone()
    r = torch.rand((n,), generator=gen, device="cuda")
    pos[r < 0.1] = -1
    pos[(r >= 0.1) & (r < 0.12)] = M
    return pos.contiguous(), ids


def _float_case(gen, F, n, B, N, M, dtype="u8", root=False, dup=False):
    bins, pos, _, _, ids = _inputs(gen, F, n, B, N, dtype, M)
    if root:  # the root wave: every live row in its one slot
        ids[0] = 3
        pos = torch.where(pos < 0, pos, 3).to(torch.int32)
    if dup:
        ids = _dup_ids(gen, N, M)
    g = torch.randn((n,), generator=gen, device="cuda") * 3
    h = torch.rand((n,), generator=gen, device="cuda")
    return bins, pos, g, h, ids


def _k1_plans(N, F, B, M):
    """float_plan's, then each kind explicitly; past one tile's bins also
    a tile of one more bin range than the planner's (a short last one)."""
    ng, fg = hist._float_tile(N, F, B, M)
    tile = {"ng": ng, "fg": fg, "rows_per_chunk": 8192, "threads": 1024}
    plans = [None, {"kind": "red", "n_chunks": 97, "threads": 256},
             dict(tile, kind="tile"), dict(tile, kind="auto")]
    if hist.bin_ranges(B) > 1:
        plans.append(dict(tile, kind="tile", nb=hist.bin_ranges(B) + 1))
    return plans


@pytest.mark.parametrize("case", [
    "root", "dense", "ragged_unaligned", "ragged_views", "int32_b1024",
    "dup_wave", "cap", "past_cap", "wide_15", "wide_16",
])
@pytest.mark.parametrize("use_bf16", [True, False])
def test_k1_kinds_match_plain(gen, case, use_bf16):
    """K1 at float_plan's plan and at each kind: counts exact, g/h at
    tolerance. Unaligned views and a ragged n take the one-row path; the
    auto kind picks the tile on the dense wave (about 3/4 of the rows in
    it) and red on the sparse ones (64 of 509 nodes). wide_15 / wide_16:
    B = 2^15 / 2^16, tiles of 2 / 4 bin ranges (and one more)."""
    F, n, B, N, M, dt = {
        "root": (28, 70004, 256, 1, 9, "u8"),
        "dense": (28, 70004, 256, 32, 33, "u8"),
        "ragged_unaligned": (28, 70001, 256, 64, 509, "u8"),
        "ragged_views": (6, 50003, 64, 7, 31, "u8"),
        "int32_b1024": (3, 20000, 1024, 100, 4096, "i32"),
        "dup_wave": (28, 70004, 256, 64, 509, "u8"),
        "cap": (28, 70004, 256, 64, CAP_256, "u8"),
        "past_cap": (28, 70004, 256, 64, PAST_CAP, "u8"),
        "wide_15": (4, 70004, 1 << 15, 3, 15, "i32"),
        "wide_16": (2, 70004, 1 << 16, 2, 9, "i32"),
    }[case]
    bins, pos, g, h, ids = _float_case(gen, F, n, B, N, M, dt,
                                       root=case == "root",
                                       dup=case == "dup_wave")
    if case == "past_cap":
        pos, ids = _past_cap(gen, pos, ids, N, M)
        assert hist.lookup_kind(B, M, N) == "global"
    if case == "ragged_unaligned":
        # a bins_t view whose rows start one byte past an aligned address
        big = torch.empty(F * n + 1, dtype=torch.uint8, device="cuda")
        big[1:] = bins.flatten()
        bins = big[1:].view(F, n)
        assert bins.data_ptr() % 16 and bins.is_contiguous()
    if case == "ragged_views":
        # pos/g/h views 4 bytes past a 16-byte boundary
        pos, g, h = (torch.cat([t[:1], t])[1:] for t in (pos, g, h))
        assert g.data_ptr() % 16
    want = hist.hist_wave_plain(bins, pos, g, h, ids, B, M, use_bf16)
    assert want[..., 2].sum() > 0
    for plan in _k1_plans(N, F, B, M):
        before = hist.hist_wave.launches
        got = hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                             use_bf16=use_bf16, plan=plan)
        assert hist.hist_wave.launches == before + 1
        _close(got, want)
        if case == "dup_wave":
            assert torch.equal(got[1], got[N - 1]) and got[1].any()
            assert not got[0].any()  # the pad


@pytest.mark.parametrize("case", ["f7_rows", "int32_b1024", "dup_wave",
                                  "cap", "dead_and_out_of_range", "empty",
                                  "past_cap"])
@pytest.mark.parametrize("use_bf16", [True, False])
def test_k3_matches_plain(gen, case, use_bf16):
    """K3 over gathered rows: F = 7 rows (a row is not whole 32-bit words),
    int32 bins, a duplicated id and pads, the lookup at its cap, dead slots
    (pos_g = -1) and row ids past the rows (they add nothing), R = 0."""
    F, n, B, N, M, dt, R = {
        "f7_rows": (7, 30001, 256, 5, 21, "u8", 4099),
        "int32_b1024": (3, 20000, 1024, 100, 4096, "i32", 5000),
        "dup_wave": (28, 70004, 256, 64, 509, "u8", 8192),
        "cap": (28, 70004, 256, 64, CAP_256, "u8", 8192),
        "dead_and_out_of_range": (28, 70004, 256, 64, 509, "u8", 4099),
        "empty": (28, 1000, 256, 64, 509, "u8", 0),
        "past_cap": (28, 70004, 256, 64, PAST_CAP, "u8", 8192),
    }[case]
    bins, pos, g, h, ids = _float_case(gen, F, n, B, N, M, dt,
                                       dup=case == "dup_wave")
    if case == "past_cap":
        pos, ids = _past_cap(gen, pos, ids, N, M)
    rows = bins.t().contiguous()
    idx = torch.randint(0, n, (R,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pg = pos[idx.long()].clone()
    pg[R // 2:] = -1
    gg, hg = g[idx.long()].contiguous(), h[idx.long()].contiguous()
    idx_k = idx.clone()
    if case == "dead_and_out_of_range":
        idx_k[:64:2] = n + 5  # past the rows: adds nothing
        idx_k[1:64:2] = -3
    live = (idx_k >= 0) & (idx_k < n)
    want = hist.hist_gather_plain(rows, idx, torch.where(live, pg, -1), gg,
                                  hg, ids, B, M, use_bf16)
    for plan in (None, {"kind": "red", "rows_per_chunk": 64,
                        "threads": 128}):
        before = hist.hist_wave_gather_mxu.launches
        got = hist.hist_wave_gather(rows, idx_k, pg, gg, hg, ids, B,
                                    mode="mxu", max_nodes=M,
                                    use_bf16=use_bf16, plan=plan)
        assert got.shape == (N, F, B, 3)
        assert hist.hist_wave_gather_mxu.launches == before + (R > 0)
        _close(got, want)
        if case == "dup_wave":
            assert torch.equal(got[1], got[N - 1]) and got[1].any()
    if R == 0:
        assert not got.any()
    else:
        assert want[..., 2].sum() > 0


def test_float_kernels_raise_on_a_bad_launch(gen, monkeypatch):
    """An oversized explicit plan is refused before any launch; one that
    gets past the checker makes the launch fail on the card, and the
    wrapper raises: neither returns the plain version's sums."""
    F, n, B, N, M = 28, 70004, 256, 32, 65
    bins, pos, g, h, ids = _float_case(gen, F, n, B, N, M)
    before = hist.hist_wave.launches
    big = {"kind": "tile", "fg": 28, "ng": 32, "rows_per_chunk": 4096,
           "threads": 1024}
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M, plan=big)
    # past the checker: the kernel asks for more shared memory than a block
    # may have, so its launch fails
    monkeypatch.setattr(hist, "check_float_plan",
                        lambda plan, *a, **k: dict(plan))
    plan = dict(big, n_ftiles=1, n_tiles=1, n_chunks=-(-n // 4096),
                smem=hist.tile_bytes(N, 32, 28, B, M))
    assert plan["smem"] > hist.SMEM_MAX
    with pytest.raises(RuntimeError, match="hist launch failed"):
        hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M, plan=plan)
    assert hist.hist_wave.launches == before


# -- K2/K4 (csrc/hist.cu): every kind at the edges of their inputs ------------


def _q_plans(N, F, B, M, n):
    """q_plan's, then each kind explicitly: a tile of the planner's shape
    with short chunks (the atomic flush) and with one or two (the store
    mode), auto, and red; past one tile's bins also a tile of one more bin
    range than the planner's (a short last one), in both flush modes."""
    ng, fg = hist._q_tile(N, F, B)
    tile = {"ng": ng, "fg": fg, "threads": 1024}
    few = max(4, hist._pad_to(-(-n // 2), 4))
    plans = [None, {"kind": "red", "n_chunks": 97, "threads": 256},
             dict(tile, kind="tile", rows_per_chunk=4096),
             dict(tile, kind="tile", rows_per_chunk=few),
             dict(tile, kind="auto", rows_per_chunk=few)]
    if hist.bin_ranges(B) > 1:
        more = dict(tile, kind="tile", nb=hist.bin_ranges(B) + 1)
        plans += [dict(more, rows_per_chunk=4096),
                  dict(more, rows_per_chunk=few)]
    return plans


def _q_case(gen, case):
    F, n, B, N, M, dt = {
        "root": (28, 70004, 256, 1, 9, "u8"),
        "n7": (28, 70004, 256, 7, 15, "u8"),
        "n64": (28, 70004, 256, 64, 129, "u8"),
        "sparse64": (28, 70004, 256, 64, 4096, "u8"),
        "ragged_unaligned": (28, 70001, 256, 64, 509, "u8"),
        "ragged_views": (6, 50003, 64, 7, 31, "u8"),
        "int32_b1024": (3, 20000, 1024, 100, 4096, "i32"),
        "dup_wave": (28, 70004, 256, 64, 509, "u8"),
        "cap": (28, 70004, 256, 64, CAP_256, "u8"),
        "past_cap": (28, 70004, 256, 64, PAST_CAP, "u8"),
        "wide_15": (4, 70004, 1 << 15, 3, 15, "i32"),
        "wide_16": (2, 70004, 1 << 16, 16, 61, "i32"),
    }[case]
    bins, pos, gq, hq, ids = _inputs(gen, F, n, B, N, dt, M)
    if case == "past_cap":
        pos, ids = _past_cap(gen, pos, ids, N, M)
        assert hist.lookup_kind(B, M, N) == "global"
    if case == "root":  # every live row in the one slot
        ids[0] = 3
        pos = torch.where(pos < 0, pos, 3).to(torch.int32)
    if case == "dup_wave":
        ids = _dup_ids(gen, N, M)
    if case == "ragged_unaligned":
        # a bins_t view whose rows start one byte past an aligned address
        big = torch.empty(F * n + 1, dtype=torch.uint8, device="cuda")
        big[1:] = bins.flatten()
        bins = big[1:].view(F, n)
        assert bins.data_ptr() % 16 and bins.is_contiguous()
    if case == "ragged_views":
        # pos/gq/hq views 4 bytes past a 16-byte boundary
        pos, gq, hq = (torch.cat([t[:1], t])[1:] for t in (pos, gq, hq))
        assert gq.data_ptr() % 16
    return bins, pos, gq, hq, ids, B, M


Q_CASES = ["root", "n7", "n64", "sparse64", "ragged_unaligned",
           "ragged_views", "int32_b1024", "dup_wave", "cap", "past_cap",
           "wide_15", "wide_16"]


@pytest.mark.parametrize("case", Q_CASES)
def test_k2_kinds_match_plain(gen, case):
    """K2 at q_plan's plan and at each kind, exact. Unaligned views and a
    ragged n take the one-row path; auto picks the tile on the dense waves
    and red on the sparse one (64 of 4096 nodes)."""
    bins, pos, gq, hq, ids, B, M = _q_case(gen, case)
    F, n, N = bins.shape[0], bins.shape[1], ids.shape[0]
    want = hist.hist_wave_q_plain(bins, pos, gq, hq, ids, B, M)
    assert want[..., 2].sum() > 0
    for plan in _q_plans(N, F, B, M, n):
        before = hist.hist_wave_q.launches
        got = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M,
                               plan=plan)
        assert hist.hist_wave_q.launches == before + 1
        assert torch.equal(got, want), plan
        if case == "dup_wave":
            assert torch.equal(got[1], got[N - 1]) and got[1].any()
            assert not got[0].any()  # the pad


@pytest.mark.parametrize("case", Q_CASES[:4] + ["int32_b1024", "dup_wave",
                                                "cap", "dead_and_out_of_range",
                                                "f7_rows", "empty",
                                                "past_cap", "wide_15",
                                                "wide_16"])
def test_k4_kinds_match_plain(gen, case):
    """K4 over gathered rows at q_plan's plan and at each kind, exact: the
    root wave, N = 7 and 64, a sparse wave, int32 bins, a duplicated id and
    pads, the lookup at its cap, dead slots (pos_g = -1) and row ids past
    the rows (they add nothing), F = 7 (a row is not whole 32-bit words),
    R = 0."""
    base = {"dead_and_out_of_range": "n64", "f7_rows": "n7",
            "empty": "n64"}.get(case, case)
    bins, pos, gq, hq, ids, B, M = _q_case(gen, base)
    if case == "f7_rows":
        bins = bins[:7].contiguous()
    rows = bins.t().contiguous()
    n, F, N = rows.shape[0], rows.shape[1], ids.shape[0]
    R = {"empty": 0, "f7_rows": 4099, "dead_and_out_of_range": 4099}.get(
        case, 8192)
    idx = torch.randint(0, n, (R,), generator=gen, device="cuda",
                        dtype=torch.int32)
    pg = pos[idx.long()].clone()
    pg[R // 2:] = -1
    gg, hg = gq[idx.long()].contiguous(), hq[idx.long()].contiguous()
    idx_k = idx.clone()
    if case == "dead_and_out_of_range":
        idx_k[:64:2] = n + 5  # past the rows: adds nothing
        idx_k[1:64:2] = -3
    live = (idx_k >= 0) & (idx_k < n)
    want = hist.hist_gather_q_plain(rows, idx, torch.where(live, pg, -1), gg,
                                    hg, ids, B, M)
    for plan in _q_plans(N, F, B, M, max(R, 1)):
        before = hist.hist_wave_gather.launches
        got = hist.hist_wave_gather(rows, idx_k, pg, gg, hg, ids, B,
                                    max_nodes=M, plan=plan)
        assert got.shape == (N, F, B, 3) and got.dtype == torch.int32
        assert hist.hist_wave_gather.launches == before + (R > 0)
        assert torch.equal(got, want), plan
        if case == "dup_wave":
            assert torch.equal(got[1], got[N - 1]) and got[1].any()
    if R == 0:
        assert not got.any()
    else:
        assert want[..., 2].sum() > 0


#: the bench cell's padded training rows (chip_smoke.py)
BENCH_ROWS = 10_502_144


@pytest.mark.parametrize("gv", [-127.0, 127.0])
def test_k2_k4_saturating_sums(gen, gv):
    """Every row in one node and one bin at |g| = |h| = 127: the largest
    sums a lane takes, over all 10.5M bench rows (1.33e9, within int32) in
    the root wave and in a 64-slot wave, with the planner's chunks, the
    longest chunk (one chunk: one block's tile takes every row), and red;
    K4 over every row gathered, and over the longest chunk."""
    n, F, B = BENCH_ROWS, 28, 256
    bins = torch.full((F, n), 17, dtype=torch.uint8, device="cuda")
    pos = torch.full((n,), 5, dtype=torch.int32, device="cuda")
    g = torch.full((n,), gv, device="cuda")
    h = torch.full((n,), 127.0, device="cuda")
    sums = torch.tensor([int(gv) * n, 127 * n, n], dtype=torch.int32,
                        device="cuda")
    assert abs(int(gv)) * n < 2 ** 31  # within int32: no lane wraps
    root = torch.tensor([5], dtype=torch.int32, device="cuda")
    for ids in (root, torch.arange(64, dtype=torch.int32, device="cuda")):
        N = ids.shape[0]
        ng, fg = hist._q_tile(N, F, B)
        tile = {"ng": ng, "fg": fg, "threads": 1024}
        want = torch.zeros((N, F, B, 3), dtype=torch.int32, device="cuda")
        want[0 if N == 1 else 5, :, 17] = sums
        for plan in (None, dict(tile, kind="tile", n_chunks=1),
                     dict(tile, kind="auto", rows_per_chunk=4096),
                     {"kind": "red", "n_chunks": 528}):
            got = hist.hist_wave_q(bins, pos, g, h, ids, B, max_nodes=64,
                                   plan=plan)
            assert torch.equal(got, want), (N, plan)
    rows = bins.t().contiguous()
    del bins
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    want = torch.zeros((1, F, B, 3), dtype=torch.int32, device="cuda")
    want[0, :, 17] = sums
    for plan in (None, {"kind": "tile", "ng": 1, "fg": 28, "n_chunks": 1}):
        got = hist.hist_wave_gather(rows, idx, pos, g, h, root, B,
                                    max_nodes=64, plan=plan)
        assert torch.equal(got, want), plan


def test_k2_k4_raise_on_a_bad_launch(gen, monkeypatch):
    """An oversized explicit plan is refused before any launch; one that
    gets past the checker makes the launch fail on the card, and the
    wrapper raises: neither returns the plain version's sums."""
    F, n, B, N, M = 28, 70004, 256, 32, 65
    bins, pos, gq, hq, ids = _inputs(gen, F, n, B, N, "u8", M)
    rows = bins.t().contiguous()
    idx = torch.arange(n, dtype=torch.int32, device="cuda")
    big = {"kind": "tile", "fg": 28, "ng": 32, "rows_per_chunk": 4096,
           "threads": 1024}
    before = (hist.hist_wave_q.launches, hist.hist_wave_gather.launches)
    with pytest.raises(ValueError, match="shared memory"):
        hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M, plan=big)
    # past the checker: the tile kernel asks for more shared memory than a
    # block may have, so its launch fails
    monkeypatch.setattr(hist, "check_q_plan",
                        lambda plan, *a, **k: dict(plan))
    plan = dict(big, n_ftiles=1, n_tiles=1, n_chunks=-(-n // 4096),
                smem=hist.q_tile_bytes(32, 28, B))
    assert plan["smem"] > hist.SMEM_MAX
    with pytest.raises(RuntimeError, match="hist_q launch failed"):
        hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M, plan=plan)
    with pytest.raises(RuntimeError, match="hist_gather_q launch failed"):
        hist.hist_wave_gather(rows, idx, pos, gq, hq, ids, B, max_nodes=M,
                              plan=plan)
    assert (hist.hist_wave_q.launches,
            hist.hist_wave_gather.launches) == before


# -- the convex stack on the card (no kernel of its own: plain torch) ------

def _convex_batch(family, n, dev, seed=3):
    """A seeded FM/FFM batch and weights: (model, w, batch) on `dev`."""
    from ytklearn_tpu_torch.config.params import CommonParams
    from ytklearn_tpu_torch.models import FFMModel, FMModel

    rng = np.random.RandomState(seed)
    nf, width, F = 5000, 24, 6
    idx = rng.randint(1, nf, (n, width)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.rand(n, width).astype(np.float32)
    y = rng.randint(0, 2, n).astype(np.float32)
    wt = (rng.rand(n) + 0.5).astype(np.float32)
    p = CommonParams(k=[1, 8])
    if family == "fm":
        model = FMModel(p, nf, device=dev)
        arrays = (idx, val, y, wt)
    else:
        model = FFMModel(p, nf, F, device=dev)
        arrays = (idx, val, rng.randint(0, F, (n, width)).astype(np.int32),
                  y, wt)
    w = (rng.randn(model.dim) * 0.1).astype(np.float32)
    return (model, torch.from_numpy(w).to(dev),
            tuple(torch.from_numpy(a).to(dev) for a in arrays))


def _close(got, want, rtol=1e-5):
    got = got.double().cpu().numpy()
    want = want.double().cpu().numpy()
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


@pytest.mark.parametrize("chunk", [None, 4096])
@pytest.mark.parametrize("family", ["fm", "ffm"])
def test_convex_loss_grad_card_matches_cpu(gen, family, chunk):
    """FM/FFM loss and gradient on the card against the CPU, unchunked and
    chunked: rtol 1e-5 (float32 sums in another order; the gather's
    backward accumulates)."""
    from ytklearn_tpu_torch.optimize.blocked import make_value_and_grad

    n = 20000
    out = {}
    for dev in ("cuda", "cpu"):
        model, w, batch = _convex_batch(family, n, dev)
        loss, grad = make_value_and_grad(model.pure_loss, chunk)(w, *batch)
        assert grad.device.type == dev
        out[dev] = (loss, grad)
    _close(out["cuda"][0], out["cpu"][0])
    _close(out["cuda"][1], out["cpu"][1])


@pytest.mark.parametrize("mode", ["wolfe", "strong_wolfe"])
def test_lbfgs_card_matches_cpu(gen, mode):
    """Five L-BFGS iterations of FM with L1 (OWL-QN) on the card and on
    the CPU: the same line-search statuses, losses at rtol 1e-4."""
    from ytklearn_tpu_torch.optimize import LBFGSConfig, minimize_lbfgs

    recs = {}
    for dev in ("cuda", "cpu"):
        model, w, batch = _convex_batch("fm", 8192, dev)
        l1, l2 = model.reg_vectors([1e-4, 1e-4], [1e-3, 1e-3])
        rec = []
        minimize_lbfgs(model.pure_loss, w, LBFGSConfig(max_iter=5,
                                                       mode=mode),
                       batch=batch, l1_vec=l1, l2_vec=l2, g_weight=8192.0,
                       callback=lambda it, st: rec.append(
                           (st.loss, st.ls_status, st.w.device.type))
                       and False)
        recs[dev] = rec
    assert [r[1] for r in recs["cuda"]] == [r[1] for r in recs["cpu"]]
    assert {r[2] for r in recs["cuda"]} == {"cuda"}
    np.testing.assert_allclose([r[0] for r in recs["cuda"]],
                               [r[0] for r in recs["cpu"]], rtol=1e-4)


@pytest.mark.parametrize("family", ["linear", "multiclass_linear", "fm",
                                    "ffm"])
def test_convex_entry_points_stay_on_the_card(gen, family, tmp_path,
                                              monkeypatch):
    """`cli train <family>` on cuda: every loss, gradient and prediction
    the run evaluates takes tensors on the card only."""
    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.models.base import ConvexModel
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

    seen = set()
    for name in ("pure_loss", "predicts"):
        real = getattr(ConvexModel, name)

        def wrapped(self, w, *batch, _real=real):
            seen.update(t.device.type for t in (w,) + batch)
            return _real(self, w, *batch)

        monkeypatch.setattr(ConvexModel, name, wrapped)
    cfg = write_convex_case(str(tmp_path), family, 3000, 500, 5,
                            vocab=6000 if family == "linear" else 200,
                            l2=0.01, max_iter=6)
    conf = tmp_path / "c.conf"
    conf.write_text(json.dumps(cfg))
    assert cli.main(["train", family, str(conf)]) == 0
    assert seen == {"cuda"}
    assert (tmp_path / "model" / "model-00000").exists()


# -- GBST and the serving lowerings on the card (plain torch) -----------------

@pytest.mark.parametrize("variant", ["gbmlr", "gbsdt", "gbhmlr", "gbhsdt"])
def test_gbst_fit_card_matches_cpu(gen, variant, tmp_path, monkeypatch):
    """GBSTTrainer on cuda against the CPU: 3 trees of 6 L-BFGS iterations
    (tests/test_torch_gbst.py's setting; past about 6 the fits are chaotic
    in f32 sum order), rates 0.8: the same statuses and iterations a tree,
    per-tree and final losses at rtol 1e-4, test AUC within 1e-4; every
    loss the card run evaluates takes tensors on the card."""
    from ytklearn_tpu_torch.boost import GBSTTrainer
    from ytklearn_tpu_torch.config.params import CommonParams
    from ytklearn_tpu_torch.models.gbst import GBSTModel
    from ytklearn_tpu_torch.scripts.convex_synth import write_gbst_case

    seen = set()
    real = GBSTModel.pure_loss

    def wrapped(self, w, *batch):
        seen.update(t.device.type for t in (w,) + batch)
        return real(self, w, *batch)

    monkeypatch.setattr(GBSTModel, "pure_loss", wrapped)
    cfg = write_gbst_case(str(tmp_path), 1 << 13, 1 << 10, 5, K=8,
                          tree_num=3, instance_sample_rate=0.8,
                          feature_sample_rate=0.8, vocab=2000, nnz=16,
                          l2=1e-3, max_iter=6)
    cfg["loss"]["evaluate_metric"] = ["auc"]
    out = {}
    for dev in ("cuda", "cpu"):
        cfg["model"]["data_path"] = str(tmp_path / dev / "model")
        seen.clear()
        out[dev] = GBSTTrainer(CommonParams.from_config(cfg), variant,
                               device=dev).train()
        assert seen == {dev}
    c, p = out["cuda"], out["cpu"]
    assert (c.per_tree_status, c.per_tree_iter) == \
        (p.per_tree_status, p.per_tree_iter)
    np.testing.assert_allclose(c.per_tree_loss + [c.train_loss, c.test_loss],
                               p.per_tree_loss + [p.train_loss, p.test_loss],
                               rtol=1e-4)
    assert abs(c.test_metrics["auc"] - p.test_metrics["auc"]) <= 1e-4


FAMILIES = ["linear", "multiclass_linear", "fm", "ffm", "gbmlr", "gbsdt",
            "gbhmlr", "gbhsdt"]


@functools.lru_cache(maxsize=None)
def _served_model(family, root):
    """A small model of `family` trained on the CPU by `cli train`, and its
    config and test rows."""
    from ytklearn_tpu_torch import cli
    from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case, \
        write_gbst_case

    d = os.path.join(root, family)
    if family.startswith("gb"):
        cfg = write_gbst_case(d, 2000, 200, 9, K=4, tree_num=2, vocab=300,
                              max_iter=5)
    else:
        kw = {"linear": dict(vocab=300), "fm": dict(vocab=300, k=4),
              "multiclass_linear": dict(vocab=100, K=4),
              "ffm": dict(vocab=200, n_fields=4, k=3)}[family]
        cfg = write_convex_case(d, family, 2000, 200, 9, max_iter=5, **kw)
    conf = os.path.join(d, "model.conf")
    with open(conf, "w") as f:
        json.dump(cfg, f)
    assert cli.main(["train", family, conf, "--device", "cpu"]) == 0
    rows = []
    with open(cfg["data"]["test"]["data_path"]) as f:
        for line in f:
            feats = line.rstrip("\n").split("###")[2]
            rows.append({k: float(v) for k, v in
                         (kv.split(":") for kv in feats.split(","))})
    return json.dumps(cfg), rows


@pytest.mark.parametrize("precision", ["f64", "bf16"])
@pytest.mark.parametrize("family", FAMILIES)
def test_lowering_rungs_card_match_cpu(gen, family, precision,
                                       tmp_path_factory):
    """Each family's lowering on the card against the CPU at both rungs:
    f64 scores at rtol 1e-10, atol 1e-12 (f64 sums in another order);
    bf16 (the einsum families) within torch_bf16_bound.py's stated bound
    of f32 sums in another order, an f32 result and not a bf16 one; GBST
    serves f64 at either."""
    from torch_bf16_bound import bf16_bound, bf16_round
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import CompiledScorer

    cfg, rows = _served_model(family, str(tmp_path_factory.getbasetemp()))
    pred = create_predictor(family, json.loads(cfg))
    out = {}
    for dev in ("cuda", "cpu"):
        sc = CompiledScorer(pred, ladder=(1, 8, 64), precision=precision,
                            device=dev)
        out[dev] = (sc, sc.score_batch(rows))
    sc, card = out["cuda"]
    cpu = out["cpu"][1]
    served = "bf16" if precision == "bf16" and not family.startswith("gb") \
        else "f64"
    assert sc.rung_info()["precision"] == served
    if served == "f64":
        np.testing.assert_allclose(card, cpu, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(card, pred.batch_scores(rows),
                                   rtol=1e-10, atol=1e-12)
        return
    bound = bf16_bound(family, pred, sc, sc.featurize(rows))
    if family == "multiclass_linear":
        card, cpu = card[:, :-1], cpu[:, :-1]
    assert np.all(np.abs(card - cpu) <= bound)
    assert np.any(card != bf16_round(card))


def test_bf16_rung_refuses_tf32(gen, monkeypatch, tmp_path_factory):
    """TF32 products would round the bf16 operands' products: the bf16
    rung refuses to lower while it is on."""
    from ytklearn_tpu_torch.predict import create_predictor
    from ytklearn_tpu_torch.serve import CompiledScorer

    cfg, _ = _served_model("fm", str(tmp_path_factory.getbasetemp()))
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="TF32"):
        CompiledScorer(create_predictor("fm", json.loads(cfg)),
                       precision="bf16", device="cuda")


# -- the host engine (plain torch, no kernel of its own) ----------------------


def test_host_histogram_card_equals_cpu(gen):
    """The host engine's float64-rounded-once histogram: the card's atomic
    float64 adds give the CPU's f32 sums exactly."""
    from ytklearn_tpu_torch.gbdt import host_engine

    rng = np.random.RandomState(5)
    n, F, B, nodes = 1 << 18, 28, 256, 8
    bins = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.int32))
    pos = torch.from_numpy(rng.randint(-1, nodes, n).astype(np.int32))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy(rng.rand(n).astype(np.float32))
    want = host_engine.hist_kernel(bins, pos, g, h, nodes, B)
    got = host_engine.hist_kernel(bins.cuda(), pos.cuda(), g.cuda(), h.cuda(),
                                  nodes, B)
    assert torch.equal(got.cpu(), want)
    mask = pos == 3
    assert torch.equal(host_engine.node_hist_kernel(
        bins.cuda(), mask.cuda(), g.cuda(), h.cuda(), B).cpu(),
        host_engine.node_hist_kernel(bins, mask, g, h, B))


@pytest.mark.parametrize("policy,loss", [("level", "sigmoid"),
                                         ("loss", "l1")])
def test_host_engine_tree_card_equals_cpu(gen, policy, loss, tmp_path):
    """A host-engine run on cuda dumps the CPU run's model text byte for
    byte (level-wise sigmoid through the feature maker, loss-wise l1 with
    the precise LAD refine)."""
    rng = np.random.RandomState(11)
    n, F = 20000, 8
    X = rng.randn(n, F).astype(np.float32)
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.3 * X[:, 3]
    y = ((rng.rand(n) < 1 / (1 + np.exp(-s))) if loss == "sigmoid"
         else s + 0.3 * rng.laplace(size=n)).astype(np.float32)
    texts = []
    for dev in ("cuda", "cpu"):
        p = GBDTParams(
            approximate=[ApproximateSpec(max_cnt=64)],
            model=ModelParams(data_path=str(tmp_path / dev), dump_freq=0),
            round_num=3, max_depth=-1, max_leaf_cnt=31, learning_rate=0.1,
            min_child_hessian_sum=1.0, tree_grow_policy=policy,
            loss_function=loss, lad_refine_appr=False, tree_maker="feature",
            eval_metric=[])
        tr = GBDTTrainer(p, device=dev)
        assert tr.engine == "host"
        tr.train(GBDTData(X, y, np.ones(n, np.float32), n,
                          [f"f{i}" for i in range(F)]))
        texts.append((tmp_path / dev).read_text())
    assert texts[0] == texts[1]
