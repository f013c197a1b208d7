"""The port's training kernels on the card, against their plain versions.

Marked `cuda`: each test skips without a CUDA device. This file imports
neither JAX nor the JAX package, so it runs on a machine with the card
and no JAX, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Kernel sums are int32 and the split scans run in a fixed order, so every
comparison is exact (torch.equal), trees included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ytklearn_tpu_torch.config.params import (
    ApproximateSpec,
    GBDTParams,
    ModelParams,
)
from ytklearn_tpu_torch.gbdt import engine, hist, route
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

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
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md 1\.8"):
        hist.hist_wave_q(bins, pos, gq, hq, ids, 256, max_nodes=60000)


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
