"""K1-K4's two kinds of node lookup (gbdt/hist.py: lookup_kind,
lookup_table, lookup_slots), on the CPU.

The global kind's plain version, the table its lookup kernel fills, equals
node_slots (the shared kind's) at a tree capacity past the shared cap
(M = 65,535), with duplicated, negative and out-of-range ids, dead rows,
and two waves in a row on one table. The planners keep the plan of every
capacity that fits shared memory exactly as it was before the global
kind existed (tests/torch_hist_shared_plans.json, recorded from the
planners then) and take the global kind past it, with the card's
arguments; the int8 planners refuse a wave of Q_MAX_SLOTS slots. Every
histogram's plain version at a capacity past the cap equals the one
through node_slots, and so does a tree grown there (int8 and f32), and
GBDTTrainer._grow_spec no longer refuses such a capacity on CUDA, nor
bins past one tile.
"""

import json
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.config.params import GBDTParams
from ytklearn_tpu_torch.gbdt import engine, hist, state
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

SM = 132
M_DEEP = 65_535
INT32_MAX = 2 ** 31 - 1
PLANS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                     "torch_hist_shared_plans.json")


def cap(B):
    """The largest max_nodes whose shared lookup fits beside a 1 x 1 tile."""
    return (hist.SMEM_MAX - 12 * B) // 16 * 4


def _wave(rng, N, M, n):
    """N slot ids (duplicates, pads -2, ids at and past M, a negative one)
    and n positions (dead rows -1, positions past M)."""
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    ids[1] = ids[N - 1]  # a duplicated id: its lowest slot wins
    ids[2] = -2
    ids[3] = M
    ids[4] = M + 77
    pos = rng.choice(np.concatenate([ids[ids >= 0], [-1, M, M + 5, 0]]),
                     size=n).astype(np.int32)
    return torch.from_numpy(ids), torch.from_numpy(pos)


def test_lookup_table_equals_node_slots_past_the_cap():
    """At M = 65,535 (global kind at every B): the table holds each id's
    lowest slot, and rows read through it equal node_slots; a second wave
    on the same table, with ids repeated and moved, leaves no entry of the
    first behind."""
    rng = np.random.RandomState(0)
    assert hist.lookup_kind(256, M_DEEP) == "global"
    table = None
    for N in (64, 40):  # two waves in a row on one table
        ids, pos = _wave(rng, N, M_DEEP, 5000)
        table = hist.lookup_table(ids, M_DEEP, table)
        assert table.shape == (hist._pad_to(M_DEEP, 4),)
        assert table.dtype == torch.int32
        want = np.full(M_DEEP, INT32_MAX, np.int64)
        for s, i in enumerate(ids.tolist()):
            if 0 <= i < M_DEEP:
                want[i] = min(want[i], s)
        assert np.array_equal(table[:M_DEEP].numpy(), want)
        got = hist.lookup_slots(table, pos, M_DEEP)
        ref = hist.node_slots(pos, ids, M_DEEP)
        assert torch.equal(got[1], ref[1])
        assert torch.equal(got[0][got[1]], ref[0][ref[1]])
        assert not got[1][pos < 0].any() and not got[1][pos >= M_DEEP].any()
    with pytest.raises(ValueError, match="lookup table"):
        hist.lookup_table(ids, M_DEEP, torch.zeros(8, dtype=torch.int32))


def _plan_args(row, gather_col=True):
    N, F, B, M, n = row[:5]
    return (N, F, B, M, n) + ((bool(row[5]),) if gather_col else ())


def test_plans_of_every_shared_capacity_are_unchanged():
    """float_plan, q_plan and tile_plan give, for each capacity that fits
    shared memory (up to the cap at B = 64, 256 and 1024), the plans the
    planners gave before the global kind existed."""
    rec = json.load(open(PLANS))
    keys = rec["keys"]
    assert rec["sm_count"] == SM
    for name, planner in (("float", hist.float_plan), ("q", hist.q_plan)):
        assert len(rec[name]) > 600
        for row in rec[name]:
            args = _plan_args(row)
            assert hist.lookup_kind(args[2], args[3], args[0]) == "shared"
            plan = planner(*args[:5], SM, args[5])
            assert [plan[k] for k in keys] == row[6:], (name, args)
    for row in rec["tile"]:
        plan = hist.tile_plan(*row[:5], SM)
        assert [plan[k] for k in keys[1:]] == row[5:], row[:5]


@pytest.mark.parametrize("B", [16, 64, 256, 1024])
def test_lookup_kind_switches_at_the_cap(B):
    """Shared up to the cap, global from one node past it; a global plan
    spends no shared memory on the lookup (tile plans: the tile only; red
    and pack shapes: none), at the card's 132 SMs."""
    c = cap(B)
    assert hist.lookup_kind(B, c) == "shared"
    assert hist.lookup_kind(B, c + 1) == "global"
    assert hist.lookup_kind(B, 8, N=c + 1) == "global"  # the wave's width
    for M in (c + 1, M_DEEP, 1 << 20):
        assert hist._lut_len(B, M, 64) == hist._pad_to(M, 4)
        assert hist._red_shape(64, B, M, 1 << 20, SM)[3] == 0
        for gather in (False, True):
            n = 10_502_144 if not gather else 65_536
            fp = hist.float_plan(64, 28, B, M, n, SM, gather)
            qp = hist.q_plan(64, 28, B, M, n, SM, gather)
            assert fp["smem"] == (0 if fp["kind"] == "red"
                                  else fp["ng"] * fp["fg"] * B * 12)
            assert qp["smem"] == (0 if qp["kind"] == "red"
                                  else qp["ng"] * qp["fg"] * B * 12)
            assert hist.check_float_plan(fp, 64, 28, B, M, n, gather) == fp
            assert hist.check_q_plan(qp, 64, 28, B, M, n) == qp
        tp = hist.tile_plan(64, 28, B, M, 1 << 20, SM)
        assert tp["smem"] == tp["ng"] * tp["fg"] * B * 12
    assert hist._lut_len(B, c, 64) == 0


def test_int8_planners_refuse_q_max_slots():
    for N in (hist.Q_MAX_SLOTS, hist.Q_MAX_SLOTS + 9):
        for call in (lambda: hist.q_plan(N, 28, 256, M_DEEP, 1000, SM),
                     lambda: hist.q_plan(N, 28, 256, M_DEEP, 1000, SM, True),
                     lambda: hist.check_q_plan({"kind": "red",
                                                "n_chunks": 1},
                                               N, 28, 256, M_DEEP, 1000)):
            with pytest.raises(ValueError, match="16-bit"):
                call()
    plan = hist.q_plan(hist.Q_MAX_SLOTS - 1, 28, 256, M_DEEP, 1000, SM)
    assert plan["kind"] == "red" and plan["smem"] == 0


def _shared(monkeypatch):
    """Every lookup through node_slots, whatever the capacity."""
    monkeypatch.setattr(hist, "lookup_kind", lambda *a, **k: "shared")


@pytest.mark.parametrize("which", ["k1", "k2", "k3", "k4"])
def test_histograms_past_the_cap_equal_node_slots(which, monkeypatch):
    """Each plain histogram at M = 65,535 through the global kind's
    lookup equals the same call through node_slots, exactly (the same
    rows in the same order)."""
    rng = np.random.RandomState(3)
    F, n, B, N = 5, 3000, 16, 64
    ids, pos = _wave(rng, N, M_DEEP, n)
    bins_t = torch.from_numpy(rng.randint(0, B, (F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy(rng.rand(n).astype(np.float32))
    gq, hq = g.mul(40).round(), h.mul(100).round()
    rows = bins_t.t().contiguous()
    idx = torch.from_numpy(rng.randint(0, n, 700).astype(np.int32))
    pg = pos[idx.long()].contiguous()

    def run():
        if which == "k1":
            return hist.hist_wave(bins_t, pos, g, h, ids, B,
                                  max_nodes=M_DEEP, use_bf16=True)
        if which == "k2":
            return hist.hist_wave_q(bins_t, pos, gq, hq, ids, B,
                                    max_nodes=M_DEEP)
        if which == "k3":
            return hist.hist_wave_gather(
                rows, idx, pg, g[idx.long()].contiguous(),
                h[idx.long()].contiguous(), ids, B, mode="mxu",
                max_nodes=M_DEEP, use_bf16=False)
        return hist.hist_wave_gather(rows, idx, pg, gq[idx.long()],
                                     hq[idx.long()], ids, B,
                                     max_nodes=M_DEEP)

    got = run()
    assert got[..., 2].sum() > 0
    assert torch.equal(got[1], got[N - 1])  # the duplicated id
    assert not got[2:5].any()  # a pad and ids at or past M
    _shared(monkeypatch)
    assert torch.equal(got, run())


def _grow(bins, g, h, hist_mode, M):
    n, F = bins.shape
    spec = engine.GrowSpec(
        F=F, B=32, max_nodes=M, wave=64, policy="loss", max_depth=0,
        max_leaves=120, lr=0.1, l1=0.0, l2=1.0, min_h=0.5, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, hist_mode=hist_mode,
        use_bf16=False, partition=True, ladder=(8, 32), fused=True,
        fused_max_rows=1 << 18, bm=128, bm_g=128)
    tr, pos, _, wlog = engine.grow(
        spec, torch.from_numpy(np.ascontiguousarray(bins.T)),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(g),
        torch.from_numpy(h), torch.ones(F, dtype=torch.bool))
    return state.tree_arrays_to_numpy(tr), pos.numpy(), wlog.numpy()


@pytest.mark.parametrize("hist_mode", ["int8", "mxu"])
def test_tree_past_the_cap_equals_node_slots_tree(hist_mode, monkeypatch):
    """A tree grown at a capacity past the cap (2 x 30,000 - 1 nodes, the
    global kind) equals the same tree through node_slots: every array,
    the rows' leaves and the wave log, exactly."""
    rng = np.random.RandomState(7)
    n, F = 2048, 6
    bins = rng.randint(0, 32, size=(n, F)).astype(np.uint8)
    logit = 0.2 * bins[:, 0] - 0.1 * bins[:, 1] + 0.5 * (bins[:, 2] > 16)
    y = (logit + rng.randn(n) > 2.0).astype(np.float32)
    p = np.full(n, y.mean(), np.float32)
    g, h = p - y, np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    M = 2 * 30_000 - 1
    assert hist.lookup_kind(32, M) == "global"
    got = _grow(bins, g, h, hist_mode, M)
    assert got[0]["n_nodes"] > 100
    _shared(monkeypatch)
    want = _grow(bins, g, h, hist_mode, M)
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k], want[0][k], err_msg=k)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("leaves,B,wide", [
    (30_000, 256, False), (28_672, 256, False), (255, 20_000, True)])
def test_grow_spec_on_cuda_plans_any_tree_and_bin_width(tmp_path, leaves, B,
                                                        wide):
    """_grow_spec with the card's device: a leaf cap past the shared
    lookup's (2 x 30,000 - 1 nodes) gives its spec and the planners plan it
    at the card's shapes; so do bins past one tile (B = 20,000: two ranges
    of 10,000 bins a tile), which no longer raise."""
    params = GBDTParams.from_config({
        "model": {"data_path": str(tmp_path / "gbdt.model")},
        "optimization": {"max_leaf_cnt": leaves, "max_depth": -1}})
    tr = GBDTTrainer(params, hist_precision="int8", device="cpu")
    tr.device = torch.device("cuda")  # the card's checks, no card needed
    spec = tr._grow_spec(28, B)
    M = spec.max_nodes
    assert M == 2 * leaves - 1
    assert hist.lookup_kind(B, M, spec.wave) == (
        "global" if wide or M > cap(B) else "shared")
    assert hist.bin_ranges(B) == (2 if wide else 1)
    for gather in (False, True):
        n = 10_502_144 if not gather else 65_536
        qp = hist.q_plan(spec.wave, 28, B, M, n, SM, gather)
        fp = hist.float_plan(spec.wave, 28, B, M, n, SM, gather)
        assert hist.check_q_plan(qp, spec.wave, 28, B, M, n) == qp
        assert hist.check_float_plan(fp, spec.wave, 28, B, M, n,
                                     gather) == fp
