"""The port's wave routing (K5's plain version) against the JAX package.

The JAX side is `route_wave` as it runs off-TPU: `engine._route_wave`,
which updates pos slot by slot. K5 (and the Pallas kernel it replaces)
tests every slot against the row's position from before the wave. The
two agree because a wave's child ids are fresh; the last two tests pin
both the rule and the engine's side of that contract. Exact comparisons.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.gbdt import route as jroute
from ytklearn_tpu_torch.gbdt import engine, route


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _wave(rng, n, F, B, NW, n_nodes, bins_dtype, ranges):
    """A wave over distinct node ids with fresh children, invalid slots
    (some with feat -1), bins at slot boundaries, the last feature used,
    and optional EFB-style member ranges."""
    bins = rng.randint(0, B, size=(F, n)).astype(bins_dtype)
    pos = rng.randint(-1, n_nodes, size=n).astype(np.int32)
    nid = rng.choice(n_nodes, size=NW, replace=False).astype(np.int32)
    valid = rng.rand(NW) < 0.75
    feat = rng.randint(0, F, size=NW).astype(np.int32)
    feat[0] = F - 1
    feat[~valid & (rng.rand(NW) < 0.5)] = -1
    slot = rng.randint(0, B, size=NW).astype(np.int32)
    # put some rows exactly at a slot boundary of their node's split
    for i in range(NW):
        rows = np.nonzero(pos == nid[i])[0][:3]
        f = max(feat[i], 0)
        bins[f, rows[:2]] = slot[i]
        bins[f, rows[2:]] = min(slot[i] + 1, B - 1)
    prefix = np.cumsum(valid) - valid
    lch = (n_nodes + 2 * prefix).astype(np.int32)
    rch = lch + 1
    if ranges:
        lo = rng.randint(0, B // 2, size=NW).astype(np.int32)
        hi = (lo + rng.randint(1, B // 2, size=NW)).astype(np.int32)
    else:
        lo = hi = None
    return bins, pos, valid, nid, feat, slot, lch, rch, lo, hi


@pytest.mark.parametrize("bins_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("NW,ranges", [(1, False), (4, False), (64, False),
                                       (64, True)])
def test_route_wave_matches_jax_exact(bins_dtype, NW, ranges):
    rng = np.random.RandomState(NW * 7 + ranges)
    B = 256 if bins_dtype == np.uint8 else 1024
    bins, pos, valid, nid, feat, slot, lch, rch, lo, hi = _wave(
        rng, 5000, 6, B, NW, 2 * NW + 9, bins_dtype, ranges)
    jlo = None if lo is None else jnp.asarray(lo)
    jhi = None if hi is None else jnp.asarray(hi)
    want = np.asarray(jroute.route_wave(
        jnp.asarray(bins), jnp.asarray(pos), jnp.asarray(valid),
        jnp.asarray(nid), jnp.asarray(feat), jnp.asarray(slot),
        jnp.asarray(lch), jnp.asarray(rch), lo=jlo, hi=jhi))
    before = route.route_wave.launches
    got = route.route_wave(
        _t(bins), _t(pos), _t(valid), _t(nid), _t(feat), _t(slot), _t(lch),
        _t(rch), lo=None if lo is None else _t(lo),
        hi=None if hi is None else _t(hi))
    assert route.route_wave.launches == before  # CPU: the plain version
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    moved = want != pos
    assert moved.any() and np.isin(pos[moved], nid[valid]).all()


def test_route_matches_on_the_position_before_the_wave():
    """Slot 1 splits node 3, whose left child id (5) is slot 0's own node:
    K5 (and the Pallas kernel) route a row of node 5 by slot 0 only, where
    the slot-by-slot `_route_wave` would move the rows slot 1 just sent to
    5 a second time."""
    bins = np.asarray([[0, 9, 0, 9]], np.uint8)
    pos = np.asarray([5, 5, 3, 3], np.int32)
    valid = np.asarray([True, True])
    nid = np.asarray([5, 3], np.int32)
    feat = np.zeros(2, np.int32)
    slot = np.asarray([4, 4], np.int32)
    lch = np.asarray([7, 5], np.int32)
    rch = np.asarray([8, 6], np.int32)
    args = [_t(a) for a in (bins, pos, valid, nid, feat, slot, lch, rch)]
    got = route.route_wave(*args).numpy()
    np.testing.assert_array_equal(got, [7, 8, 5, 6])
    seq = np.asarray(jroute.route_wave(*[jnp.asarray(a) for a in (
        bins, pos, valid, nid, feat, slot, lch, rch)]))
    np.testing.assert_array_equal(seq, [7, 8, 5, 6][:2] + [5, 6])
    # the reference's sequential rule differs as soon as the order flips
    seq2 = np.asarray(jroute.route_wave(*[jnp.asarray(a) for a in (
        bins, pos, valid, nid[::-1].copy(), feat, slot[::-1].copy(),
        lch[::-1].copy(), rch[::-1].copy())]))
    got2 = route.route_wave(*[_t(a) for a in (
        bins, pos, valid, nid[::-1].copy(), feat, slot[::-1].copy(),
        lch[::-1].copy(), rch[::-1].copy())]).numpy()
    np.testing.assert_array_equal(got2, [7, 8, 5, 6])
    assert not np.array_equal(seq2, got2)


def test_engine_waves_only_ever_use_fresh_child_ids(monkeypatch):
    """K5's before-the-wave rule equals the reference's slot-by-slot rule
    only while no child id of a wave is a node id of the same wave: hold
    every route call of a grown tree to that."""
    calls = []
    real = engine.route_wave

    def checked(bins_t, pos, valid, nid, feat, slot, lch, rch, **kw):
        v = valid.numpy()
        kids = set(lch.numpy()[v]) | set(rch.numpy()[v])
        assert not kids & set(nid.numpy()[v].tolist())
        assert min(kids, default=10 ** 9) > int(nid.numpy()[v].max(
            initial=-1))
        calls.append(int(v.sum()))
        return real(bins_t, pos, valid, nid, feat, slot, lch, rch, **kw)

    monkeypatch.setattr(engine, "route_wave", checked)
    rng = np.random.RandomState(0)
    n, F, B = 4096, 5, 32
    bins = rng.randint(0, B, size=(F, n)).astype(np.uint8)
    g = rng.randn(n).astype(np.float32)
    h = np.ones(n, np.float32)
    spec = engine.GrowSpec(
        F=F, B=B, max_nodes=63, wave=8, policy="loss", max_depth=8,
        max_leaves=32, lr=0.1, l1=0.0, l2=1.0, min_h=1.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, ladder=(4,), bm=128,
        bm_g=256)
    tr, *_ = engine.grow(spec, _t(bins), torch.ones(n, dtype=torch.bool),
                         _t(g), _t(h), torch.ones(F, dtype=torch.bool))
    assert sum(calls) == (int(tr.n_nodes) - 1) // 2 > 8


def test_route_wave_writes_out_and_checks_it():
    """`out` receives the positions on every device (it may be pos itself);
    an `out` of the wrong dtype, length or layout, or a bin matrix of
    another row count than pos, raises before any kernel runs."""
    rng = np.random.RandomState(5)
    bins, pos, valid, nid, feat, slot, lch, rch, _, _ = _wave(
        rng, 600, 3, 16, 4, 17, np.uint8, False)
    args = [_t(a) for a in (bins, pos, valid, nid, feat, slot, lch, rch)]
    want = route.route_wave(*args)
    out = torch.full_like(args[1], -7)
    assert route.route_wave(*args, out=out) is out
    assert torch.equal(out, want)
    inplace = args[1].clone()
    route.route_wave(args[0], inplace, *args[2:], out=inplace)
    assert torch.equal(inplace, want)
    for bad in (torch.zeros(600, dtype=torch.int64),
                torch.zeros(599, dtype=torch.int32),
                torch.zeros(1200, dtype=torch.int32)[::2]):
        with pytest.raises(ValueError, match="out must be"):
            route.route_wave(*args, out=bad)
    with pytest.raises(ValueError, match="pos must be"):
        route.route_wave(args[0][:, :512].contiguous(), *args[1:])
