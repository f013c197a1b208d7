"""The port's growth engine against the JAX package's `make_grow_tree`.

Both grow a tree from the same bins, gradients and spec (the JAX GrowSpec
carried over by `gbdt.state.grow_spec_from_fields`), in int8 and in f32 /
bf16 ("mxu") histogram mode with the partitioned budget ladder, as the JAX
package's own tests run it on the CPU: `force_dense=True`, and
`fused_interpret=True` where its fused kernel (K4, K3) itself should be the
reference (tests/test_hist_fused.py).

Tolerances. The tree structure (feat, slot, slot_r, left, right, depth,
n_nodes), the row counts (cnt), the final row positions and the wave log
are compared exactly. The f32 split statistics (leaf, gain, hess) agree to
about 1e-6 relative: the port scans bins in a fixed order (the one XLA's
CPU backend gives a lone jnp.cumsum / jnp.sum, bit-equal in
test_split_kernel_matches_jax_bitwise), while XLA reorders further inside
the fused whole-tree program. They are held at rtol 1e-5, with an
absolute floor of 1e-5 of the field's largest magnitude (gains near 0 are
differences of large sums). In "mxu" mode the histograms themselves are
f32 sums in another order, so the structure is exact only where no two
candidate splits lie within that noise: those tests assert first that
every chosen split beats its runner-up by a wide margin (split_margins).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ytklearn_tpu.gbdt import engine as jengine
from ytklearn_tpu_torch.gbdt import engine, state

INT_FIELDS = ("feat", "slot", "slot_r", "left", "right", "depth", "n_nodes",
              "cnt")
FLOAT_FIELDS = ("leaf", "gain", "hess")


def _case(n, F, B, seed):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.int32)
    logit = 0.1 * bins[:, 0] - 0.07 * bins[:, 1] + 0.4 * (bins[:, 2] > B // 2)
    y = (logit + rng.randn(n) > 0.5).astype(np.float32)
    p = (1.0 / (1.0 + np.exp(-(logit - 0.5)))).astype(np.float32)
    return bins, (p - y).astype(np.float32), \
        np.maximum(p * (1 - p), 1e-6).astype(np.float32)


def _jspec(F, B, **over):
    kw = dict(
        F=F, B=B, max_nodes=63, wave=4, policy="loss", max_depth=8,
        max_leaves=32, lr=0.1, l1=0.0, l2=1.0, min_h=1.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, hist_mode="int8",
        force_dense=True, partition=True, ladder=(4, 16), fused=True,
        fused_max_rows=1 << 18, bm_g=256,
    )
    kw.update(over)
    return jengine.GrowSpec(**kw)


def _grow_both(jspec, bins, g, h, include=None):
    n, F = bins.shape
    include = np.ones(n, bool) if include is None else include
    jtr, jpos, _, jwlog = jax.jit(jengine.make_grow_tree(jspec))(
        jnp.asarray(np.ascontiguousarray(bins.T)), jnp.asarray(include),
        jnp.asarray(g), jnp.asarray(h), jnp.ones((F,), bool))
    want = {k: np.asarray(v) for k, v in jtr._asdict().items()}
    spec = state.grow_spec_from_fields(dataclasses.asdict(jspec))
    bins_t = torch.from_numpy(np.ascontiguousarray(bins.T))
    if jspec.B <= 256:
        bins_t = bins_t.to(torch.uint8)
    tr, pos, _, wlog = engine.grow(
        spec, bins_t, torch.from_numpy(include), torch.from_numpy(g),
        torch.from_numpy(h), torch.ones(F, dtype=torch.bool))
    got = state.tree_arrays_to_numpy(tr)
    return want, np.asarray(jpos), np.asarray(jwlog), got, pos.numpy(), \
        wlog.numpy()


def _assert_same_tree(want, got):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k in FLOAT_FIELDS:
        scale = max(float(np.abs(want[k]).max()), 1e-30)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("policy,wave,interp", [
    ("loss", 1, False), ("loss", 4, False), ("level", 1, False),
    ("level", 4, False), ("loss", 4, True),
])
def test_grow_matches_make_grow_tree(policy, wave, interp):
    """Slow start, level/loss selection, the leaf-budget count-off, the
    pool subtraction, int8 quantization and the phase-separated ladder
    (gather rungs, or fused K4 rungs under the Pallas interpreter)."""
    bins, g, h = _case(4096, 6, 32, 11)
    jspec = _jspec(6, 32, policy=policy, wave=wave, fused_interpret=interp)
    want, jpos, jwlog, got, pos, wlog = _grow_both(jspec, bins, g, h)
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(wlog, jwlog)
    used = wlog[wlog[:, 3] > 0]
    assert used[:, 0].min() < 4096  # some wave ran on a partition budget
    assert int(got["n_nodes"]) == 63


def test_grow_excluded_rows_and_wide_bins():
    """Rows outside `include` count nowhere; B = 256 with u8 bins."""
    bins, g, h = _case(3000, 5, 256, 4)
    include = np.random.RandomState(1).rand(3000) < 0.8
    jspec = _jspec(5, 256, wave=8, max_nodes=31, max_leaves=16,
                   ladder=(2, 8))
    want, jpos, jwlog, got, pos, wlog = _grow_both(jspec, bins, g, h,
                                                   include)
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(wlog, jwlog)
    assert wlog[0, 1] == include.sum() == wlog[0, 4]


def split_margins(tr, bins, g, h, include, l2, min_h, use_bf16):
    """For every split node of a grown tree (TreeArrays fields as numpy):
    recompute, in f64 from the node's own rows, every candidate split's
    gain (l1 = 0, no leaf clamp), require the tree's (feature, slot) to be
    the best one, and return its relative margin over the runner-up. A
    margin far above the f32 summation noise (about 1e-6) means no order of
    the float sums can flip the choice. bins (n, F) int, g/h (n,) f32."""
    n, F = bins.shape
    B = int(bins.max()) + 1
    if use_bf16:
        g = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
        h = np.asarray(jnp.asarray(h, jnp.bfloat16).astype(jnp.float32))
    g, h = g.astype(np.float64), h.astype(np.float64)

    def gain(G, H):
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(H < min_h, 0.0, G * G / (H + l2))

    margins = []
    stack = [(0, np.nonzero(include)[0])]
    while stack:
        v, rows = stack.pop()
        f = int(tr["feat"][v])
        if f < 0:
            continue
        hg = np.zeros((F, B, 3))
        for j in range(F):
            for c, w in enumerate((g[rows], h[rows], np.ones(len(rows)))):
                hg[j, :, c] = np.bincount(bins[rows, j], weights=w,
                                          minlength=B)
        incl = np.cumsum(hg, axis=1)
        GL, HL, CL = (incl - hg).transpose(2, 0, 1)
        Gt, Ht = hg[0, :, 0].sum(), hg[0, :, 1].sum()
        ne = hg[..., 2] > 0
        valid = ne & (np.cumsum(ne, axis=1) - ne > 0) & (HL >= min_h) \
            & (Ht - HL >= min_h)
        chg = np.where(valid, gain(GL, HL) + gain(Gt - GL, Ht - HL)
                       - gain(Gt, Ht), -np.inf).ravel()
        best = int(np.argmax(chg))
        assert best == f * B + int(tr["slot_r"][v]), (v, best)
        second = np.max(np.delete(chg, best))
        margins.append((chg[best] - second) / abs(chg[best]))
        right = bins[rows, f] > int(tr["slot"][v])
        stack.append((int(tr["left"][v]), rows[~right]))
        stack.append((int(tr["right"][v]), rows[right]))
    return np.asarray(margins)


@pytest.mark.parametrize("hist_mode,policy,wave,interp", [
    ("f32", "loss", 1, False), ("bf16", "loss", 4, True),
    ("f32", "level", 4, True), ("bf16", "level", 1, False),
])
def test_grow_mxu_matches_make_grow_tree(hist_mode, policy, wave, interp):
    """The f32/bf16 histogram mode (K1 full scans, K3 fused rungs under the
    Pallas interpreter, or K1 over gathered rows) against the reference on
    data where every chosen split beats its runner-up by more than 1e-4
    relative, a hundred times the f32 summation noise. Integer fields,
    positions and the wave log are exact; leaf/gain/hess at rtol 1e-5."""
    bins, g, h = _case(4096, 6, 32, 11)
    jspec = _jspec(6, 32, policy=policy, wave=wave, fused_interpret=interp,
                   hist_mode="mxu", use_bf16=hist_mode == "bf16")
    want, jpos, jwlog, got, pos, wlog = _grow_both(jspec, bins, g, h)
    margins = split_margins(got, bins, g, h, np.ones(len(g), bool),
                            jspec.l2, jspec.min_h, jspec.use_bf16)
    assert len(margins) == 31 and margins.min() > 1e-4, margins.min()
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(wlog, jwlog)
    used = wlog[wlog[:, 3] > 0]
    assert used[:, 0].min() < 4096  # some wave ran on a partition budget


@pytest.mark.parametrize("N,F,B", [(1, 6, 32), (8, 6, 8), (4, 28, 256),
                                   (3, 3, 512)])
def test_split_kernel_matches_jax_bitwise(N, F, B):
    """On the same histograms the fixed-order scan equals the reference's
    split_kernel bit for bit, ties to the lowest (feature, slot)."""
    rng = np.random.RandomState(N * F)
    q = rng.randint(-300, 300, size=(N, F, B, 3)).astype(np.float32)
    q[..., 1:] = np.abs(q[..., 1:])
    q[..., 2][rng.rand(N, F, B) < 0.3] = 0.0  # empty bins
    hist = (q * np.asarray([0.0123, 0.00731, 1.0], np.float32)).astype(
        np.float32)
    hist[:, 1] = hist[:, 0]  # exact ties across features
    fmask = np.ones(F, bool)
    fmask[-1] = F == 1
    for cfg in ((0.0, 1.0, 1.0, 0.0), (0.5, 2.0, 3.0, 0.0),
                (0.2, 1.0, 1.0, 0.05)):
        want = jengine.split_kernel(jnp.asarray(hist), jnp.asarray(fmask),
                                    cfg)
        got = engine.split_kernel(torch.from_numpy(hist),
                                  torch.from_numpy(fmask), cfg)
        for i, (w, o) in enumerate(zip(want, got)):
            if i == 0 and cfg[3] > 0:
                # the leaf-clamped gain's multiply-adds: XLA contracts them
                # into FMAs, so the gain is held at rtol 1e-6 there
                np.testing.assert_allclose(o.numpy(), np.asarray(w),
                                           rtol=1e-6)
            else:
                np.testing.assert_array_equal(o.numpy(), np.asarray(w))


@pytest.mark.parametrize("L", [5, 16, 32, 100, 256, 3000, 4096])
def test_ordered_reductions_match_xla_cpu(L):
    x = (np.random.RandomState(L).randn(7, L) * 100).astype(np.float32)
    np.testing.assert_array_equal(
        engine.ordered_cumsum(torch.from_numpy(x), 1).numpy(),
        np.asarray(jnp.cumsum(jnp.asarray(x), axis=1)))
    if L <= 32 or L % 32 == 0:
        np.testing.assert_array_equal(
            engine.ordered_sum(torch.from_numpy(x), 1).numpy(),
            np.asarray(jnp.sum(jnp.asarray(x), axis=1)))


def test_float_order_key_is_the_total_order():
    vals = np.asarray([np.inf, 1.0, -0.0, 0.0, -np.inf, -1.5, 2.0, -0.0,
                       1e-38], np.float32)
    order = torch.sort(engine.float_order_key(torch.from_numpy(vals)),
                       stable=True).indices.numpy()
    _, want = jax.lax.sort((jnp.asarray(vals), jnp.arange(len(vals))),
                           num_keys=2)
    np.testing.assert_array_equal(order, np.asarray(want))


def test_state_carries_tree_arrays_both_ways():
    bins, g, h = _case(2048, 4, 16, 2)
    want, *_ = _grow_both(_jspec(4, 16, max_nodes=15, max_leaves=8,
                                 ladder=(4,)), bins, g, h)
    tr = state.tree_arrays_from_numpy(want)
    assert tr.feat.dtype == torch.int32 and tr.leaf.dtype == torch.float32
    back = state.tree_arrays_to_numpy(tr)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v)
    fb = state.feature_bins_from_numpy(np.zeros((2, 3)), [3, 1])
    assert fb.max_bins == 3 and fb.values.dtype == np.float32


def test_spec_conversion_maps_the_reference_paths():
    spec = state.grow_spec_from_fields(dataclasses.asdict(_jspec(4, 16)))
    assert spec.bm == 128 and not spec.fused  # XLA-gather rungs, 128 rows
    spec = state.grow_spec_from_fields(
        dataclasses.asdict(_jspec(4, 16, fused_interpret=True)))
    assert spec.fused and spec.bm_g == 256
    spec = state.grow_spec_from_fields(
        dataclasses.asdict(_jspec(4, 16, force_dense=False)))
    assert spec.fused and spec.bm == jengine.GrowSpec.bm


def test_gain_fns_match_jax():
    rng = np.random.RandomState(5)
    G = (rng.randn(1000) * 10).astype(np.float32)
    H = (rng.rand(1000) * 5).astype(np.float32)
    for cfg in ((0.0, 1.0, 1.0, 0.0), (0.5, 2.0, 0.5, 0.0),
                (0.3, 1.0, 0.1, 0.2)):
        jg, jv = jengine.make_gain_fns(*cfg)
        tg, tv = engine.make_gain_fns(*cfg)
        np.testing.assert_allclose(
            tg(torch.from_numpy(G), torch.from_numpy(H)).numpy(),
            np.asarray(jg(jnp.asarray(G), jnp.asarray(H))), rtol=1e-6)
        np.testing.assert_allclose(
            tv(torch.from_numpy(G), torch.from_numpy(H)).numpy(),
            np.asarray(jv(jnp.asarray(G), jnp.asarray(H))), rtol=1e-6)
