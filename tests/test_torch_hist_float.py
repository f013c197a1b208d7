"""The port's f32/bf16 histograms (K1/K3 plain versions) against the JAX
package.

The JAX side runs as its own tests run it on the CPU: `hist_wave` with
`force_dense=True` (the einsum `_hist_dense`), and the fused gather kernel
K3 itself under the Pallas interpreter (`_hist_gather_pallas` with
`interpret=True`, tests/test_hist_fused.py:50-68).

Tolerance. Counts are sums of ones and must be exact. The g/h channels are
f32 sums of the same (bf16-rounded) values in another order (XLA's dot
against the port's sequential index_add_), so they are held at rtol 1e-5
with an absolute floor of 1e-5 of the histogram's largest |sum|
(tests/test_hist_fused.py:68 holds the reference's own paths to the same).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ytklearn_tpu.gbdt import hist as jhist
from ytklearn_tpu_torch.gbdt import hist


def _case(n, F, B, N, seed, bins_dtype):
    """Bins, positions over 2N+3 tree nodes with dead rows (-1), f32 grads
    (some exactly halfway between two bf16 values) and N wave ids with -2
    pads."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(F, n)).astype(bins_dtype)
    M = 2 * N + 3
    pos = rng.randint(-1, M, size=n).astype(np.int32)
    g = (rng.randn(n) * 3).astype(np.float32)
    h = rng.rand(n).astype(np.float32) + 0.1
    ties = rng.rand(n) < 0.2  # bf16 ties: the low 16 bits are 0x8000
    bits = g.view(np.uint32)
    bits[ties] = (bits[ties] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    if N > 2:
        ids[rng.rand(N) < 0.25] = -2
    return bins, pos, g, h, ids, M


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def assert_hist_close(got, want):
    """Counts exact; g/h at rtol 1e-5, atol 1e-5 of the largest |sum|."""
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    scale = max(float(np.abs(want[..., :2]).max()), 1e-30)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=1e-5,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("bins_dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("N", [1, 7, 64])
@pytest.mark.parametrize("B", [16, 256])
def test_hist_wave_matches_dense(use_bf16, bins_dtype, N, B):
    bins, pos, g, h, ids, M = _case(3000, 5, B, N, N * 100 + B, bins_dtype)
    want = np.asarray(jhist.hist_wave(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos), jnp.asarray(g),
        jnp.asarray(h), jnp.asarray(ids), B, use_bf16=use_bf16,
        force_dense=True))
    before = hist.hist_wave.launches
    got = hist.hist_wave(_t(bins), _t(pos), _t(g), _t(h), _t(ids), B,
                         max_nodes=M, use_bf16=use_bf16)
    assert hist.hist_wave.launches == before  # CPU: the plain version
    assert got.dtype == torch.float32 and got.shape == (N, 5, B, 3)
    assert_hist_close(got.numpy(), want)
    assert want[..., 2].sum() > 0


def _compacted(bins, pos, g, h, ids, R):
    """The engine's compaction on the host: wave rows first, dead slots
    (pos -1, idx 0) after."""
    mask = np.isin(pos, ids[ids >= 0])
    sel = np.nonzero(mask)[0]
    assert len(sel) <= R
    idx = np.zeros(R, np.int32)
    idx[: len(sel)] = sel
    pg = np.full(R, -1, np.int32)
    pg[: len(sel)] = pos[sel]
    gg = np.zeros(R, np.float32)
    gg[: len(sel)] = g[sel]
    hg = np.zeros(R, np.float32)
    hg[: len(sel)] = h[sel]
    return np.ascontiguousarray(bins.T), idx, pg, gg, hg


@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("bins_dtype,B,N", [(np.uint8, 16, 7),
                                            (np.int32, 256, 64),
                                            (np.uint8, 256, 1)])
def test_hist_wave_gather_mxu_matches_pallas_interpreter(use_bf16, bins_dtype,
                                                         B, N):
    """K3's plain version against the JAX kernel body itself (Pallas
    interpreter), and against the full scan over the same rows."""
    bins, pos, g, h, ids, M = _case(2048, 4, B, N, 5 + B + N, bins_dtype)
    rows, idx, pg, gg, hg = _compacted(bins, pos, g, h, ids, 2048)
    want = np.asarray(jhist.hist_wave_gather(
        *[jnp.asarray(a) for a in (rows, idx, pg, gg, hg, ids)], B,
        mode="mxu", use_bf16=use_bf16, bm_g=512, interpret=True))
    before = hist.hist_wave_gather_mxu.launches
    got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg), _t(hg),
                                _t(ids), B, mode="mxu", max_nodes=M,
                                use_bf16=use_bf16)
    assert hist.hist_wave_gather_mxu.launches == before
    assert got.dtype == torch.float32 and got.shape == (N, 4, B, 3)
    assert_hist_close(got.numpy(), want)
    full = hist.hist_wave(_t(bins), _t(pos), _t(g), _t(h), _t(ids), B,
                          max_nodes=M, use_bf16=use_bf16)
    assert_hist_close(got.numpy(), full.numpy())


def test_bf16_rounding_is_jax_astype():
    """The plain versions round g exactly as jnp.asarray(g, jnp.bfloat16)
    does (to nearest, ties to even), before any sum."""
    _, _, g, _, _, _ = _case(50000, 1, 16, 1, 9, np.uint8)
    g[:4] = [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),
             3.0e38]  # two ties to even, a negative tie, a large value
    want = np.asarray(jnp.asarray(g, jnp.bfloat16).astype(jnp.float32))
    got = hist.round_bf16(_t(g)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1.0 and got[1] == 1.0 + 4 * 2.0 ** -8
    # one row per bin: the histogram holds each rounded value itself
    n = 256
    bins = np.arange(n, dtype=np.int32)[None, :]
    out = hist.hist_wave(_t(bins), _t(np.zeros(n, np.int32)), _t(g[:n]),
                         _t(g[:n]), _t(np.zeros(1, np.int32)), n,
                         max_nodes=1, use_bf16=True)
    np.testing.assert_array_equal(out[0, 0, :, 0].numpy(), want[:n])
    out32 = hist.hist_wave(_t(bins), _t(np.zeros(n, np.int32)), _t(g[:n]),
                           _t(g[:n]), _t(np.zeros(1, np.int32)), n,
                           max_nodes=1, use_bf16=False)
    np.testing.assert_array_equal(out32[0, 0, :, 0].numpy(), g[:n])


def test_gather_modes_and_lengths_are_checked():
    bins, pos, g, h, ids, M = _case(600, 3, 16, 7, 4, np.uint8)
    rows, idx, pg, gg, hg = _compacted(bins, pos, g, h, ids, 1024)
    with pytest.raises(ValueError, match="mode must be int8|mxu"):
        hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg), _t(hg),
                              _t(ids), 16, mode="f16", max_nodes=M)
    with pytest.raises(ValueError, match="pos_g must have shape"):
        hist.hist_wave_gather(_t(rows), _t(idx), _t(pg[:512]), _t(gg),
                              _t(hg), _t(ids), 16, mode="mxu", max_nodes=M)
    with pytest.raises(ValueError, match="g must have shape"):
        hist.hist_wave(_t(bins), _t(pos), _t(g[:512]), _t(h), _t(ids), 16,
                       max_nodes=M)


# -- the plain version's accumulation at large n ------------------------------
# All 2^19 rows in one node and one bin sum into one f32 cell. A sequential
# f32 accumulation (index_add_ into f32) drifts: past 2^16 its ulp exceeds
# the bits of 0.2001953125 (bf16(0.2) = 205 / 1024), so every add rounds.
# The plain version accumulates in float64 and rounds once; every input is
# a bf16 value here, so the float64 sums are exact and the plain version
# must equal them rounded to f32. XLA's blocked dot (`_hist_dense`) holds
# to the same sums at rtol 1e-6.

N_BIG = 1 << 19
H_TIE = np.float32(0.2)  # bf16 rounds it to 0.2001953125


def _big_case(random: bool):
    """F = 2, B = 4, one node (id 0): every row in bin 1 with g = -0.3 and
    h = 0.2 (bf16-rounded), or random bins, bf16 g/h and dead rows."""
    rng = np.random.RandomState(7)
    if random:
        bins = rng.randint(0, 4, size=(2, N_BIG)).astype(np.uint8)
        pos = np.where(rng.rand(N_BIG) < 0.1, -1, 0).astype(np.int32)
        g = rng.randn(N_BIG).astype(np.float32)
        h = (rng.rand(N_BIG) + 0.1).astype(np.float32)
    else:
        bins = np.ones((2, N_BIG), np.uint8)
        pos = np.zeros(N_BIG, np.int32)
        g = np.full(N_BIG, -0.3, np.float32)
        h = np.full(N_BIG, H_TIE, np.float32)
    g = hist.round_bf16(_t(g)).numpy()
    h = hist.round_bf16(_t(h)).numpy()
    return bins, pos, g, h, np.zeros(1, np.int32)


def _f64_sums(bins, pos, g, h):
    """(1, F, B, 3): the exact sums (bf16 inputs, float64 accumulation)
    rounded once to f32."""
    F, B = bins.shape[0], 4
    live = pos == 0
    out = np.zeros((1, F, B, 3), np.float64)
    for f in range(F):
        b = bins[f, live].astype(np.int64)
        for c, v in enumerate((g[live], h[live], np.ones(live.sum()))):
            out[0, f, :, c] = np.bincount(b, weights=v.astype(np.float64),
                                          minlength=B)
    return out.astype(np.float32)


def _dense(bins, pos, g, h, ids):
    out = jhist._hist_dense(jnp.asarray(bins.astype(np.int32)),
                            jnp.asarray(pos), jnp.asarray(g), jnp.asarray(h),
                            jnp.asarray(ids), 4, use_bf16=True)
    return np.transpose(np.asarray(out).reshape(2, 3, 1, 4), (2, 0, 3, 1))


def test_sequential_f32_accumulation_drifts_from_hist_dense():
    """What the float64 accumulation repairs: the one-bin case summed the
    way the plain version did before, index_add_ into one f32 cell, lands
    far from the exact sums, where `_hist_dense` stays within 1e-6."""
    bins, pos, g, h, ids = _big_case(random=False)
    exact = _f64_sums(bins, pos, g, h)[0, 0, 1, 1]
    assert exact == np.float32(N_BIG * 205 / 1024)  # 104960, exact
    cell = torch.zeros((1,), dtype=torch.float32)
    cell.index_add_(0, torch.zeros(N_BIG, dtype=torch.long), _t(h))
    assert abs(float(cell[0]) - exact) > 1e-3 * exact
    np.testing.assert_allclose(_dense(bins, pos, g, h, ids)[0, 0, 1, 1],
                               exact, rtol=1e-6)


@pytest.mark.parametrize("random", [False, True])
@pytest.mark.parametrize("use_bf16", [True, False])
@pytest.mark.parametrize("path", ["wave", "gather"])
def test_plain_sums_are_float64_rounded_once(path, use_bf16, random):
    bins, pos, g, h, ids = _big_case(random)
    if path == "wave":
        got = hist.hist_wave(_t(bins), _t(pos), _t(g), _t(h), _t(ids), 4,
                             max_nodes=1, use_bf16=use_bf16)
    else:
        rows, idx, pg, gg, hg = _compacted(bins, pos, g, h, ids, N_BIG)
        got = hist.hist_wave_gather(_t(rows), _t(idx), _t(pg), _t(gg),
                                    _t(hg), _t(ids), 4, mode="mxu",
                                    max_nodes=1, use_bf16=use_bf16)
    want = _f64_sums(bins, pos, g, h)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.numpy(), _dense(bins, pos, g, h, ids),
                               rtol=1e-6)
