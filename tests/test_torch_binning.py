"""The port's device binning and bin-edge sidecar against the JAX package.

Both sides bin the same seeded columns: `build_bins_maybe_device` with the
single sample_by_quantile spec (uniform and weighted), `bin_matrix_device`
(NaN, values above the last representative, values exactly at
midpoints), the host `bin_matrix`, EFB's candidate filter, and the
`.bins.json` sidecar. Every comparison is exact.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.gbdt import binning as jbin
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams
from ytklearn_tpu_torch.gbdt import binning
from ytklearn_tpu_torch.io.fs import LocalFileSystem


def _matrix(n=3000, seed=0):
    """Columns: continuous, continuous with NaN, low cardinality (keeps
    every distinct value), constant, heavy ties, and a wide-range one."""
    rng = np.random.RandomState(seed)
    X = np.empty((n, 6), np.float32)
    X[:, 0] = rng.randn(n)
    X[:, 1] = rng.randn(n) * 3
    X[rng.rand(n) < 0.1, 1] = np.nan
    X[:, 2] = rng.randint(0, 7, n)
    X[:, 3] = 2.5
    X[:, 4] = np.round(rng.randn(n), 1)
    X[:, 5] = rng.exponential(100.0, n)
    return X


def _params(max_cnt, **spec):
    return (JParams(approximate=[JSpec(max_cnt=max_cnt, **spec)]),
            GBDTParams(approximate=[ApproximateSpec(max_cnt=max_cnt,
                                                    **spec)]))


@pytest.mark.parametrize("max_cnt", [8, 63, 255])
@pytest.mark.parametrize("weighted", [False, True])
def test_build_bins_matches_jax(max_cnt, weighted):
    X = _matrix(seed=max_cnt)
    rng = np.random.RandomState(1)
    w = (rng.rand(X.shape[0]) * 2).astype(np.float32) if weighted \
        else np.ones(X.shape[0], np.float32)
    spec = {"use_sample_weight": True, "alpha": 0.5} if weighted else {}
    jp, pp = _params(max_cnt, **spec)
    want = jbin.build_bins_maybe_device(X, jnp.asarray(X.T), w, jp)
    got = binning.build_bins_maybe_device(torch.from_numpy(X.T.copy()), w,
                                          pp)
    assert got.max_bins == want.max_bins
    np.testing.assert_array_equal(got.counts, want.counts)
    np.testing.assert_array_equal(got.values, want.values)


def test_bin_matrix_device_matches_jax_with_nan_overrange_and_midpoints():
    X = _matrix(seed=5)
    jp, pp = _params(31)
    bins = binning.build_bins_maybe_device(torch.from_numpy(X.T.copy()),
                                           None, pp)
    # rows exactly at midpoints, at representatives, above the last one,
    # below the first one, and NaN
    Xq = X[:400].copy()
    for f in range(X.shape[1]):
        cnt = int(bins.counts[f])
        v = bins.values[f, :cnt]
        if cnt > 1:
            mids = (0.5 * (v[:-1] + v[1:])).astype(np.float32)
            Xq[: len(mids), f] = mids[:400]
            Xq[100:100 + min(cnt, 50), f] = v[:50]
        Xq[300, f] = v[-1] + 1.0
        Xq[301, f] = np.inf
        Xq[302, f] = -np.inf
        Xq[303, f] = np.nan
    want = np.asarray(jbin.bin_matrix_device(jnp.asarray(Xq.T), bins))
    got = binning.bin_matrix_device(torch.from_numpy(Xq.T.copy()), bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, 303] == bins.counts - 1).all()  # NaN -> last bin
    # the host rule agrees off NaN (host NaN ordering differs by design)
    np.testing.assert_array_equal(
        binning.bin_matrix(Xq[:300], bins), jbin.bin_matrix(Xq[:300], bins))


def test_other_approximate_specs_are_not_ported():
    for spec in ([ApproximateSpec(type="sample_by_cnt")],
                 [ApproximateSpec(), ApproximateSpec(cols="f1")]):
        with pytest.raises(NotImplementedError, match="ROADMAP.md 1.5"):
            binning.build_bins_maybe_device(
                torch.zeros(2, 10), None, GBDTParams(approximate=spec))


def test_efb_candidates_match_and_a_plan_raises():
    """The candidate filter equals the reference's; where the reference
    plans a bundle the port now plans the same one (it used to raise),
    and on dense data neither plans."""
    rng = np.random.RandomState(2)
    n = 2000
    X = rng.randn(n, 4).astype(np.float32)
    for f in (1, 3):  # two mutually exclusive sparse non-negative columns
        X[:, f] = 0.0
    X[rng.rand(n) < 0.2, 1] = 1.0
    X[(X[:, 1] == 0) & (rng.rand(n) < 0.2), 3] = 2.0
    jp, pp = _params(31)
    bins = binning.build_bins_maybe_device(torch.from_numpy(X.T.copy()),
                                           None, pp)
    nnz = (X != 0).sum(0)
    mins = X.min(0)
    want = jbin.efb_candidates(nnz, mins, bins, n)
    np.testing.assert_array_equal(
        binning.efb_candidates(nnz, mins, bins, n), want)
    assert want.tolist() == [1, 3]
    jplan = jbin.build_bundle_plan(X.T, bins, 0, 32)
    plan = binning.build_bundle_plan(torch.from_numpy(X.T.copy()), bins, 0,
                                     32)
    assert jplan is not None and plan.bundles == jplan.bundles == [[1, 3]]
    np.testing.assert_array_equal(plan.col_fid, jplan.col_fid)
    assert (plan.member_lo, plan.member_hi) == (jplan.member_lo,
                                                jplan.member_hi)
    dense = rng.randn(n, 4).astype(np.float32)
    dbins = binning.build_bins_maybe_device(
        torch.from_numpy(dense.T.copy()), None, pp)
    assert jbin.build_bundle_plan(dense.T, dbins, 0, 32) is None
    assert binning.build_bundle_plan(torch.from_numpy(dense.T.copy()),
                                     dbins, 0, 32) is None


@pytest.mark.parametrize("split_type", ["mean", "median"])
def test_sidecar_and_split_values_match_byte_for_byte(tmp_path, split_type):
    X = _matrix(seed=9)
    jp, pp = _params(63)
    bins = binning.build_bins_maybe_device(torch.from_numpy(X.T.copy()),
                                           None, pp)
    jb = jbin.FeatureBins(values=bins.values, counts=bins.counts,
                          max_bins=bins.max_bins)
    names = [f"c{i}" for i in range(X.shape[1])]
    text = "base_prediction=0.5\nclass_num=1\n"
    digest = binning.model_text_digest(text)
    assert digest == jbin.model_text_digest(text)
    mine = str(tmp_path / "port.model")
    ref = str(tmp_path / "ref.model")
    assert binning.bin_edges_path(mine) == jbin.bin_edges_path(mine)
    binning.dump_bin_edges(LocalFileSystem(), binning.bin_edges_path(mine),
                           names, bins, split_type, digest)
    jbin.dump_bin_edges(JFS(), jbin.bin_edges_path(ref), names, jb,
                        split_type, digest)
    with open(binning.bin_edges_path(mine), "rb") as a, \
            open(jbin.bin_edges_path(ref), "rb") as b:
        assert a.read() == b.read()
    assert not [p for p in os.listdir(tmp_path) if ".tmp-" in p]
    for f in range(X.shape[1]):
        cnt = int(bins.counts[f])
        for lo in range(max(cnt - 1, 1)):
            for hi in (None, min(lo + 2, cnt - 1)):
                a = bins.split_value(f, lo, hi, split_type)
                b = jb.split_value(f, lo, hi, split_type)
                assert a == b or (np.isnan(a) and np.isnan(b))
