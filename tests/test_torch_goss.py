"""GOSS and the row/feature sampling rates in the port against the JAX
package.

`engine.grow` with GOSS against the reference's `make_grow_tree` on the
same bins, gradients and key: the top `goss_a` rows by |g| (ties to the
lowest index), `goss_b` of the rest by the threefry draw, amplified by
1/b, compacted in order into the fit matrix. The reference runs as its own
tests run it on the CPU (`force_dense`) and, as bench.py runs it, without
x64: with x64 (the suite's conftest) `jax.random.uniform` draws float64,
which the port does not twin.

Tolerances. int8: trees (every integer field and cnt), `pos`, `aux_pos`
and the wave log exact; leaf/gain/hess at rtol 1e-5 (the reference's fused
program adds f32 in another order, tests/test_torch_engine.py). f32: the
histograms are float sums in another order, so the data is first checked
to have every chosen split beat its runner-up by more than 1e-4 relative
on the fit rows (split_margins); then the same fields are exact.

Trainers: l2 runs are exact in every tree's integer fields and split
values, leaves at rtol 1e-5. Under sigmoid `torch.sigmoid` and
`jax.nn.sigmoid` may differ in the last ulp, which can swap the row at the
k_a boundary in a later round, so round 0 is held exactly, later rounds
through `grow` fed the same gradients, mask and key on both sides, and the
run's losses at rtol 1e-4 and test AUC at 1e-4 absolute.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt import engine as jengine
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import engine, prng, state
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from test_torch_engine import _assert_same_tree, _jspec, split_margins
from test_torch_trainer import N_TEST, N_TRAIN, NAMES, _data, _fields


def _l2_case(n, F, B, seed):
    """Bins with a planted signal and l2 gradients (g = pred - y, h = 1);
    a run of exact |g| ties at the top of the order."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, B, size=(n, F)).astype(np.int32)
    y = 0.1 * bins[:, 0] - 0.07 * bins[:, 1] + 0.9 * (bins[:, 2] > B // 2) \
        + 0.3 * rng.randn(n)
    g = (0.5 - y).astype(np.float32)
    g[rng.rand(n) < 0.05] = np.float32(3.0)  # ties at the top
    return bins, g, np.ones(n, np.float32)


def _grow_pair(jspec, bins, g, h, include, seed, aux=None):
    """make_grow_tree (no x64) and engine.grow on the same inputs and key.
    Returns (want tree, jpos, jaux, jwlog, got tree, pos, aux, wlog)."""
    n, F = bins.shape
    bins_t = np.ascontiguousarray(bins.T)
    aux = () if aux is None else (aux,)
    with jax.enable_x64(False):
        jtr, jpos, jaux, jwlog = jax.jit(
            lambda *a, key: jengine.make_grow_tree(jspec)(*a, key=key))(
            jnp.asarray(bins_t), jnp.asarray(include), jnp.asarray(g),
            jnp.asarray(h), jnp.ones((F,), bool),
            tuple(jnp.asarray(a) for a in aux),
            key=jax.random.PRNGKey(seed))
        want = {k: np.asarray(v) for k, v in jtr._asdict().items()}
        jpos, jwlog = np.asarray(jpos), np.asarray(jwlog)
        jaux = [np.asarray(a) for a in jaux]
    spec = state.grow_spec_from_fields(dataclasses.asdict(jspec))
    u8 = (lambda t: t.to(torch.uint8)) if jspec.B <= 256 else (lambda t: t)
    tr, pos, paux, wlog = engine.grow(
        spec, u8(torch.from_numpy(bins_t)), torch.from_numpy(include),
        torch.from_numpy(g), torch.from_numpy(h),
        torch.ones(F, dtype=torch.bool),
        aux=tuple(u8(torch.from_numpy(a)) for a in aux),
        key=prng.PRNGKey(seed))
    return (want, jpos, jaux, jwlog, state.tree_arrays_to_numpy(tr),
            pos.numpy(), [a.numpy() for a in paux], wlog.numpy())


def _counts(n_eff, a, b):
    k_a = max(1, min(n_eff, int(np.ceil(a * n_eff))))
    k_b = min(n_eff - k_a, int(np.ceil(b * (n_eff - k_a)))) if b > 0 else 0
    return k_a, k_b


@pytest.mark.parametrize("mode,a,b,scale", [
    ("int8", 0.2, 0.125, 1.0), ("int8", 0.3, 0.0, 0.9),
    ("int8", 0.5, 0.5, 0.95), ("int8", 0.1, 0.3, 1.0),
    ("f32", 0.2, 0.125, 1.0), ("f32", 0.4, 0.0, 0.9),
])
def test_grow_with_goss_matches_make_grow_tree(mode, a, b, scale):
    n, F, B = 4096, 6, 32
    bins, g, h = _l2_case(n, F, B, 11)
    include = np.random.RandomState(3).rand(n) < 0.95
    test = np.random.RandomState(4).randint(0, B, size=(F, 1500)).astype(
        np.int32)
    jspec = _jspec(F, B, hist_mode="int8" if mode == "int8" else "mxu",
                   use_bf16=False, goss_a=a, goss_b=b, goss_scale=scale,
                   min_h=1.0)
    want, jpos, jaux, jwlog, got, pos, aux, wlog = _grow_pair(
        jspec, bins, g, h, include, 11, aux=test)
    if mode == "f32":
        spec = state.grow_spec_from_fields(dataclasses.asdict(jspec))
        fb, fin, fg, fh, _ = engine.goss_sample(
            spec, torch.from_numpy(np.ascontiguousarray(bins.T)),
            torch.from_numpy(include), torch.from_numpy(g),
            torch.from_numpy(h), prng.PRNGKey(11))
        m = split_margins(got, fb.t().long().numpy(), fg.numpy(), fh.numpy(),
                          fin.numpy(), jspec.l2, jspec.min_h, False)
        assert len(m) == 31 and m.min() > 1e-4, m.min()
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos, jpos)
    assert len(aux) == len(jaux) == 2
    for x, y in zip(aux, jaux):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(wlog, jwlog)
    k_a, k_b = _counts(int(np.ceil(scale * n)), a, b)
    kept = min(k_a + k_b, int(include.sum()))
    assert wlog[0, 4] == kept == got["cnt"][0]
    assert wlog[0, 0] == min(n, -(-(k_a + k_b) // 128) * 128)
    assert len(pos) == wlog[0, 0] and len(aux[0]) == n


def test_goss_ties_keep_the_lowest_index():
    """Round 0 of a sigmoid run: every |g| is 0.5, so the kept set is pure
    tie-break, the first k_a rows, as jax.lax.top_k keeps them."""
    n, F, B = 2048, 4, 16
    bins = np.random.RandomState(5).randint(0, B, size=(n, F)).astype(
        np.int32)
    g = np.where(np.arange(n) % 3 == 0, 0.5, -0.5).astype(np.float32)
    h = np.full(n, 0.25, np.float32)
    jspec = _jspec(F, B, goss_a=0.25, goss_b=0.0, max_nodes=15,
                   max_leaves=8)
    want, jpos, _, jwlog, got, pos, aux, wlog = _grow_pair(
        jspec, bins, g, h, np.ones(n, bool), 0)
    _assert_same_tree(want, got)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_array_equal(wlog, jwlog)
    spec = state.grow_spec_from_fields(dataclasses.asdict(jspec))
    fb, *_ = engine.goss_sample(
        spec, torch.from_numpy(np.ascontiguousarray(bins.T)),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(g),
        torch.from_numpy(h), prng.PRNGKey(0))
    np.testing.assert_array_equal(fb.numpy()[:, :512], bins.T[:, :512])


@pytest.mark.parametrize("b", [0.0, 0.5])
def test_goss_off_is_the_present_path(b):
    """goss_a >= 1 takes the unsampled path bit for bit, whatever b."""
    n, F, B = 3000, 5, 16
    bins, g, h = _l2_case(n, F, B, 2)
    spec = state.grow_spec_from_fields(dataclasses.asdict(
        _jspec(F, B, max_nodes=31, max_leaves=16)))
    args = (torch.from_numpy(np.ascontiguousarray(bins.T)).to(torch.uint8),
            torch.ones(n, dtype=torch.bool), torch.from_numpy(g),
            torch.from_numpy(h), torch.ones(F, dtype=torch.bool))
    ref = engine.grow(spec, *args)
    off = engine.grow(dataclasses.replace(spec, goss_a=1.0, goss_b=b), *args,
                      key=prng.PRNGKey(9))
    for x, y in zip(ref[0], off[0]):
        assert torch.equal(x, y)
    assert torch.equal(ref[1], off[1]) and torch.equal(ref[3], off[3])


def test_goss_full_keep_runs_machinery_bit_identical():
    """k_a == n runs the whole sampling path (sort, compaction, the full
    matrix routed as aux[0]) and reproduces the unsampled tree exactly."""
    rng = np.random.RandomState(3)
    n, F, B = 512, 4, 16
    bins_t = torch.from_numpy(rng.randint(0, B, size=(F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    h = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32) + 0.1)
    spec = state.grow_spec_from_fields(dataclasses.asdict(_jspec(
        F, B, max_nodes=15, wave=2, max_depth=10, max_leaves=8, lr=0.3,
        ladder=(8, 32))))
    args = (bins_t, torch.ones(n, dtype=torch.bool), g, h,
            torch.ones(F, dtype=torch.bool))
    tr_ref, pos_ref, _, _ = engine.grow(spec, *args)
    tr_g, _pos_fit, aux_pos, wlog_g = engine.grow(
        dataclasses.replace(spec, goss_a=0.999, goss_b=0.0), *args,
        key=prng.PRNGKey(0))
    for k in ("feat", "slot", "slot_r", "left", "right", "leaf", "cnt",
              "n_nodes"):
        assert torch.equal(getattr(tr_ref, k), getattr(tr_g, k)), k
    assert torch.equal(pos_ref, aux_pos[0])
    assert float(wlog_g[0, 4]) == n


def _dense_data(n=1200, F=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F).astype(np.float32)
    logit = X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) + 0.5 * (X[:, 3] > 0)
    y = (logit + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return GBDTData(X=X, y=y, weight=np.ones(n, np.float32), n_real=n,
                    feature_names=[str(i) for i in range(F)])


def _params(tmp_path, **over):
    kw = dict(round_num=3, max_depth=20, max_leaf_cnt=12,
              tree_grow_policy="loss", learning_rate=0.3,
              min_child_hessian_sum=1.0, loss_function="sigmoid",
              eval_metric=["auc"], approximate=[ApproximateSpec(max_cnt=32)],
              model=ModelParams(data_path=str(tmp_path / "m.model"),
                                dump_freq=0))
    kw.update(over)
    return GBDTParams(**kw)


def test_goss_sample_counts_and_obs(tmp_path):
    """Kept rows = ceil(a n) + ceil(b (n - ceil(a n))): the root sample
    count, the wave log's column 4 and time_stats; the fit matrix is the
    compacted width. (The reference's obs counters wait for ROADMAP 1.12.)"""
    n, a, b = 1200, 0.3, 0.2
    k_a = int(np.ceil(a * n))
    k_b = int(np.ceil(b * (n - k_a)))
    tr = GBDTTrainer(_params(tmp_path), device="cpu", wave=4, goss=(a, b))
    res = tr.train(train=_dense_data(n=n))
    for t in res.model.trees:
        assert t.sample_cnt[0] == k_a + k_b
    wl = tr.wave_log
    used = wl[..., 3] > 0
    assert np.all(wl[:, 0, 4][used.any(-1)] == k_a + k_b)
    assert wl[0, 0, 0] <= np.ceil((k_a + k_b) / 128) * 128
    ts = tr.time_stats
    assert ts["goss"] is True and ts["goss_rows_per_tree"] == k_a + k_b
    assert (ts["goss_a"], ts["goss_b"]) == (a, b)
    assert res.train_metrics["auc"] > 0.8


def test_goss_b_amplification_changes_stats(tmp_path):
    """b > 0 amplifies the drawn rows by 1/b: the root hessian exceeds the
    top-only run's and approximates the full data's."""
    data = _dense_data(n=1200)

    def root_hess(goss):
        tr = GBDTTrainer(_params(tmp_path, round_num=1), device="cpu",
                         wave=4, goss=goss)
        return tr.train(train=data).model.trees[0].hess_sum[0]

    h_top, h_amp, h_full = (root_hess((0.3, 0.0)), root_hess((0.3, 0.5)),
                            root_hess((1.0, 0.0)))
    assert h_amp > h_top
    assert h_amp == pytest.approx(h_full, rel=0.25)


class _Recording(GBDTTrainer):
    """Keeps each round's weighted gradients, sampling masks and key."""

    def _round(self, rnd, dd, spec, st):
        g, h = self.loss.grad_hess(self.loss.predict(st[0]), dd.y)
        include, fmask = self._sample_masks(rnd, dd)
        key = self._goss_key(rnd, 0)
        out = super()._round(rnd, dd, spec, st)
        tree = {k: v[rnd].numpy() for k, v in out[2].items()}
        self.rounds.append(((g * dd.weight).numpy(), (h * dd.weight).numpy(),
                            include.numpy(), fmask.numpy(), key, tree))
        return out


def _train_both(tmp, loss, goss, **over):
    X, y = _data(loss)
    n = N_TRAIN
    w, wt = np.ones(n, np.float32), np.ones(N_TEST, np.float32)
    kw = _fields(loss, **over)
    jp = JParams(approximate=[JSpec(max_cnt=63)],
                 model=JModelParams(data_path=str(tmp / "j"), dump_freq=0),
                 **kw)
    pp = GBDTParams(approximate=[ApproximateSpec(max_cnt=63)],
                    model=ModelParams(data_path=str(tmp / "p"), dump_freq=0),
                    **kw)
    with jax.enable_x64(False):
        jres = JTrainer(jp, engine="device", hist_precision="int8", wave=4,
                        goss=goss).train(
            JData(X[:n], y[:n], w, n, NAMES),
            JData(X[n:], y[n:], wt, N_TEST, NAMES))
    ptr = _Recording(pp, hist_precision="int8", wave=4, device="cpu",
                     goss=goss)
    ptr.rounds = []
    pres = ptr.train(GBDTData(X[:n], y[:n], w, n, NAMES),
                     GBDTData(X[n:], y[n:], wt, N_TEST, NAMES))
    return jres, pres, ptr


RATES = {"instance_sample_rate": 0.8, "feature_sample_rate": 0.6}


@pytest.mark.parametrize("goss,over", [
    ((0.2, 0.125), {}), ((1.0, 0.0), RATES), ((0.3, 0.2), RATES)],
    ids=["goss", "rates", "goss+rates"])
def test_l2_trainer_with_sampling_matches_jax(tmp_path, goss, over):
    jres, pres, ptr = _train_both(tmp_path, "l2", goss, **over)
    assert len(pres.model.trees) == len(jres.model.trees) == 5
    for a, b in zip(pres.model.trees, jres.model.trees):
        for f in ("feat", "feat_name", "left", "right", "slot", "sample_cnt",
                  "default_left", "split"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose([r[key] for r in pres.round_log],
                                   [r[key] for r in jres.round_log],
                                   rtol=1e-5)
    roots = {t.sample_cnt[0] for t in pres.model.trees}
    if goss[0] < 1:  # GOSS keeps k_a + k_b of the (drawn) rows
        k_a = int(np.ceil(goss[0] * N_TRAIN))
        assert roots == {k_a + int(np.ceil(goss[1] * (N_TRAIN - k_a)))}
    else:  # the row mask drew about 80% of the rows, varying by round
        assert len(roots) > 1 and max(roots) < 0.85 * N_TRAIN
    if over:
        fm = [r[3] for r in ptr.rounds]
        assert all(m.any() for m in fm) and not all(m.all() for m in fm)


def test_sigmoid_trainer_with_sampling_matches_jax(tmp_path):
    goss = (0.3, 0.2)
    jres, pres, ptr = _train_both(tmp_path, "sigmoid", goss, **RATES)
    a, b = pres.model.trees[0], jres.model.trees[0]
    for f in ("feat", "feat_name", "left", "right", "slot", "sample_cnt",
              "default_left", "split"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose([r[key] for r in pres.round_log],
                                   [r[key] for r in jres.round_log],
                                   rtol=1e-4)
    assert abs(pres.test_metrics["auc"] - jres.test_metrics["auc"]) <= 1e-4
    # every later round: the reference's grow on the port's gradients,
    # masks and key grows the port's tree
    spec = ptr.grow_spec
    bins_t = ptr.dev_inputs.bins_t
    jspec = jengine.GrowSpec(force_dense=True, **dataclasses.asdict(spec))
    for rnd, (g, h, include, fmask, key, got) in enumerate(ptr.rounds[1:],
                                                           1):
        with jax.enable_x64(False):
            jtr, *_ = jax.jit(
                lambda *x, key: jengine.make_grow_tree(jspec)(*x, key=key))(
                jnp.asarray(bins_t.numpy()), jnp.asarray(include),
                jnp.asarray(g), jnp.asarray(h), jnp.asarray(fmask),
                key=jnp.asarray(key.numpy().astype(np.uint32)))
        for k in ("feat", "slot", "slot_r", "left", "right", "cnt"):
            np.testing.assert_array_equal(got[k], np.asarray(getattr(jtr, k)),
                                          err_msg=f"round {rnd} {k}")
        assert int(got["n_nodes"]) == int(jtr.n_nodes)
