"""The port's GBDT trainer against the JAX package's device trainer.

Both train the same seeded data on the CPU (`device="cpu"` for the port;
the JAX trainer takes its CPU path, `force_dense`) with
hist_precision="int8", and with the f32 and bf16 histograms.

Tolerances. l2: gradients are exact in both packages, so the trees'
integer fields (features, children, slots, sample counts) and their split
values are compared exactly; leaf values and per-round losses at rtol 1e-5
(the f32 split sums differ in order inside the reference's fused program,
tests/test_torch_engine.py). sigmoid: torch.sigmoid and jax.nn.sigmoid may
differ in the last ulp, so per-round losses are held at rtol 1e-4 and the
test AUC at 1e-4 absolute. The JAX GBDTPredictor must load the port's dump
and score the training rows as the port's final f32 scores do (rtol 1e-5,
atol 1e-5: the predictor sums in f64).

f32/bf16 histograms are float sums in another order than the reference's,
so trees can differ only where two candidate splits lie within that noise
(about 1e-6 relative). The f32 l2 run is on data where every chosen split
beats its runner-up by more than 1e-4 relative (asserted, per round, by
test_torch_engine.split_margins); there the trees' integer fields are
exact and the leaves at rtol 1e-5. The bf16 sigmoid run holds per-round
losses at rtol 1e-4 and the test AUC at 1e-4 absolute, as the int8 one.
"""

import dataclasses
import hashlib
import json

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt.binning import FeatureBins as JBins
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu.predict import create_predictor
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt import engine, hist, state
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.tree import GBDTModel
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from test_torch_engine import split_margins

N_TRAIN, N_TEST, F, ROUNDS = 8192, 4096, 6, 5
NAMES = [f"f{i}" for i in range(F)]


def _data(loss, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(N_TRAIN + N_TEST, F).astype(np.float32)
    logit = 1.5 * X[:, 0] * X[:, 1] + np.sin(2 * X[:, 2]) \
        + 0.8 * (X[:, 3] > 0.5)
    if loss == "l2":
        y = (logit + rng.randn(len(X)) * 0.3).astype(np.float32)
    else:
        y = ((logit + rng.randn(len(X)) * 0.5) > 0).astype(np.float32)
    return X, y


def _fields(loss, **over):
    kw = dict(round_num=ROUNDS, max_depth=6, max_leaf_cnt=16,
              tree_grow_policy="loss", learning_rate=0.1,
              min_child_hessian_sum=5.0 if loss == "l2" else 1.0,
              loss_function=loss,
              eval_metric=["auc"] if loss == "sigmoid" else ["rmse", "mae"])
    kw.update(over)
    return kw


class _Recording(GBDTTrainer):
    """Keeps each round's weighted gradients and tree arrays."""

    def _round(self, rnd, dd, spec, state):
        g, h = self.loss.grad_hess(self.loss.predict(state[0]), dd.y)
        out = super()._round(rnd, dd, spec, state)
        tree = {k: v[rnd].numpy() for k, v in out[2].items()}
        self.rounds.append((tree, (g * dd.weight).numpy(),
                            (h * dd.weight).numpy()))
        return out


def _train_both(tmp, loss, wave=4, precision="int8", **over):
    X, y = _data(loss)
    n = N_TRAIN
    w, wt = np.ones(n, np.float32), np.ones(N_TEST, np.float32)
    kw = _fields(loss, **over)
    jpath, ppath = str(tmp / f"jax_{loss}.model"), str(tmp / f"port_{loss}.model")
    jp = JParams(approximate=[JSpec(max_cnt=63)],
                 model=JModelParams(data_path=jpath, dump_freq=0), **kw)
    pp = GBDTParams(approximate=[ApproximateSpec(max_cnt=63)],
                    model=ModelParams(data_path=ppath, dump_freq=0,
                                      feature_importance_path=ppath + ".imp"),
                    **kw)
    jres = JTrainer(jp, engine="device", hist_precision=precision,
                    wave=wave).train(
        JData(X[:n], y[:n], w, n, NAMES), JData(X[n:], y[n:], wt, N_TEST,
                                                 NAMES))
    ptr = _Recording(pp, hist_precision=precision, wave=wave, device="cpu")
    ptr.rounds = []
    pres = ptr.train(GBDTData(X[:n], y[:n], w, n, NAMES),
                     GBDTData(X[n:], y[n:], wt, N_TEST, NAMES))
    return {"X": X, "y": y, "jres": jres, "pres": pres, "ptr": ptr,
            "jpath": jpath, "ppath": ppath}


@pytest.fixture(scope="module")
def l2_run(tmp_path_factory):
    return _train_both(tmp_path_factory.mktemp("l2"), "l2")


@pytest.fixture(scope="module")
def sigmoid_run(tmp_path_factory):
    return _train_both(tmp_path_factory.mktemp("sigmoid"), "sigmoid")


@pytest.fixture(scope="module")
def l2_f32_run(tmp_path_factory):
    return _train_both(tmp_path_factory.mktemp("l2_f32"), "l2",
                       precision="f32")


@pytest.fixture(scope="module")
def sigmoid_bf16_run(tmp_path_factory):
    return _train_both(tmp_path_factory.mktemp("sigmoid_bf16"), "sigmoid",
                       precision="bf16")


def _losses(res, key):
    return np.asarray([r[key] for r in res.round_log])


def test_l2_trees_equal_in_their_integer_fields(l2_run):
    jm, pm = l2_run["jres"].model, l2_run["pres"].model
    assert len(pm.trees) == len(jm.trees) == ROUNDS
    assert pm.base_prediction == jm.base_prediction
    for a, b in zip(pm.trees, jm.trees):
        for f in ("feat", "feat_name", "left", "right", "slot", "sample_cnt",
                  "default_left", "split"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-7)
        assert a.n_nodes() > 8


def test_l2_losses_and_metrics(l2_run):
    j, p = l2_run["jres"], l2_run["pres"]
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(p, key), _losses(j, key),
                                   rtol=1e-5)
    assert _losses(p, "train_loss")[-1] < _losses(p, "train_loss")[0]
    np.testing.assert_allclose(p.train_loss, j.train_loss, rtol=1e-5)
    for k in ("rmse", "mae"):
        np.testing.assert_allclose(p.test_metrics[k], j.test_metrics[k],
                                   rtol=1e-5)


def test_sigmoid_losses_and_auc(sigmoid_run):
    j, p = sigmoid_run["jres"], sigmoid_run["pres"]
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(p, key), _losses(j, key),
                                   rtol=1e-4)
    assert abs(p.test_metrics["auc"] - j.test_metrics["auc"]) <= 1e-4
    assert p.test_metrics["auc"] > 0.75
    np.testing.assert_allclose(p.test_loss, j.test_loss, rtol=1e-4)


def test_f32_l2_trees_equal_in_their_integer_fields(l2_f32_run):
    run = l2_f32_run
    ptr = run["ptr"]
    assert ptr.grow_spec.hist_mode == "mxu" and not ptr.grow_spec.use_bf16
    bins = ptr.dev_inputs.bins_t.t().long().numpy()
    include = ptr.dev_inputs.real_mask.numpy()
    spec = ptr.grow_spec
    for tree, g, h in ptr.rounds:
        m = split_margins(tree, bins, g, h, include, spec.l2, spec.min_h,
                          False)
        assert len(m) == 15 and m.min() > 1e-4, m.min()
    jm, pm = run["jres"].model, run["pres"].model
    assert len(pm.trees) == len(jm.trees) == ROUNDS
    for a, b in zip(pm.trees, jm.trees):
        for f in ("feat", "feat_name", "left", "right", "slot", "sample_cnt",
                  "default_left", "split"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5,
                                   atol=1e-7)
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(run["pres"], key),
                                   _losses(run["jres"], key), rtol=1e-5)


def test_bf16_sigmoid_losses_and_auc(sigmoid_bf16_run):
    j, p = sigmoid_bf16_run["jres"], sigmoid_bf16_run["pres"]
    spec = sigmoid_bf16_run["ptr"].grow_spec
    assert spec.hist_mode == "mxu" and spec.use_bf16
    for key in ("train_loss", "test_loss"):
        np.testing.assert_allclose(_losses(p, key), _losses(j, key),
                                   rtol=1e-4)
    assert abs(p.test_metrics["auc"] - j.test_metrics["auc"]) <= 1e-4
    assert _losses(p, "train_loss")[-1] < _losses(p, "train_loss")[0]


def test_bf16_quality_close_to_int8(sigmoid_bf16_run, sigmoid_run):
    """As the JAX package holds its int8 engine against bf16
    (tests/test_gbdt_engine.py:165): test AUC within 0.01."""
    bf16 = sigmoid_bf16_run["pres"].test_metrics["auc"]
    int8 = sigmoid_run["pres"].test_metrics["auc"]
    assert abs(bf16 - int8) < 0.01 and bf16 > 0.75


def test_default_precision_is_bf16(tmp_path):
    """The JAX trainer's defaults: bf16, or f32 with use_bf16_hist=False."""
    p = GBDTParams(approximate=[ApproximateSpec()])
    assert GBDTTrainer(p, device="cpu").hist_precision == "bf16"
    tr = GBDTTrainer(p, device="cpu", use_bf16_hist=False)
    assert tr.hist_precision == "f32" and not tr.use_bf16_hist
    assert tr._grow_spec(4, 16).hist_mode == "mxu"
    assert GBDTTrainer(p, device="cpu", hist_precision="int8")._grow_spec(
        4, 16).hist_mode == "int8"
    with pytest.raises(ValueError, match="bf16|f32|int8"):
        GBDTTrainer(p, device="cpu", hist_precision="fp8")


def test_jax_predictor_scores_the_port_dump(sigmoid_run):
    """On the training rows the predictor's value compares route as the
    training bins did. A held-out row whose bin was empty for a node's
    training rows sits between the split interval's ends; the predictor
    routes it by the dumped midpoint, training by the bin (the reference
    behaves the same), so there only nearly every row must agree."""
    pred = create_predictor("gbdt", {
        "model": {"data_path": sigmoid_run["ppath"]},
        "optimization": {"loss_function": "sigmoid", "round_num": 1000},
    })
    scores, scores_t = sigmoid_run["ptr"].final_scores
    for X, s, exact in ((sigmoid_run["X"][:N_TRAIN], scores, True),
                        (sigmoid_run["X"][N_TRAIN:], scores_t, False)):
        rows = [{NAMES[f]: float(x[f]) for f in range(F)} for x in X]
        want = np.asarray(pred.batch_scores(rows))
        got = s[: len(X)].numpy()
        close = np.isclose(got, want, rtol=1e-5, atol=1e-5)
        assert close.all() if exact else close.mean() > 0.995


def test_dump_is_byte_identical_for_the_same_trees(tmp_path, l2_run):
    """The same tree arrays through each package's conversion (slot ->
    split value, missing-fill default direction) and dump give the same
    text."""
    ptr = l2_run["ptr"]
    bins = ptr._bins_sidecar[1]
    spec = ptr.grow_spec
    rng = np.random.RandomState(4)
    n = 4096
    bins_t = torch.from_numpy(
        rng.randint(0, bins.counts.min(), size=(F, n)).astype(np.uint8))
    g = torch.from_numpy(rng.randn(n).astype(np.float32))
    tr, *_ = engine.grow(dataclasses.replace(spec, B=64), bins_t,
                         torch.ones(n, dtype=torch.bool), g,
                         torch.ones(n), torch.ones(F, dtype=torch.bool))
    d = state.tree_arrays_to_numpy(tr)
    fill = rng.randn(F).astype(np.float32)
    jtr = JTrainer(JParams(approximate=[JSpec(max_cnt=63)]), engine="device",
                   hist_precision="int8")
    jtr._missing_fill = fill
    ptr._missing_fill = fill
    jb = JBins(values=bins.values, counts=bins.counts, max_bins=bins.max_bins)
    jt = jtr._arrays_to_tree(d, jb, NAMES)
    pt = ptr._arrays_to_tree(d, bins, NAMES)
    assert not all(pt.default_left[i] for i in range(pt.n_nodes())
                   if not pt.is_leaf(i))
    text = GBDTModel(base_prediction=0.25, trees=[pt, pt]).dumps()
    assert text == JModel(base_prediction=0.25, trees=[jt, jt]).dumps()
    assert GBDTModel(trees=[pt]).feature_importance() == \
        JModel(trees=[jt]).feature_importance()


def test_sidecar_and_importance_land_beside_the_model(l2_run):
    with open(l2_run["ppath"]) as f:
        text = f.read()
    with open(l2_run["ppath"] + ".bins.json") as f:
        mine = json.load(f)
    with open(l2_run["jpath"] + ".bins.json") as f:
        ref = json.load(f)
    assert mine["features"] == ref["features"]
    assert mine["model_digest"] == hashlib.sha256(text.encode()).hexdigest()
    with open(l2_run["ppath"] + ".imp") as f:
        lines = f.read().splitlines()
    assert lines[0] == "feature_name\tsum_split_count\tsum_gain"
    imp = JModel.loads(text).feature_importance()
    assert lines[1:] == [f"{k}\t{c}\t{g}" for k, (c, g) in imp.items()]


def test_wave_log_and_spec(l2_run):
    ptr = l2_run["ptr"]
    spec = ptr.grow_spec
    assert spec.ladder == (8, 32) and spec.wave == 4 and spec.fused
    wl = ptr.wave_log
    assert wl.shape == (ROUNDS, engine.wave_log_rows(spec.max_nodes), 5)
    used = wl[..., 3] > 0
    assert (wl[:, 0, 0] == 16384).all()  # rows padded to 16384
    assert (wl[used][:, 0] >= wl[used][:, 1]).all()
    assert ptr.time_stats["train"] > 0


# The trainer's refusals went as their items were ported: kw3-kw5, GOSS
# and the sample rates; kw7 and kw8, huber and softmax, train now
# (test_lifted_refusals_train_as_the_reference); kw2, kw6 and kw9, the host
# engine, precise LAD and the feature maker, train on the host engine
# (test_host_engine_refusals_train_as_the_reference); kw10, a mesh, trains
# on N ranks (tests/test_torch_mesh_gbdt.py).


_HOST_LIFTED = [
    (2, {}, {"engine": "host"}),
    (6, {"loss_function": "l1", "lad_refine_appr": False}, {}),
    (9, {"tree_maker": "feature"}, {}),
]


@pytest.mark.parametrize("kw,ctor", [c[1:] for c in _HOST_LIFTED], ids=[
    f"kw{i}-ctor{i}-1.5" for i, _, _ in _HOST_LIFTED])
def test_host_engine_refusals_train_as_the_reference(tmp_path, kw, ctor):
    """The refusals of ROADMAP.md 1.5 (the host engine, and what
    engine="auto" sends there: precise LAD and the feature maker) train the
    JAX host engine's trees on this file's data (tests/
    test_torch_host_engine.py holds the engine case by case)."""
    X, y = _data("l2")
    n = 2048
    w = np.ones(n, np.float32)
    fields = _fields("l2", round_num=2, **kw)
    fields["eval_metric"] = []
    res = {}
    for who, pcls, spec, mcls, tcls, dcls, extra in (
            ("j", JParams, JSpec, JModelParams, JTrainer, JData, {}),
            ("p", GBDTParams, ApproximateSpec, ModelParams, GBDTTrainer,
             GBDTData, {"device": "cpu"})):
        p = pcls(approximate=[spec(max_cnt=31)],
                 model=mcls(data_path=str(tmp_path / who), dump_freq=0),
                 **fields)
        tr = tcls(p, **ctor, **extra)
        assert tr.engine == "host"
        res[who] = tr.train(dcls(X[:n], y[:n], w, n, NAMES))
    assert len(res["p"].model.trees) == len(res["j"].model.trees) == 2
    for a, b in zip(res["p"].model.trees, res["j"].model.trees):
        for f in ("feat", "feat_name", "left", "right", "slot",
                  "sample_cnt", "split"):
            assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(_losses(res["p"], "train_loss"),
                               _losses(res["j"], "train_loss"), rtol=1e-5)


_LIFTED = [
    (6, {"loss_function": "l1"}),
    (7, {"loss_function": "huber", "min_child_hessian_sum": 0.0}),
    (8, {"loss_function": "softmax", "class_num": 3}),
]


@pytest.mark.parametrize("kw", [c[1] for c in _LIFTED], ids=[
    f"kw{i}-{c['loss_function']}" for i, c in _LIFTED])
def test_lifted_refusals_train_as_the_reference(tmp_path, kw):
    """The refusals this trainer lifted (l1 with the approximate LAD,
    huber, softmax) train the JAX trainer's trees on this file's data."""
    X, y = _data("l2" if kw["loss_function"] != "softmax" else "sigmoid")
    n = 2048
    if kw["loss_function"] == "softmax":
        y = np.eye(3, dtype=np.float32)[(X[:, 0] > 0).astype(int)
                                        + (X[:, 1] > 0.5)]
    w = np.ones(n, np.float32)
    fields = _fields("l2", round_num=3, **{k: v for k, v in kw.items()})
    fields["eval_metric"] = []
    jp = JParams(approximate=[JSpec(max_cnt=31)],
                 model=JModelParams(data_path=str(tmp_path / "j"),
                                    dump_freq=0), **fields)
    pp = GBDTParams(approximate=[ApproximateSpec(max_cnt=31)],
                    model=ModelParams(data_path=str(tmp_path / "p"),
                                      dump_freq=0), **fields)
    jres = JTrainer(jp, engine="device", hist_precision="int8",
                    wave=4).train(JData(X[:n], y[:n], w, n, NAMES))
    pres = GBDTTrainer(pp, device="cpu", hist_precision="int8",
                       wave=4).train(GBDTData(X[:n], y[:n], w, n, NAMES))
    K = pp.num_tree_in_group
    assert len(pres.model.trees) == len(jres.model.trees) == 3 * K
    for a, b in list(zip(pres.model.trees, jres.model.trees))[:K]:
        for f in ("feat", "feat_name", "left", "right", "slot",
                  "sample_cnt", "split"):
            assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_allclose(_losses(pres, "train_loss"),
                               _losses(jres, "train_loss"), rtol=1e-4)


def test_resume_and_efb_raise(tmp_path):
    """Resume, which used to raise, now continues a dump (2 + 1 rounds
    equal 3 uninterrupted, byte for byte); EFB, on by default, bundles two
    exclusive sparse columns and trains the trees an unbundled run grows,
    dumped in original features."""
    rng = np.random.RandomState(0)
    X = np.zeros((512, 3), np.float32)
    X[:, 0] = rng.randn(512)
    X[rng.rand(512) < 0.2, 1] = 1.0
    X[(X[:, 1] == 0) & (rng.rand(512) < 0.2), 2] = 3.0
    y = (X[:, 0] > 0).astype(np.float32) + X[:, 1] - 0.5 * X[:, 2]
    data = GBDTData(X, y, np.ones(512, np.float32), 512, ["a", "b", "c"])
    models = {}
    for efb in (None, False):
        p = GBDTParams(approximate=[ApproximateSpec()], round_num=2,
                       loss_function="l2", min_child_hessian_sum=1.0,
                       model=ModelParams(data_path=str(tmp_path / f"m{efb}")))
        tr = GBDTTrainer(p, device="cpu", hist_precision="int8", efb=efb)
        models[efb] = tr.train(data).model
        if efb is None:
            assert tr._efb_plan.bundles == [[1, 2]]
            assert tr.dev_inputs.bins_t.shape[0] == 2
            assert tr.time_stats["efb_cols_saved"] == 1.0
    assert len(models[None].trees) == 2
    for a, b in zip(models[None].trees, models[False].trees):
        for f in ("feat", "feat_name", "left", "right", "slot", "split",
                  "sample_cnt"):
            assert getattr(a, f) == getattr(b, f), f
        np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=1e-5)
    assert {"b", "c"} <= {n for t in models[None].trees for n in t.feat_name}
    texts = []
    for rounds, resume, name in ((2, False, "r"), (3, True, "r"),
                                 (3, False, "whole")):
        p = GBDTParams(approximate=[ApproximateSpec()], round_num=rounds,
                       loss_function="l2", min_child_hessian_sum=1.0,
                       model=ModelParams(data_path=str(tmp_path / name),
                                         continue_train=resume))
        GBDTTrainer(p, device="cpu", hist_precision="int8").train(data)
        texts.append((tmp_path / name).read_text())
    assert texts[1] == texts[2] != texts[0]


def test_just_evaluate_grows_nothing(tmp_path):
    X, y = _data("sigmoid")
    p = GBDTParams(approximate=[ApproximateSpec(max_cnt=15)],
                   just_evaluate=True,
                   model=ModelParams(data_path=str(tmp_path / "m")))
    res = GBDTTrainer(p, device="cpu", hist_precision="int8").train(
        GBDTData(X[:2048], y[:2048], np.ones(2048, np.float32), 2048, NAMES))
    assert res.model.trees == [] and res.round_log == []
    assert not (tmp_path / "m").exists()
    assert np.isclose(res.train_loss, np.log(2.0), rtol=1e-6)


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GBDTTrainer(GBDTParams(), hist_precision="int8")


@pytest.mark.parametrize("depth,leaves,device,past_cap", [
    (15, 0, "cuda", True),      # 65,535 nodes: past the shared lookup
    (60, 28_673, "cuda", True),  # 57,345 nodes
    (60, 28_672, "cuda", False),  # 57,343 nodes: the largest that fits
    (15, 0, "cpu", True),       # the plain versions take any tree
])
def test_trees_past_the_kernel_lookup_raise_on_cuda(depth, leaves, device,
                                                    past_cap):
    """On CUDA the spec takes a tree of any size: one whose node lookup
    does not fit K1-K4's shared memory gets the global lookup kind, and
    the planners plan it at the card's shapes. Bins past one histogram
    tile are no longer refused: the spec takes B = 2^15 and the planners
    plan it (tiles of two bin ranges)."""
    p = GBDTParams(approximate=[ApproximateSpec()], max_depth=depth,
                   max_leaf_cnt=leaves)
    tr = GBDTTrainer(p, device="cpu", hist_precision="int8")
    tr.device = torch.device(device)  # the spec reads only the device type
    spec = tr._grow_spec(28, 256)
    assert spec.max_nodes >= 57_343
    assert hist.lookup_kind(256, spec.max_nodes, spec.wave) == (
        "global" if past_cap else "shared")
    hist.q_plan(spec.wave, 28, 256, spec.max_nodes, 10_502_144, 132)
    hist.float_plan(spec.wave, 28, 256, spec.max_nodes, 10_502_144, 132)
    wide = tr._grow_spec(28, 1 << 15)
    assert wide.B == 1 << 15 and hist.bin_ranges(wide.B) == 2
    for gather in (False, True):
        hist.check_q_plan(hist.q_plan(wide.wave, 28, wide.B, wide.max_nodes,
                                      65_536, 132, gather),
                          wide.wave, 28, wide.B, wide.max_nodes, 65_536)
