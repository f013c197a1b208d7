"""continue_train in the port against the JAX package's device trainer, on
the CPU in int8: 3 rounds, then 3 more from the dump, in both packages.
Each package's resumed text equals its uninterrupted 6-round text byte
for byte (the JAX package's own pin, tests/test_resilience.py:440), and
the port's text holds the reference's trees (integer fields and split
values exact; a node value may sit an ulp or two away, as in any int8
run of the two packages: on this data 6 of the 90 node values do, 2 with
EFB). With EFB the replay walks the pre-bundle matrix and the dump names
the original features.
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.tree import GBDTModel as JModel
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu_torch.config.params import ApproximateSpec, GBDTParams, \
    ModelParams
from ytklearn_tpu_torch.gbdt.data import GBDTData
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from test_torch_gbdt_objectives import _assert_same_trees, _params


def _resume_data(sparse):
    rng = np.random.RandomState(6)
    n = 3000
    X = rng.randn(n, 4).astype(np.float32)
    if sparse:  # two mutually exclusive sparse columns: one EFB bundle
        X[:, 2:] = 0.0
        X[rng.rand(n) < 0.25, 2] = 1.0
        X[(X[:, 2] == 0) & (rng.rand(n) < 0.25), 3] = 2.0
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] - 0.4 * X[:, 3]
         + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y, np.ones(n, np.float32)


class _Res:
    def __init__(self, model):
        self.model = model


def _run(cls, tmp, path, rounds, resume, data, efb, **kw):
    names = ["a", "b", "c", "d"]
    if cls is GBDTTrainer:
        p = _params(GBDTParams, ApproximateSpec, ModelParams, str(path),
                    {"max_cnt": 32}, round_num=rounds, loss_function="l2",
                    **kw)
        p.model.continue_train = resume
        return cls(p, device="cpu", hist_precision="int8", wave=4,
                   efb=efb).train(GBDTData(*data, len(data[0]), names))
    p = _params(JParams, JSpec, JModelParams, str(path), {"max_cnt": 32},
                round_num=rounds, loss_function="l2", **kw)
    p.model.continue_train = resume
    return cls(p, engine="device", hist_precision="int8", wave=4,
               efb=efb).train(JData(*data, len(data[0]), names))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "efb"])
def test_continue_train_matches_reference(tmp_path, sparse):
    data = _resume_data(sparse)
    texts = {}
    for who, cls in (("jax", JTrainer), ("port", GBDTTrainer)):
        path = tmp_path / f"{who}.model"
        first = _run(cls, tmp_path, path, 3, False, data, None)
        assert len(first.model.trees) == 3
        res = _run(cls, tmp_path, path, 6, True, data, None)
        assert len(res.model.trees) == 6
        assert [r["round"] for r in res.round_log] == [3, 4, 5]
        texts[who] = path.read_text()
        whole = _run(cls, tmp_path, tmp_path / f"{who}_whole.model", 6,
                     False, data, None)
        texts[who + "_whole"] = (tmp_path / f"{who}_whole.model").read_text()
        assert res.train_loss == pytest.approx(whole.train_loss, rel=1e-6)
    # each package's resumed text is its uninterrupted text, byte for byte
    assert texts["jax_whole"] == texts["jax"]
    assert texts["port_whole"] == texts["port"]
    # and the two packages' texts agree as their uninterrupted runs do:
    # the same trees, node values within the fused program's f32 order
    pm, jm = JModel.loads(texts["port"]), JModel.loads(texts["jax"])
    assert pm.base_prediction == jm.base_prediction
    _assert_same_trees(_Res(pm), _Res(jm))
    if sparse:  # the dump names original features, a bundled one among them
        used = {n for t in res.model.trees for n in t.feat_name} - {""}
        assert "d" in used and used <= {"a", "b", "c", "d"}


def test_continue_train_replays_on_the_pre_bundle_matrix(tmp_path):
    """With EFB the resumed trees route on original columns: the replay
    uses the unbundled bins, and they are freed after it."""
    data = _resume_data(True)
    path = tmp_path / "m.model"
    _run(GBDTTrainer, tmp_path, path, 2, False, data, None)
    p = _params(GBDTParams, ApproximateSpec, ModelParams, str(path),
                {"max_cnt": 32}, round_num=3, loss_function="l2")
    p.model.continue_train = True
    tr = GBDTTrainer(p, device="cpu", hist_precision="int8", wave=4)
    seen = []
    real = tr._tree_scores_from_raw

    def spy(tree, bins, bins_t):
        seen.append(bins_t.shape[0])
        return real(tree, bins, bins_t)

    tr._tree_scores_from_raw = spy
    tr.train(GBDTData(*data, len(data[0]), ["a", "b", "c", "d"]))
    assert tr._efb_plan is not None and tr.dev_inputs.bins_t.shape[0] == 3
    assert seen == [4, 4]  # two trees, each on the 4 original columns
    assert tr.dev_inputs.replay_bins is None


def test_continue_train_unknown_feature_raises(tmp_path):
    data = _resume_data(False)
    path = tmp_path / "m.model"
    _run(GBDTTrainer, tmp_path, path, 2, False, data, None)
    p = _params(GBDTParams, ApproximateSpec, ModelParams, str(path),
                {"max_cnt": 32}, round_num=3, loss_function="l2")
    p.model.continue_train = True
    with pytest.raises(ValueError, match="not in this run's feature set"):
        GBDTTrainer(p, device="cpu", hist_precision="int8").train(
            GBDTData(*data, len(data[0]), ["a", "b", "c", "zz"]))


def test_continue_train_without_a_dump_starts_fresh(tmp_path):
    data = _resume_data(False)
    p = _params(GBDTParams, ApproximateSpec, ModelParams,
                str(tmp_path / "none.model"), {"max_cnt": 32}, round_num=2,
                loss_function="l2")
    p.model.continue_train = True
    res = GBDTTrainer(p, device="cpu", hist_precision="int8").train(
        GBDTData(*data, len(data[0]), ["a", "b", "c", "d"]))
    assert len(res.model.trees) == 2


def _ulps(pt: str, jt: str):
    """{(tree, node): f32 ulps apart} of the node values (leaf, gain and
    hessian) where the two model texts differ; their integer fields and
    split values must be equal."""
    out = {}
    pm, jm = JModel.loads(pt), JModel.loads(jt)
    assert len(pm.trees) == len(jm.trees)
    for t, (a, b) in enumerate(zip(pm.trees, jm.trees)):
        assert (a.feat_name, a.left, a.split, a.sample_cnt) == \
            (b.feat_name, b.left, b.split, b.sample_cnt)
        for f in ("leaf_value", "gain", "hess_sum"):
            x = np.asarray(getattr(a, f), np.float32).view(np.int32)
            y = np.asarray(getattr(b, f), np.float32).view(np.int32)
            for nid in np.nonzero(x != y)[0]:
                out[(t, f, int(nid))] = abs(int(x[nid]) - int(y[nid]))
    return out


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "efb"])
def test_resume_divergence_is_the_uninterrupted_runs(tmp_path, sparse):
    """The int8 resumed text sits a few f32 ulps from the reference's in
    some node values. The port's uninterrupted text differs from the
    reference's uninterrupted text in exactly the same node values, by the
    same ulps: the resume adds nothing of its own, the divergence is the
    int8 split statistics' f32 order (ROADMAP.md §3, allowed)."""
    data = _resume_data(sparse)
    texts = {}
    for who, cls in (("jax", JTrainer), ("port", GBDTTrainer)):
        path = tmp_path / f"{who}.model"
        _run(cls, tmp_path, path, 3, False, data, None)
        _run(cls, tmp_path, path, 6, True, data, None)
        texts[who] = path.read_text()
        whole = tmp_path / f"{who}_whole.model"
        _run(cls, tmp_path, whole, 6, False, data, None)
        texts[who + "_whole"] = whole.read_text()
        # each package's resumed text is its own uninterrupted text
        assert texts[who] == texts[who + "_whole"]
    resumed = _ulps(texts["port"], texts["jax"])
    whole = _ulps(texts["port_whole"], texts["jax_whole"])
    assert resumed == whole
