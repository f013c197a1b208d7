"""The engine scripts' trainers against the JAX package's trainer on the
same numpy arrays, on the CPU at a tiny size (the JAX trainer on its CPU
path).

profile_gbdt's and profile_engine's data are the reference scripts' own
numpy draws, so both trainers see the same arrays; ablate_engine's data
(the reference draws it with jax.random) comes from the port's seeded
numpy helper, handed to both. Each run's train loss, test loss and test
AUC agree within the ROADMAP's band for whole float runs (1e-4; rtol for
losses, absolute for AUC).
"""

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import ApproximateSpec as JSpec
from ytklearn_tpu.config.params import GBDTParams as JParams
from ytklearn_tpu.config.params import ModelParams as JModelParams
from ytklearn_tpu.gbdt.data import GBDTData as JData
from ytklearn_tpu.gbdt.trainer import GBDTTrainer as JTrainer
from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer
from ytklearn_tpu_torch.scripts import ablate_engine, profile_engine, \
    profile_gbdt

FIELDS = ("round_num", "max_depth", "max_leaf_cnt", "tree_grow_policy",
          "learning_rate", "min_child_hessian_sum", "loss_function",
          "eval_metric", "watch_train", "watch_test")
BAND = 1e-4


def _jax_params(pp, path):
    """The JAX package's GBDTParams with the port params' values."""
    return JParams(
        approximate=[JSpec(type=a.type, max_cnt=a.max_cnt)
                     for a in pp.approximate],
        model=JModelParams(data_path=path, dump_freq=0),
        **{k: getattr(pp, k) for k in FIELDS})


def _jdata(d):
    return JData(d.X, d.y, d.weight, d.n_real, d.feature_names)


def _agree(pres, jres, auc=False):
    np.testing.assert_allclose(pres.train_loss, jres.train_loss, rtol=BAND)
    if jres.test_loss is not None:
        np.testing.assert_allclose(pres.test_loss, jres.test_loss,
                                   rtol=BAND)
    if auc:
        assert abs(pres.test_metrics["auc"] - jres.test_metrics["auc"]) \
            <= BAND
    assert len(pres.model.trees) == len(jres.model.trees)


@pytest.mark.parametrize("policy", ["loss", "level"])
def test_profile_gbdt_trainer_matches_jax(tmp_path, policy):
    data = profile_gbdt.make_data(3000)
    pp = profile_gbdt.make_params(2, policy, str(tmp_path / "p"))
    pres = GBDTTrainer(pp, device="cpu").train(train=data, test=None)
    jres = JTrainer(_jax_params(pp, str(tmp_path / "j"))).train(
        train=_jdata(data), test=None)
    _agree(pres, jres)


def test_profile_engine_trainer_matches_jax(tmp_path):
    train = profile_engine.make_data(3000, 0)
    test = profile_engine.make_data(10000, 1)
    pp = profile_engine.make_params(2, "loss", 15, str(tmp_path / "p"))
    pres = GBDTTrainer(pp, device="cpu", engine="device", wave=8,
                       hist_precision="int8").train(train=train, test=test)
    jres = JTrainer(_jax_params(pp, str(tmp_path / "j")), engine="device",
                    wave=8, hist_precision="int8").train(
        train=_jdata(train), test=_jdata(test))
    _agree(pres, jres, auc=True)


@pytest.mark.parametrize("cfg", ["b256", "efb"])
def test_ablate_arm_matches_jax(tmp_path, cfg, monkeypatch):
    """An arm's trainer (its knobs set as the script sets them) against
    the JAX trainer under the same knobs, on the port's numpy data."""
    train, test = ablate_engine.make_data(3000)
    assert train.X.shape == (3000, 36) and test.X.shape == (1024, 36)
    excl = train.X[:, 28:]
    assert ((excl > 0).sum(axis=1) == 1).all() and excl.min() == 0.0
    for k in ablate_engine._AB_VARS:
        monkeypatch.delenv(k, raising=False)
    ablate_engine.apply_env(cfg)
    pp = ablate_engine.make_params(cfg, 2, str(tmp_path / "p"))
    ptr = GBDTTrainer(pp, device="cpu", engine="device",
                      wave=ablate_engine.wave_of(cfg))
    pres = ptr.train(train=train, test=test)
    jtr = JTrainer(_jax_params(pp, str(tmp_path / "j")), engine="device",
                   wave=ablate_engine.wave_of(cfg))
    jres = jtr.train(train=_jdata(train), test=_jdata(test))
    for k in ablate_engine._AB_VARS:
        monkeypatch.delenv(k, raising=False)
    _agree(pres, jres, auc=True)
    assert (ptr._efb_plan is None) == (cfg != "efb")
    if cfg == "efb":
        assert ptr._efb_plan.summary() == jtr._efb_plan.summary()
