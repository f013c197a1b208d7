"""The port's convex models (ytklearn_tpu_torch/models/) against the JAX
package's on the same ingest and the same weights.

Each family (linear dense and sparse, multiclass linear dense and sparse
with softmax and a margin loss, FM and FFM with their first-order and
bias-latent switches) is built on a seeded synthetic ingest; the JAX
model's weights (its `init_weights`, perturbed by a seeded draw) reach the
port through `carry_weights`. Tolerances: scores, the weighted-sum loss
and its gradient at rtol 1e-5 (atol 1e-5 of the largest |value|: float32
sums in another order); the port's chunked evaluation equal to its
unchunked one at the same tolerance; the linear Laplace precision at rtol
1e-5. Exact: `init_weights` and `reg_vectors`, the text dumps of the same
weights (byte-identical), and the weights each package loads from either
package's dump (bit-equal).
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.models import ffm as jffm, fm as jfm, linear as jlin, \
    multiclass as jmc
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.io.fs import LocalFileSystem as PFS
from ytklearn_tpu_torch.io.reader import DataIngest
from ytklearn_tpu_torch.models import FFMModel, FMModel, LinearModel, \
    MulticlassLinearModel, carry_weights, load_field_dict
from ytklearn_tpu_torch.optimize.blocked import chunked_sum, \
    chunked_value_and_grad, make_rows, suggest_chunk, value_and_grad
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

RTOL = 1e-5

# (case, family, extra config, model kwargs)
CASES = [
    ("linear_dense", "linear", {}, {"dense": True}),
    ("linear_sparse", "linear", {"model": {"need_bias": False}},
     {"dense": False}),
    ("mc_dense", "multiclass_linear", {}, {"dense": True}),
    ("mc_sparse_hinge", "multiclass_linear",
     {"loss": {"loss_function": "multiclass_smooth_hinge"}},
     {"dense": False}),
    ("fm", "fm", {}, {}),
    ("fm_no_first", "fm", {"k": [0, 3]}, {}),
    ("fm_bias_latent", "fm", {"bias_need_latent_factor": True}, {}),
    ("ffm", "ffm", {}, {}),
    ("ffm_no_first", "ffm", {"k": [0, 2], "bias_need_latent_factor": True},
     {}),
]


def _merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict):
            _merge(a.setdefault(k, {}), v)
        else:
            a[k] = v
    return a


def _models(family, jp, pp, dim, n_fields, kw):
    if family == "linear":
        return (jlin.LinearModel(jp, dim, **kw),
                LinearModel(pp, dim, device="cpu", **kw))
    if family == "multiclass_linear":
        return (jmc.MulticlassLinearModel(jp, dim, **kw),
                MulticlassLinearModel(pp, dim, device="cpu", **kw))
    if family == "fm":
        return jfm.FMModel(jp, dim), FMModel(pp, dim, device="cpu")
    return (jffm.FFMModel(jp, dim, n_fields),
            FFMModel(pp, dim, n_fields, device="cpu"))


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = {}
    for name, family, extra, kw in CASES:
        d = str(tmp_path_factory.mktemp(name))
        cfg = write_convex_case(d, family, 500, 100, 5, vocab=96, nnz=6,
                                K=4, n_fields=5, k=3)
        _merge(cfg, copy.deepcopy(extra))
        pp = PParams.from_config(cfg)
        fields = (load_field_dict(PFS(), pp.model.field_dict_path)
                  if family == "ffm" else None)
        ing = DataIngest(pp, n_labels=int(pp.k) if family ==
                         "multiclass_linear" else 1, field_map=fields).load()
        jp = JParams.from_config(cfg)
        jm, pm = _models(family, jp, pp, ing.train.dim,
                         len(fields or {}), kw)
        rng = np.random.RandomState(1)
        w = (jm.init_weights()
             + rng.randn(jm.dim).astype(np.float32) * 0.3).astype(np.float32)
        jb = jm.make_batch(ing.train)
        with jax.enable_x64(False):
            jw = jnp.asarray(w)
            jbd = tuple(jnp.asarray(a) for a in jb)
            *xargs, _, _ = jbd
            jscores = np.asarray(jm.scores(jw, *xargs))
            jl, jg = jax.value_and_grad(jm.pure_loss)(jw, *jbd)
            jprec = None
            if family == "linear":
                l2v = jm.reg_vectors(0.0, 0.25)[1]
                jprec = np.asarray(jm.precision(jw, *jbd, l2_vec=l2v,
                                                g_weight=3.0))
            jreg = [np.asarray(v) for v in jm.reg_vectors(*_reg(jm))]
        out[name] = dict(cfg=cfg, dir=d, family=family, ing=ing, jm=jm,
                         pm=pm, w=w, jscores=jscores, jloss=float(jl),
                         jgrad=np.asarray(jg), jprec=jprec, jreg=jreg)
    return out


def _reg(model):
    """Per-block l1 and l2 lists."""
    nb = len(model.regular_blocks())
    return [0.1, 0.2][:nb], [0.3, 0.4][:nb]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


def _port(c):
    pm = c["pm"]
    return pm, carry_weights(c["w"], pm), pm.device_batch(c["ing"].train)


NAMES = [c[0] for c in CASES]


@pytest.mark.parametrize("name", NAMES)
def test_init_and_reg_vectors_exact(name, cases):
    c = cases[name]
    assert np.array_equal(c["jm"].init_weights(), c["pm"].init_weights())
    assert c["jm"].dim == c["pm"].dim
    for j, p in zip(c["jreg"], c["pm"].reg_vectors(*_reg(c["pm"]))):
        assert np.array_equal(j, p.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_scores_loss_and_grad_match_jax(name, cases):
    c = cases[name]
    pm, w, batch = _port(c)
    *xargs, _, _ = batch
    _close(pm.scores(w, *xargs).numpy(), c["jscores"])
    loss, grad = value_and_grad(pm.pure_loss)(w, *batch)
    _close(float(loss), c["jloss"])
    _close(grad.numpy(), c["jgrad"])
    if c["jprec"] is not None:
        l2v = pm.reg_vectors(0.0, 0.25)[1]
        _close(pm.precision(w, *batch, l2_vec=l2v, g_weight=3.0).numpy(),
               c["jprec"])


@pytest.mark.parametrize("chunk", [64, 77])
@pytest.mark.parametrize("name", NAMES)
def test_chunked_equals_unchunked(name, chunk, cases):
    pm, w, batch = _port(cases[name])
    loss, grad = value_and_grad(pm.pure_loss)(w, *batch)
    closs, cgrad = chunked_value_and_grad(pm.pure_loss, chunk)(w, *batch)
    _close(float(closs), float(loss))
    _close(cgrad.numpy(), grad.numpy())
    _close(float(chunked_sum(pm.pure_loss, chunk)(w, *batch)), float(loss))
    _close(make_rows(pm.predicts, chunk)(w, *batch).numpy(),
           make_rows(pm.predicts)(w, *batch).numpy())


def _dump(model, fs, w, data_path, ing):
    model.params.model.data_path = data_path
    prec = None
    if isinstance(model, (LinearModel, jlin.LinearModel)):
        prec = np.linspace(0.5, 2.0, len(w)).astype(np.float32)
    model.dump_model(fs, w, prec, ing.feature_map)
    with open(f"{data_path}/model-00000") as f:
        text = f.read()
    with open(f"{data_path}_dict/dict-00000") as f:
        return text, f.read()


@pytest.mark.parametrize("name", NAMES)
def test_dumps_byte_identical_and_load_both_ways(name, cases):
    c = cases[name]
    jm, pm, w, ing = c["jm"], c["pm"], c["w"], c["ing"]
    w = w.copy()
    w[3] = 0.0  # a zero weight: the linear dump skips it
    jpath, ppath = os.path.join(c["dir"], "jdump"), \
        os.path.join(c["dir"], "pdump")
    jt = _dump(jm, JFS(), w, jpath, ing)
    pt = _dump(pm, PFS(), w, ppath, ing)
    assert jt == pt
    loaded = []
    for path in (jpath, ppath):
        jm.params.model.data_path = path
        pm.params.model.data_path = path
        loaded.append(jm.load_model(JFS(), ing.feature_map))
        loaded.append(pm.load_model(PFS(), ing.feature_map))
    for a in loaded[1:]:
        assert a.dtype == np.float32 and np.array_equal(a, loaded[0])


def test_carry_weights_checks_the_layout(cases):
    c = cases["ffm"]
    pm = c["pm"]
    with pytest.raises(ValueError, match="layout needs"):
        carry_weights(c["w"][:-1], pm)
    with pytest.raises(ValueError, match="layout needs"):
        carry_weights(c["w"].astype(np.float64), pm)
    t = carry_weights(c["w"], pm)
    assert t.device.type == "cpu" and np.array_equal(t.numpy(), c["w"])
    parts = [p[0] for p in pm.layout()]
    assert parts == ["w1", "V"] and pm.layout()[1][3] == (
        pm.n_features, pm.n_fields, pm.sok)


def test_models_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FMModel(PParams(k=[1, 2]), 10)


@pytest.mark.parametrize("n,bpr,env,want", [
    (4096, 10 ** 9, None, None),  # small batches never chunk
    (100_000, 100, None, None),  # fits the budget
    (2_000_000, 4 * 8 * 39 * 4, None, 131072),  # bench_fm's cell
    (100_000, 10 ** 6, None, 4096),  # at least min_chunk
    (100_000, 1, "1000", 1000),  # YTK_ROW_CHUNK wins
    (500, 1, "1000", None),
])
def test_suggest_chunk(n, bpr, env, want, monkeypatch):
    if env is None:
        monkeypatch.delenv("YTK_ROW_CHUNK", raising=False)
    else:
        monkeypatch.setenv("YTK_ROW_CHUNK", env)
    monkeypatch.delenv("YTK_CHUNK_BUDGET_MB", raising=False)
    assert suggest_chunk(n, bpr) == want


@pytest.mark.parametrize("metric,K", [
    ("auc", 2), ("auc", 4), ("auc@1000", 2), ("rmse", 2), ("mae", 2),
    ("mape", 2), ("smape", 2), ("confusion_matrix", 2),
    ("confusion_matrix@0.3", 2), ("confusion_matrix", 4)])
def test_eval_metrics_match_jax(metric, K):
    """EvalSet of the port against the JAX package's on the same float32
    predictions: rtol 1e-6 (float32 sums)."""
    from ytklearn_tpu.eval import EvalSet as JEval
    from ytklearn_tpu_torch.eval import EvalSet as PEval

    rng = np.random.RandomState(K)
    n = 500
    w = np.where(rng.rand(n) < 0.2, 0.0, rng.rand(n) + 0.5).astype(
        np.float32)
    if K > 2:
        pred = rng.dirichlet(np.ones(K), n).astype(np.float32)
        y = np.eye(K, dtype=np.float32)[rng.randint(0, K, n)]
    else:
        pred = rng.rand(n).astype(np.float32)
        y = (rng.rand(n) < pred).astype(np.float32)
        if metric in ("mape", "smape", "rmse", "mae"):
            y = (rng.rand(n) + 0.5).astype(np.float32)
    with jax.enable_x64(False):
        want = JEval([metric], K=K).evaluate(jnp.asarray(pred),
                                             jnp.asarray(y), jnp.asarray(w))
    got = PEval([metric], K=K).evaluate(torch.from_numpy(pred),
                                        torch.from_numpy(y),
                                        torch.from_numpy(w))
    np.testing.assert_allclose(got[metric], want[metric], rtol=1e-6)
