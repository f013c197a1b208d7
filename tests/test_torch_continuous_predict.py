"""The port's convex predictors (ytklearn_tpu_torch/predict/continuous.py)
against the JAX package's, on model texts dumped by both packages from the
same weights.

Each family is ingested with a config that turns on what the predictors
replay: the transform sidecar (standardization; linear and multiclass),
feature hashing (FM), FFM's field dict; each package ingests (writing its
sidecar) and dumps the same seeded weights (the sidecar stamped with the
model's digest). The port's predictor on either dump and the JAX
predictor on its own then score the test file's rows: raw scores and
predictions at rtol 1e-6 (both float64 on the host), the linear Thompson
sample from one seeded RandomState each at rtol 1e-6, multiclass softmax
and hsoftmax predictions and softmax losses at rtol 1e-6. The JAX ingest
takes its Python path (`DataIngest._load_python`), whose transform stats
the port equals. A sidecar whose digest names another model text is
refused. The port's ingest takes its Python path too: its `load` parses
natively, in float32, whose transform stats differ from the Python path's
in the last digits (tests/test_torch_native_ingest.py holds the native
paths together).
"""

import copy

import numpy as np
import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.io.fs import LocalFileSystem as JFS
from ytklearn_tpu.io.reader import DataIngest as JIngest
from ytklearn_tpu.models import ffm as jffm, fm as jfm, linear as jlin, \
    multiclass as jmc
from ytklearn_tpu.predict import create_predictor as jcreate
from ytklearn_tpu_torch.io.reader import parse_line
from ytklearn_tpu_torch.predict import create_predictor
from ytklearn_tpu_torch.config.params import CommonParams as PParams, \
    DelimParams
from ytklearn_tpu_torch.io.fs import LocalFileSystem as PFS
from ytklearn_tpu_torch.io.reader import DataIngest as PIngest
from ytklearn_tpu_torch.models import FFMModel, FMModel, LinearModel, \
    MulticlassLinearModel, load_field_dict
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case

RTOL = 1e-6
CASES = [
    ("linear", "linear", {"feature": {"transform": {"switch_on": True}}}),
    ("multiclass_linear", "multiclass_linear",
     {"feature": {"transform": {"switch_on": True,
                                "mode": "scale_range"}}}),
    ("hsoftmax", "multiclass_linear",
     {"k": 4, "loss": {"loss_function": "hsoftmax"}}),
    ("fm", "fm", {"feature": {"feature_hash": {"need_feature_hash": True,
                                               "bucket_size": 50}}}),
    ("ffm", "ffm", {"bias_need_latent_factor": True}),
]


def _merge(a, b):
    for k, v in b.items():
        if isinstance(v, dict):
            _merge(a.setdefault(k, {}), v)
        else:
            a[k] = v
    return a


def _model(family, pkg, p, dim, n_fields):
    if family == "linear":
        return (jlin.LinearModel if pkg == "jax" else LinearModel)(
            p, dim, **({} if pkg == "jax" else {"device": "cpu"}))
    if family == "multiclass_linear":
        return (jmc.MulticlassLinearModel if pkg == "jax"
                else MulticlassLinearModel)(
            p, dim, **({} if pkg == "jax" else {"device": "cpu"}))
    if family == "fm":
        return jfm.FMModel(p, dim) if pkg == "jax" else \
            FMModel(p, dim, device="cpu")
    return jffm.FFMModel(p, dim, n_fields) if pkg == "jax" else \
        FFMModel(p, dim, n_fields, device="cpu")


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    out = {}
    for name, family, extra in CASES:
        tmp = tmp_path_factory.mktemp(name)
        cfg = write_convex_case(str(tmp), family, 300, 60, 13, vocab=80,
                                nnz=6, K=4, n_fields=5, k=3)
        _merge(cfg, copy.deepcopy(extra))
        fields = (load_field_dict(PFS(), cfg["model"]["field_dict_path"])
                  if family == "ffm" else None)
        cfgs = {}
        w = None
        for pkg, Params, Ingest, fs in (("jax", JParams, JIngest, JFS()),
                                        ("port", PParams, PIngest, PFS())):
            c = copy.deepcopy(cfg)
            c["model"]["data_path"] = str(tmp / pkg / "model")
            p = Params.from_config(c)
            kw = {"n_labels": int(p.k)} if family == "multiclass_linear" \
                else {}
            if fields is not None:
                kw["field_map"] = fields
            ing = Ingest(p, **kw)
            # both Python paths: the port's equals the JAX package's
            ing = ing._load_python()
            m = _model(family, pkg, p, ing.train.dim, len(fields or {}))
            if w is None:
                rng = np.random.RandomState(4)
                w = (rng.randn(m.dim) * 0.4).astype(np.float32)
                w[rng.rand(m.dim) < 0.1] = 0.0
                prec = rng.rand(m.dim).astype(np.float32) + 0.5
            m.dump_model(fs, w, prec if family == "linear" else None,
                         ing.feature_map)
            cfgs[pkg] = c
        with open(cfg["data"]["test"]["data_path"]) as f:
            rows = [dict(parse_line(line, DelimParams()).feats)
                    for line in f if line.strip()]
        rows.append({"unknown": 3.0, "_bias_": 9.0})
        out[name] = dict(cfgs=cfgs, rows=rows, family=family)
    return out


def _want(c, what):
    jp = jcreate(c["family"], c["cfgs"]["jax"])
    return np.asarray([getattr(jp, what)(r) for r in c["rows"]], np.float64)


@pytest.mark.parametrize("dump", ["jax", "port"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_predictions_match_jax(name, dump, cases):
    c = cases[name]
    pp = create_predictor(c["family"], c["cfgs"][dump])
    multi = c["family"] == "multiclass_linear"
    for what in (("scores", "predicts") if multi else ("score", "predict")):
        got = np.asarray([getattr(pp, what)(r) for r in c["rows"]],
                         np.float64)
        np.testing.assert_allclose(got, _want(c, what), rtol=RTOL,
                                   atol=1e-12)
    got = pp.batch_predicts(c["rows"])
    np.testing.assert_allclose(got, _want(c, "predicts" if multi
                                          else "predict"), rtol=RTOL,
                               atol=1e-12)


def test_thompson_sampling_from_a_seeded_generator(cases):
    c = cases["linear"]
    jp = jcreate("linear", c["cfgs"]["jax"])
    jp.rng = np.random.RandomState(77)
    pp = create_predictor("linear", c["cfgs"]["jax"])
    pp.rng = np.random.RandomState(77)
    want = [jp.thompson_sampling_predict(r, 0.5) for r in c["rows"]]
    got = [pp.thompson_sampling_predict(r, 0.5) for r in c["rows"]]
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert len(set(np.round(got, 9))) > 1


def test_multiclass_loss_value(cases):
    c = cases["multiclass_linear"]
    jp = jcreate("multiclass_linear", c["cfgs"]["jax"])
    pp = create_predictor("multiclass_linear", c["cfgs"]["port"])
    K = pp.K
    for i, r in enumerate(c["rows"][:20]):
        label = np.eye(K)[i % K]
        np.testing.assert_allclose(pp.loss_value(r, label),
                                   jp.loss_value(r, label), rtol=RTOL)


def test_stale_sidecar_digest_is_refused(cases, tmp_path):
    import shutil

    src = cases["linear"]["cfgs"]["port"]["model"]["data_path"]
    dst = str(tmp_path / "model")
    shutil.copytree(src, dst)
    shutil.copy(src + "_feature_transform_stat",
                dst + "_feature_transform_stat")
    with open(dst + "/model-00000", "a") as f:
        f.write("extra,1.0,1.0\n")
    cfg = copy.deepcopy(cases["linear"]["cfgs"]["port"])
    cfg["model"]["data_path"] = dst
    with pytest.raises(ValueError, match="digest mismatch"):
        create_predictor("linear", cfg)


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_scorer_featurize_is_prep_row_on_hashed_and_transformed_models(
        name, cases):
    """The serving rung's batched featurize (bias drop, murmur hashing with
    signed collisions summed, the transform replay, the bias column) holds
    each row's prep_row items at their vocab columns, exactly; its f64
    scores equal the host predictor's and the JAX CompiledScorer's at
    rtol 1e-10, atol 1e-12 (tests/test_serve_scorer.py's bounds)."""
    from ytklearn_tpu.serve import CompiledScorer as JaxScorer
    from ytklearn_tpu_torch.serve import CompiledScorer

    c = cases[name]
    pp = create_predictor(c["family"], c["cfgs"]["port"])
    scorer = CompiledScorer(pp, ladder=(1, 8, 64), precision="f64",
                            device="cpu")
    rows = c["rows"]
    X = scorer.featurize(rows)
    for i, r in enumerate(rows):
        want = np.zeros(scorer.dim)
        for n, v in pp._prep(r):
            if n in scorer.vocab:
                want[scorer.vocab[n]] += v
        if scorer._bias_col is not None:
            want[scorer._bias_col] = 1.0
        np.testing.assert_array_equal(X[i], want)
    s = scorer.score_batch(rows)
    np.testing.assert_allclose(s, pp.batch_scores(rows), rtol=1e-10,
                               atol=1e-12)
    jp = jcreate(c["family"], c["cfgs"]["port"])
    np.testing.assert_allclose(
        s, JaxScorer(jp, ladder=(1, 8, 64), precision="f64").score_batch(
            rows), rtol=1e-10, atol=1e-12)
