"""The convex families' predictors: linear, multiclass linear, FM, FFM
(``ytklearn_tpu/predict/continuous.py``; reference
predictor/ContinuousOnlinePredictor.java:54, LinearOnlinePredictor.java
:55-165, MulticlassLinearOnlinePredictor, FMOnlinePredictor.java:110-160,
FFMOnlinePredictor).

Each loads the model text and the training config, replays the transform
sidecar and the feature hashing through the shared pipeline, and scores a
feature dict on the host in float64.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config.params import CommonParams
from ..io.feature_hash import FeatureHash
from ..io.fs import is_tmp_path
from ..io.reader import TransformNode
from ..losses import create_loss
from ..models.ffm import load_field_dict
from ..transform.pipeline import TransformPipeline
from ..transform.sidecar import read_sidecar, verify_sidecar_digest
from .base import OnlinePredictor

PRECISION_MIN = 1e-9  # reference: LinearOnlinePredictor.java:38


class ContinuousPredictor(OnlinePredictor):
    """What the convex predictors share (reference:
    ContinuousOnlinePredictor.java:54-145)."""

    def __init__(self, config, fs=None):
        super().__init__(config, fs)
        self.params = CommonParams.from_config(self.config)
        p = self.params
        self.loss = create_loss(p.loss.loss_function)
        fh = p.feature.feature_hash
        self.feature_hash = (FeatureHash(fh.bucket_size, fh.seed,
                                         fh.feature_prefix)
                             if fh.need_feature_hash else None)
        self.transform_nodes: Dict[str, TransformNode] = {}
        if p.feature.transform.switch_on:
            nodes, digest = read_sidecar(
                self.fs, p.model.data_path + "_feature_transform_stat")
            # a digest naming another model text is the crash-between-
            # writes window: refuse to replay stale stats
            verify_sidecar_digest(self.fs, p.model.data_path, digest)
            self.transform_nodes = nodes
        self.pipeline = TransformPipeline(
            bias_name=p.model.bias_feature_name,
            feature_hash=self.feature_hash, nodes=self.transform_nodes,
            transform_on=p.feature.transform.switch_on)
        self._load_model()

    def _transform(self, name: str, val: float) -> float:
        """One feature's replay (reference:
        ContinuousOnlinePredictor.transform:135-143): with the transform
        on, a feature without a stat node maps to 0."""
        return self.pipeline.transform_scalar(name, val)

    def _prep(self, features: Dict[str, float]) -> List[Tuple[str, float]]:
        """Bias removal, hashing and the transform replay."""
        return self.pipeline.prep_row(features)

    def _model_lines(self, path: str):
        """delim-split nonempty lines of every model part file."""
        d = self.params.model.delim
        for part in sorted(self.fs.recur_get_paths([path])):
            if is_tmp_path(part):
                continue  # an atomic writer's temp file
            with self.fs.open(part) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    info = line.split(d)
                    if len(info) >= 2:
                        yield info

    def _model_path(self, what: str) -> str:
        path = self.params.model.data_path
        if not self.fs.exists(path):
            raise FileNotFoundError(f"{what} doesn't exist: {path}")
        return path

    def _load_model(self) -> None:
        raise NotImplementedError


class LinearPredictor(ContinuousPredictor):
    """score = sum w x + bias; Thompson sampling from the Laplace precision
    column (reference: LinearOnlinePredictor.java). `rng` draws the
    samples: a seeded numpy RandomState, RandomState(0) when None."""

    def __init__(self, config, fs=None,
                 rng: Optional[np.random.RandomState] = None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        super().__init__(config, fs)

    def _load_model(self) -> None:
        p = self.params.model
        self.model_map: Dict[str, Tuple[float, float]] = {}
        for info in self._model_lines(self._model_path("linear model")):
            name = info[0].strip()
            wei = float(info[1])
            if name == p.bias_feature_name:
                std = math.sqrt(1.0 / 1e30)
            else:
                try:
                    precision = max(float(info[2]), PRECISION_MIN)
                except (IndexError, ValueError):
                    precision = 1e30
                std = math.sqrt(1.0 / precision)
            self.model_map[name] = (wei, std)

    def _bias(self) -> float:
        p = self.params.model
        if p.need_bias:
            param = self.model_map.get(p.bias_feature_name)
            if param is not None:
                return param[0]
        return 0.0

    def score(self, features, other=None) -> float:
        s = 0.0
        for name, val in self._prep(features):
            param = self.model_map.get(name)
            if param is not None:
                s += param[0] * val
        return s + self._bias()

    def thompson_sampling_predict(self, features, alpha: float) -> float:
        """Exploration from the Laplace posterior, w ~ N(w, alpha^2 std^2)
        (reference: LinearOnlinePredictor.thompsonSamplingPredict:141-163)."""
        s = 0.0
        for name, val in self._prep(features):
            param = self.model_map.get(name)
            if param is not None:
                w, std = param
                s += (w + self.rng.randn() * alpha * std) * val
        return float(self._activation(s + self._bias()))


class MulticlassLinearPredictor(ContinuousPredictor):
    """K-1 scores and the K-th at 0 (reference:
    MulticlassLinearOnlinePredictor; lines `name,w_0,...,w_{K-2}`)."""

    def _load_model(self) -> None:
        self.K = int(self.params.k)
        self.n_outputs = self.K
        self.model_map: Dict[str, np.ndarray] = {}
        for info in self._model_lines(self._model_path("model")):
            self.model_map[info[0].strip()] = np.asarray(
                [float(v) for v in info[1:self.K]], np.float64)

    def scores(self, features, other=None) -> List[float]:
        p = self.params.model
        s = np.zeros(self.K - 1, np.float64)
        for name, val in self._prep(features):
            w = self.model_map.get(name)
            if w is not None:
                s += w * val
        if p.need_bias:
            w = self.model_map.get(p.bias_feature_name)
            if w is not None:
                s += w
        return list(s) + [0.0]

    def score(self, features, other=None) -> float:
        raise ValueError("multiclass_linear is multi-output; use scores()")

    def predict(self, features, other=None) -> float:
        raise ValueError("multiclass_linear is multi-output; use predicts()")


class FMPredictor(ContinuousPredictor):
    """wx + 0.5 sum_k [(sum v x)^2 - sum (v x)^2]; the bias adds its weight
    and latent row with x = 1 (reference: FMOnlinePredictor.java:110-160)."""

    def _load_model(self) -> None:
        k = self.params.k
        self.sok = int(k[1])
        self.need_first_order = int(k[0]) >= 1
        self.model_map: Dict[str, np.ndarray] = {}
        for info in self._model_lines(self._model_path("model")):
            self.model_map[info[0].strip()] = np.asarray(
                [float(v) for v in info[1:2 + self.sok]], np.float64)

    def score(self, features, other=None) -> float:
        p = self.params.model
        wx = 0.0
        S = np.zeros(self.sok, np.float64)
        S2 = np.zeros(self.sok, np.float64)
        w = self.model_map.get(p.bias_feature_name)
        if w is not None and p.need_bias:
            wx += w[0]
            v = w[1:]
            S += v
            S2 += v * v
        for name, val in self._prep(features):
            w = self.model_map.get(name)
            if w is None:
                continue
            if self.need_first_order:
                wx += w[0] * val
            v = w[1:] * val
            S += v
            S2 += v * v
        return wx + 0.5 * float(np.sum(S * S - S2))


class FFMPredictor(ContinuousPredictor):
    """The field-aware pairs sum_{p<q} v_p[f_q] . v_q[f_p] x_p x_q
    (reference: FFMOnlinePredictor; lines `name,w,v[field 0: k ...],...`)."""

    def _load_model(self) -> None:
        p = self.params.model
        k = self.params.k
        self.sok = int(k[1])
        self.need_first_order = int(k[0]) >= 1
        if not p.field_dict_path:
            raise ValueError("ffm requires model.field_dict_path")
        self.field_map = load_field_dict(self.fs, p.field_dict_path)
        self.n_fields = len(self.field_map)
        stride = self.n_fields * self.sok
        self.model_map: Dict[str, np.ndarray] = {}
        for info in self._model_lines(self._model_path("model")):
            self.model_map[info[0].strip()] = np.asarray(
                [float(v) for v in info[1:2 + stride]], np.float64)

    def _field_of(self, name: str) -> int:
        """The name's prefix before field_delim through the field dict;
        -1 (the feature drops, as in training) when unknown."""
        fd = self.params.data.delim.field_delim
        return self.field_map.get(name.split(fd)[0], -1)

    def score(self, features, other=None) -> float:
        p = self.params.model
        wx = 0.0
        rows = []  # (field, val, V (n_fields, k))
        w = self.model_map.get(p.bias_feature_name)
        if w is not None and p.need_bias:
            # the bias rides as (field 0, x = 1), as in the ingest
            wx += w[0]
            if self.sok > 0:
                rows.append((0, 1.0, w[1:].reshape(self.n_fields, self.sok)))
        for name, val in self._prep(features):
            w = self.model_map.get(name)
            if w is None:
                continue
            fld = self._field_of(name)
            if fld < 0:
                continue
            if self.need_first_order:
                wx += w[0] * val
            if self.sok > 0:
                rows.append((fld, val,
                             w[1:].reshape(self.n_fields, self.sok)))
        s = wx
        for i in range(len(rows)):
            fi, xi, Vi = rows[i]
            for j in range(i + 1, len(rows)):
                fj, xj, Vj = rows[j]
                s += float(np.dot(Vi[fj], Vj[fi])) * xi * xj
        return s
