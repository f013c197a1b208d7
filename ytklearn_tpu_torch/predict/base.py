"""Online predictor base: a trained model's text files + the training config
are enough to serve `score/predict` on feature dicts (reference:
predictor/OnlinePredictor.java:120-182), and the offline batch predictor
of `cli predict` (`batch_predict_from_files`; reference
ContinuousOnlinePredictor.batchPredictFromFiles:178-330 and
Predicts.java:36-54).

Per-sample scoring is host Python/numpy; `numpy_activation` is the host
mirror of `LossFunction.predict`, so a single request never touches the
device. The batch predictor walks each row on the host and then runs the
activation and the loss once per file on its device.
"""

from __future__ import annotations

import logging
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from ..config import hocon
from ..device import resolve_device
from ..eval import EvalSet
from ..io.fs import LocalFileSystem, create_filesystem
from ..io.reader import load_transform_hook
from ..losses import _POISSON_MAX_EXP, IDENTITY_LOSSES
from ..obs import heartbeat as obs_heartbeat, inc as obs_inc, span as obs_span

log = logging.getLogger("ytklearn_tpu_torch.predict")

SAVE_MODES = ("predict_result_only", "label_and_predict", "predict_as_feature")
#: reference enum-name aliases (ResultSaveMode.PREDICT_AS_FEATURE prints
#: "label_as_feature", OnlinePredictor.java:55)
SAVE_MODE_ALIASES = {"label_as_feature": "predict_as_feature"}
PREDICT_TYPES = ("value", "leafid")


def _np_sigmoid(s):
    s = np.asarray(s, np.float64)
    t = np.exp(-np.abs(s))  # stable: never exponentiates a large positive
    return np.where(s >= 0.0, 1.0 / (1.0 + t), t / (1.0 + t))


def _np_softmax(s):
    s = np.asarray(s, np.float64)
    e = np.exp(s - np.max(s, axis=-1, keepdims=True))
    return e / np.sum(e, axis=-1, keepdims=True)


def numpy_activation(loss):
    """Host mirror of `loss.predict` on float64 scores: numpy for every
    loss but hsoftmax, whose heap walk runs the torch function on a CPU
    tensor."""
    if loss.name == "sigmoid":
        return _np_sigmoid
    if loss.name in IDENTITY_LOSSES:
        return lambda s: s
    if loss.name == "poisson":
        return lambda s: np.exp(np.minimum(np.asarray(s, np.float64),
                                           _POISSON_MAX_EXP))
    if loss.name == "softmax":
        return _np_softmax
    return lambda s: loss.predict(
        torch.as_tensor(np.asarray(s, np.float64))).numpy()


class OnlinePredictor:
    """Config-driven model server (reference: OnlinePredictor.java).

    Subclasses implement `score(features, other)` / `scores(features,
    other)`; features is a {name: value} dict, `other` the sample-dependent
    base prediction of the tree families (None elsewhere)."""

    supports_leaf = False
    n_outputs = 1

    def __init__(self, config, fs: Optional[LocalFileSystem] = None):
        if isinstance(config, str):
            config = hocon.load(config)
        self.config = config
        self.fs = fs or create_filesystem(str(config.get("fs_scheme", "local")))

    def score(self, features: Dict[str, float], other=None) -> float:
        raise NotImplementedError

    def scores(self, features: Dict[str, float], other=None) -> List[float]:
        return [self.score(features, other)]

    def _activation(self, s):
        return numpy_activation(self.loss)(s)

    def predict(self, features: Dict[str, float], other=None) -> float:
        return float(self._activation(self.score(features, other)))

    def predicts(self, features: Dict[str, float], other=None) -> List[float]:
        """The activated scores: one, or one a class of a multi-output
        model."""
        out = self._activation(np.asarray(self.scores(features, other)))
        return [float(v) for v in np.atleast_1d(out)]

    def loss_value(self, features: Dict[str, float], label,
                   other=None) -> float:
        """`loss.loss` of the scores against `label` (K-wide for a
        multi-output model), in float64 on the CPU."""
        return float(self.loss.loss(
            torch.as_tensor(np.asarray(self.scores(features, other),
                                       np.float64)),
            torch.as_tensor(np.asarray(label, np.float64))))

    def predict_leaf(self, features: Dict[str, float]) -> List[int]:
        raise NotImplementedError(f"{type(self).__name__} has no leaf predict")

    def batch_scores(self, rows: Sequence[Dict[str, float]],
                     others=None) -> np.ndarray:
        out = np.empty((len(rows), self.n_outputs), np.float64)
        for i, fmap in enumerate(rows):
            out[i] = self.scores(fmap, None if others is None else others[i])
        return out if self.n_outputs > 1 else out[:, 0]

    def batch_predicts(self, rows, others=None) -> np.ndarray:
        return np.asarray(self._activation(self.batch_scores(rows, others)))


def parse_feature_kvs(text: str, delim) -> Dict[str, float]:
    fmap: Dict[str, float] = {}
    for kv in text.split(delim.features_delim):
        if not kv:
            continue
        name, _, val = kv.partition(delim.feature_name_val_delim)
        fmap[name] = float(val)
    return fmap


class _RowError(Exception):
    pass


def batch_predict_from_files(
    predictor: OnlinePredictor,
    model_name: str,
    file_dir: str,
    need_py_transform: bool = False,
    py_transform_script: str = "",
    result_save_mode: str = "predict_result_only",
    result_file_suffix: str = "_predict",
    max_error_tol: int = 0,
    eval_metric_str: str = "",
    predict_type_str: str = "value",
    K: int = -1,
    device=None,
) -> float:
    """Offline batch prediction (reference: ContinuousOnlinePredictor
    .batchPredictFromFiles:178-330 + Predicts.java:36-54). Writes one
    `<path><suffix>` result file per input file; returns the weighted avg
    loss over labeled rows (0.0 when none). Rows are parsed and walked on
    the host; the activation, the loss and the metrics run once per file
    on `device` (cuda unless the caller passes "cpu")."""
    save_mode = result_save_mode.lower()
    save_mode = SAVE_MODE_ALIASES.get(save_mode, save_mode)
    if save_mode not in SAVE_MODES:
        raise ValueError(f"unknown result_save_mode {result_save_mode!r}")
    predict_type = (predict_type_str or "value").lower()
    if predict_type not in PREDICT_TYPES:
        raise ValueError("predict type invalid! value or leafid")
    if predict_type == "leafid" and not predictor.supports_leaf:
        raise ValueError(f"{model_name} does not support predict type: leafid")
    dev = resolve_device(device)

    delim = predictor.params.data.delim
    fs = predictor.fs
    hook = load_transform_hook(py_transform_script) if need_py_transform else None

    multiclass = model_name.lower() == "multiclass_linear"
    if multiclass and K <= 0:
        K = predictor.n_outputs
    eval_set = (
        EvalSet([m for m in eval_metric_str.split(",") if m], K=max(K, 2))
        if eval_metric_str
        else None
    )
    is_gbst = model_name.lower() in ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")
    is_gbdt = model_name.lower() == "gbdt"
    opt_cfg = predictor.config.get("optimization") or {}
    sample_dep = bool(
        predictor.config.get("sample_dependent_base_prediction", False)
        or (isinstance(opt_cfg, dict)
            and opt_cfg.get("sample_dependent_base_prediction"))
    )

    total_loss, weight_cnt, errors = 0.0, 0.0, 0
    ev_preds: List = []
    ev_labels: List = []
    ev_weights: List[float] = []

    def stage(line: str) -> dict:
        """Per-row parse and model walk on the host; the activation and
        the loss run once per file below."""
        try:
            xsplits = line.split(delim.x_delim)
            weight = float(xsplits[0])
            label_text = xsplits[1].strip()
            fmap = parse_feature_kvs(xsplits[2], delim)
        except (IndexError, ValueError) as e:
            raise _RowError(str(e)) from e

        has_label = len(label_text) > 0
        if not has_label and save_mode != "predict_result_only":
            raise _RowError(f"sample has no label: {line}")

        other = None
        if sample_dep and len(xsplits) > 3:
            # the per-sample base score column (reference:
            # ContinuousOnlinePredictor's GBST branch;
            # GBDTOnlinePredictor.batchPredictFromFiles:361-369 reads a
            # y_delim-split Float[] a class group)
            if is_gbst:
                other = float(xsplits[3])
            elif is_gbdt:
                oinfo = [float(v) for v in xsplits[3].split(delim.y_delim)]
                other = oinfo if len(oinfo) > 1 else oinfo[0]

        st: dict = {"xsplits": xsplits, "weight": weight, "labels": None}
        try:
            if predict_type == "leafid":
                st["preds"] = [int(v) for v in predictor.predict_leaf(fmap)]
                return st
            st["raw"] = np.asarray(predictor.scores(fmap, other), np.float64)
            if has_label:
                linfo = [float(v) for v in label_text.split(delim.y_delim)]
                k = len(st["raw"])
                if multiclass or k > 1:
                    if len(linfo) == 1:
                        labels = [0.0] * max(K, k)
                        labels[int(linfo[0])] = 1.0
                    elif len(linfo) == max(K, k):
                        labels = linfo
                    else:
                        raise _RowError(
                            f"label num must be {max(K, k)} or 1: {line}")
                    st["labels"] = labels
                else:
                    st["labels"] = [linfo[0]]
        except _RowError:
            raise
        except Exception as e:
            raise _RowError(str(e)) from e
        return st

    def fmt(st: dict) -> str:
        xsplits, preds = st["xsplits"], st["preds"]
        pred_text = delim.y_delim.join(repr(p) for p in preds)
        if save_mode == "predict_result_only":
            return pred_text
        if save_mode == "label_and_predict":
            return xsplits[1] + delim.x_delim + pred_text
        extra = delim.features_delim.join(
            f"{model_name}_label_{i}{delim.feature_name_val_delim}{p!r}"
            for i, p in enumerate(preds)
        )
        return (
            xsplits[0] + delim.x_delim + xsplits[1] + delim.x_delim
            + xsplits[2] + delim.features_delim + extra
        )

    def on_device(a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    hb = obs_heartbeat("predict.batch", every_s=30.0)
    for path in sorted(fs.recur_get_paths([file_dir])):
        staged: List[dict] = []
        with fs.open(path) as f:
            raw_lines: Iterable[str] = list(f)
        with obs_span("predict.score_file", file=path):
            for raw in raw_lines:
                raw = raw.rstrip("\n")
                if not raw.strip():
                    continue
                for line in hook(raw.encode()) if hook is not None else [raw]:
                    try:
                        staged.append(stage(line))
                    except _RowError as e:
                        errors += 1
                        if errors > max_error_tol:
                            raise ValueError(
                                f"max error tolerance exceeded ({errors}): {e}"
                            ) from e
        obs_inc("predict.rows", len(staged))
        hb.beat(file=path, rows=len(staged), errors=errors)

        # the activation: one call a file on the device
        vrows = [s for s in staged if "raw" in s]
        if vrows:
            with obs_span("predict.activate", rows=len(vrows)):
                raws = np.stack([s["raw"] for s in vrows])  # (N, k)
                k = raws.shape[1]
                act = predictor.loss.predict(
                    on_device(raws[:, 0] if k == 1 else raws))
                act = act.cpu().numpy().reshape(len(vrows), -1)
            for s, arow in zip(vrows, act):
                s["preds"] = [float(v) for v in arow]

        # the loss over the labeled rows: one call a file on the device
        lrows = [s for s in vrows if s["labels"] is not None]
        if lrows:
            raws_l = np.stack([s["raw"] for s in lrows])
            k = raws_l.shape[1]
            labs = np.asarray([s["labels"] for s in lrows], np.float64)
            lv = predictor.loss.loss(
                on_device(raws_l[:, 0] if k == 1 else raws_l),
                on_device(labs[:, 0] if k == 1 else labs),
            ).cpu().numpy().reshape(-1)
            for s, li in zip(lrows, lv):
                total_loss += s["weight"] * float(li)
                weight_cnt += s["weight"]
                ev_weights.append(s["weight"])
                ev_labels.append(s["labels"] if len(s["labels"]) > 1
                                 else s["labels"][0])
                ev_preds.append(s["preds"] if len(s["preds"]) > 1
                                else s["preds"][0])

        out_path = path + result_file_suffix
        with fs.open(out_path, "w") as f:
            for line in (fmt(s) for s in staged):
                f.write(line + "\n")
        log.info("predicted %s -> %s", path, out_path)

    if eval_set is not None and ev_preds:
        res = eval_set.evaluate(
            on_device(ev_preds), on_device(ev_labels),
            torch.as_tensor(np.asarray(ev_weights, np.float32), device=dev))
        for k, v in res.items():
            log.info("eval %s: %.6f", k, v)

    obs_inc("predict.error_lines", errors)
    return total_loss / weight_cnt if weight_cnt > 0 else 0.0
