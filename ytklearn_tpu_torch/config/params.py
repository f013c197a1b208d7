"""Typed GBDT parameters parsed from HOCON configs.

The fields of ``ytklearn_tpu/config/params.py`` (``DelimParams``,
``DataParams``, ``ModelParams``, ``ApproximateSpec``,
``GBDTParams.from_config``) that the GBDT predictor, the ingest and the
device-engine trainer read, with the same config paths, defaults and
``???`` handling, so one config file drives both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from .hocon import MISSING, get_path


def _req(cfg: dict, path: str):
    v = get_path(cfg, path, MISSING)
    if v is MISSING or v == "???":
        raise ValueError(f"config value {path!r} is required but unset (???)")
    return v


def _opt(cfg: dict, path: str, default):
    v = get_path(cfg, path, default)
    return default if v is MISSING or v == "???" else v


def _opt_path(cfg: dict, path: str) -> str:
    return str(_opt(cfg, path, "") or "")


def _as_paths(v) -> List[str]:
    """data_path may be a single string or a list; comma-split like the
    reference's multi-path handling. "???" placeholders drop out."""
    if v is None or v is MISSING or v == "":
        return []
    if isinstance(v, (list, tuple)):
        out: List[str] = []
        for x in v:
            out.extend(_as_paths(x))
        return out
    return [p for p in str(v).split(",") if p and p != "???"]


@dataclass
class DelimParams:
    """reference: param/DataParams.java (delim block)."""

    x_delim: str = "###"
    y_delim: str = ","
    features_delim: str = ","
    feature_name_val_delim: str = ":"

    @classmethod
    def from_config(cls, cfg: dict) -> "DelimParams":
        d = get_path(cfg, "data.delim", {}) or {}
        return cls(
            x_delim=d.get("x_delim", "###"),
            y_delim=d.get("y_delim", ","),
            features_delim=d.get("features_delim", ","),
            feature_name_val_delim=d.get("feature_name_val_delim", ":"),
        )


@dataclass
class DataParams:
    train_paths: List[str] = field(default_factory=list)
    train_max_error_tol: int = 0
    test_paths: List[str] = field(default_factory=list)
    test_max_error_tol: int = 0
    delim: DelimParams = field(default_factory=DelimParams)
    # ["0@0.1", "1@0.5"]: keep label 0 w.p. 0.1 (the convex ingest's)
    y_sampling: List[Tuple[str, float]] = field(default_factory=list)
    assigned: bool = False
    unassigned_mode: str = "lines_avg"  # lines_avg | files_avg
    max_feature_dim: int = -1  # GBDT only

    @classmethod
    def from_config(cls, cfg: dict) -> "DataParams":
        ys = []
        for s in _opt(cfg, "data.y_sampling", []) or []:
            label, rate = str(s).split("@")
            ys.append((label, float(rate)))
        return cls(
            train_paths=_as_paths(_opt(cfg, "data.train.data_path", "")),
            train_max_error_tol=int(_opt(cfg, "data.train.max_error_tol", 0)),
            test_paths=_as_paths(_opt(cfg, "data.test.data_path", "")),
            test_max_error_tol=int(_opt(cfg, "data.test.max_error_tol", 0)),
            delim=DelimParams.from_config(cfg),
            y_sampling=ys,
            assigned=bool(_opt(cfg, "data.assigned", False)),
            unassigned_mode=str(_opt(cfg, "data.unassigned_mode",
                                     "lines_avg")),
            max_feature_dim=int(_opt(cfg, "data.max_feature_dim", -1)),
        )


@dataclass
class ModelParams:
    data_path: str = ""
    dump_freq: int = 50
    continue_train: bool = False
    feature_importance_path: str = ""  # GBDT

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelParams":
        return cls(
            data_path=str(_req(cfg, "model.data_path")),
            dump_freq=int(_opt(cfg, "model.dump_freq", 50)),
            continue_train=bool(_opt(cfg, "model.continue_train", False)),
            feature_importance_path=_opt_path(
                cfg, "model.feature_importance_path"),
        )


@dataclass
class ApproximateSpec:
    """One entry of feature.approximate (the JAX package's
    config/params.py:ApproximateSpec, field for field)."""

    cols: str = "default"
    type: str = "sample_by_quantile"
    max_cnt: int = 255
    quantile_approximate_bin_factor: int = 8
    use_sample_weight: bool = False
    alpha: float = 1.0
    sample_rate: float = 1.0
    min_cnt: int = 0
    dot_precision: int = 5
    use_log: bool = False
    use_min_max: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "ApproximateSpec":
        return cls(
            cols=str(d.get("cols", "default")),
            type=str(d.get("type", "sample_by_quantile")),
            max_cnt=int(d.get("max_cnt", 255)),
            quantile_approximate_bin_factor=int(
                d.get("quantile_approximate_bin_factor", 8)),
            use_sample_weight=bool(d.get("use_sample_weight", False)),
            alpha=float(d.get("alpha", 1.0)),
            sample_rate=float(d.get("sample_rate", 1.0)),
            min_cnt=int(d.get("min_cnt", 0)),
            dot_precision=int(d.get("dot_precision", 5)),
            use_log=bool(d.get("use_log", False)),
            use_min_max=bool(d.get("use_min_max", False)),
        )


@dataclass
class GBDTParams:
    fs_scheme: str = "local"
    gbdt_type: str = "gradient_boosting"  # gradient_boosting | random_forest
    data: DataParams = field(default_factory=DataParams)
    model: ModelParams = field(default_factory=ModelParams)

    # optimization block
    tree_maker: str = "data"  # data | feature
    tree_grow_policy: str = "level"  # level | loss
    round_num: int = 50
    max_depth: int = 5
    min_child_hessian_sum: float = 1e-8
    max_abs_leaf_val: float = -1.0
    min_split_loss: float = 0.0
    min_split_samples: int = 2
    max_leaf_cnt: int = 128
    loss_function: str = "sigmoid"
    sigmoid_zmax: float = 0.0
    lad_refine_appr: bool = True
    learning_rate: float = 0.09
    l1: float = 0.0
    l2: float = 1.0
    uniform_base_prediction: float = 0.5
    sample_dependent_base_prediction: bool = False
    instance_sample_rate: float = 1.0
    feature_sample_rate: float = 1.0
    class_num: int = 1
    just_evaluate: bool = False
    eval_metric: List[str] = field(default_factory=lambda: ["auc"])

    # feature block
    split_type: str = "mean"  # mean | median
    approximate: List[ApproximateSpec] = field(default_factory=list)
    missing_value: str = "value"  # mean | quantile[@q] | value[@v]

    @classmethod
    def from_config(cls, cfg: dict) -> "GBDTParams":
        appr = [
            ApproximateSpec.from_dict(d)
            for d in (_opt(cfg, "feature.approximate", []) or [])
            if isinstance(d, dict)
        ]
        if not appr:
            appr = [ApproximateSpec()]
        o = "optimization"
        r = f"{o}.regularization"
        return cls(
            fs_scheme=str(_opt(cfg, "fs_scheme", "local")),
            gbdt_type=str(_opt(cfg, "type", "gradient_boosting")),
            data=DataParams.from_config(cfg),
            model=ModelParams.from_config(cfg),
            tree_maker=str(_opt(cfg, f"{o}.tree_maker", "data")),
            tree_grow_policy=str(_opt(cfg, f"{o}.tree_grow_policy", "level")),
            round_num=int(_opt(cfg, f"{o}.round_num", 50)),
            max_depth=int(_opt(cfg, f"{o}.max_depth", 5)),
            min_child_hessian_sum=float(
                _opt(cfg, f"{o}.min_child_hessian_sum", 1e-8)),
            max_abs_leaf_val=float(_opt(cfg, f"{o}.max_abs_leaf_val", -1.0)),
            min_split_loss=float(_opt(cfg, f"{o}.min_split_loss", 0.0)),
            min_split_samples=int(_opt(cfg, f"{o}.min_split_samples", 2)),
            max_leaf_cnt=int(_opt(cfg, f"{o}.max_leaf_cnt", 128)),
            loss_function=str(_opt(cfg, f"{o}.loss_function", "sigmoid")),
            sigmoid_zmax=float(_opt(cfg, f"{o}.sigmoid_zmax", 0.0)),
            lad_refine_appr=bool(_opt(cfg, f"{o}.lad_refine_appr", True)),
            learning_rate=float(_opt(cfg, f"{r}.learning_rate", 0.09)),
            l1=float(_opt(cfg, f"{r}.l1", 0.0)),
            l2=float(_opt(cfg, f"{r}.l2", 1.0)),
            uniform_base_prediction=float(
                _opt(cfg, f"{o}.uniform_base_prediction", 0.5)),
            sample_dependent_base_prediction=bool(
                _opt(cfg, f"{o}.sample_dependent_base_prediction", False)),
            instance_sample_rate=float(
                _opt(cfg, f"{o}.instance_sample_rate", 1.0)),
            feature_sample_rate=float(
                _opt(cfg, f"{o}.feature_sample_rate", 1.0)),
            class_num=int(_opt(cfg, f"{o}.class_num", 1)),
            just_evaluate=bool(_opt(cfg, f"{o}.just_evaluate", False)),
            eval_metric=list(_opt(cfg, f"{o}.eval_metric", ["auc"]) or []),
            split_type=str(_opt(cfg, "feature.split_type", "mean")),
            approximate=appr,
            missing_value=str(_opt(cfg, "feature.missing_value", "value")),
        )

    @property
    def num_tree_in_group(self) -> int:
        """Trees per boosting round: softmax multiclass grows class_num
        trees per round."""
        return (self.class_num
                if self.loss_function == "softmax" and self.class_num > 1
                else 1)
