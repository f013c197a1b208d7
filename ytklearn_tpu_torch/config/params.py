"""Typed parameters parsed from HOCON configs.

The fields of ``ytklearn_tpu/config/params.py`` that the port reads, with
the same config paths, defaults and ``???`` handling, so one config file
drives both packages: ``GBDTParams`` (the GBDT predictor, ingest and
device-engine trainer) and ``CommonParams`` (the convex families: linear,
multiclass_linear, FM, FFM) with their blocks. The ``continual.*`` block
comes with continual training (ROADMAP.md 1.11).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Tuple

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
    field_delim: str = "@"  # FFM only

    @classmethod
    def from_config(cls, cfg: dict) -> "DelimParams":
        d = get_path(cfg, "data.delim", {}) or {}
        return cls(
            x_delim=d.get("x_delim", "###"),
            y_delim=d.get("y_delim", ","),
            features_delim=d.get("features_delim", ","),
            feature_name_val_delim=d.get("feature_name_val_delim", ":"),
            field_delim=d.get("field_delim", "@"),
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
class FeatureHashParams:
    """reference: param/FeatureHashParams.java:38."""

    need_feature_hash: bool = False
    bucket_size: int = 1_000_000
    seed: int = 39916801
    feature_prefix: str = "hash_"

    @classmethod
    def from_config(cls, cfg: dict) -> "FeatureHashParams":
        b = "feature.feature_hash"
        return cls(
            need_feature_hash=bool(_opt(cfg, f"{b}.need_feature_hash",
                                        False)),
            bucket_size=int(_opt(cfg, f"{b}.bucket_size", 1_000_000)),
            seed=int(_opt(cfg, f"{b}.seed", 39916801)),
            feature_prefix=str(_opt(cfg, f"{b}.feature_prefix", "hash_")),
        )


@dataclass
class TransformParams:
    """Standardization / range scaling (param/TransformParams.java:41)."""

    switch_on: bool = False
    mode: str = "standardization"  # standardization | scale_range
    scale_min: float = -1.0
    scale_max: float = 1.0
    include_features: List[str] = field(default_factory=list)
    exclude_features: List[str] = field(default_factory=list)

    @classmethod
    def from_config(cls, cfg: dict) -> "TransformParams":
        b = "feature.transform"
        return cls(
            switch_on=bool(_opt(cfg, f"{b}.switch_on", False)),
            mode=str(_opt(cfg, f"{b}.mode", "standardization")),
            scale_min=float(_opt(cfg, f"{b}.scale_range.min", -1.0)),
            scale_max=float(_opt(cfg, f"{b}.scale_range.max", 1.0)),
            include_features=list(
                _opt(cfg, f"{b}.include_features", []) or []),
            exclude_features=list(
                _opt(cfg, f"{b}.exclude_features", []) or []),
        )


@dataclass
class FeatureParams:
    feature_hash: FeatureHashParams = field(default_factory=FeatureHashParams)
    transform: TransformParams = field(default_factory=TransformParams)
    filter_threshold: int = 0

    @classmethod
    def from_config(cls, cfg: dict) -> "FeatureParams":
        return cls(
            feature_hash=FeatureHashParams.from_config(cfg),
            transform=TransformParams.from_config(cfg),
            filter_threshold=int(_opt(cfg, "feature.filter_threshold", 0)),
        )


@dataclass
class ModelParams:
    """reference: param/ModelParams.java:38."""

    data_path: str = ""
    delim: str = ","
    need_dict: bool = False
    dict_path: str = ""
    dump_freq: int = 50
    need_bias: bool = True
    bias_feature_name: str = "_bias_"
    continue_train: bool = False
    field_dict_path: str = ""  # FFM
    feature_importance_path: str = ""  # GBDT

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelParams":
        return cls(
            data_path=str(_req(cfg, "model.data_path")),
            delim=str(_opt(cfg, "model.delim", ",")),
            need_dict=bool(_opt(cfg, "model.need_dict", False)),
            dict_path=_opt_path(cfg, "model.dict_path"),
            dump_freq=int(_opt(cfg, "model.dump_freq", 50)),
            need_bias=bool(_opt(cfg, "model.need_bias", True)),
            bias_feature_name=str(_opt(cfg, "model.bias_feature_name",
                                       "_bias_")),
            continue_train=bool(_opt(cfg, "model.continue_train", False)),
            field_dict_path=_opt_path(cfg, "model.field_dict_path"),
            feature_importance_path=_opt_path(
                cfg, "model.feature_importance_path"),
        )


@dataclass
class LossParams:
    """reference: param/LossParams.java:41."""

    loss_function: str = "sigmoid"
    evaluate_metric: List[str] = field(default_factory=lambda: ["auc"])
    just_evaluate: bool = False
    l1: List[float] = field(default_factory=lambda: [0.0])
    l2: List[float] = field(default_factory=lambda: [0.0])

    @classmethod
    def from_config(cls, cfg: dict) -> "LossParams":
        return cls(
            loss_function=str(_opt(cfg, "loss.loss_function", "sigmoid")),
            evaluate_metric=list(
                _opt(cfg, "loss.evaluate_metric", ["auc"]) or []),
            just_evaluate=bool(_opt(cfg, "loss.just_evaluate", False)),
            l1=[float(x) for x in _opt(cfg, "loss.regularization.l1", [0.0])],
            l2=[float(x) for x in _opt(cfg, "loss.regularization.l2", [0.0])],
        )


@dataclass
class LineSearchParams:
    """reference: param/LineSearchParams.java:43."""

    mode: str = "wolfe"  # sufficient_decrease | wolfe | strong_wolfe
    step_decr: float = 0.5
    step_incr: float = 2.1
    max_iter: int = 55
    min_step: float = 1e-16
    max_step: float = 1e18
    c1: float = 1e-4
    c2: float = 0.9
    lbfgs_m: int = 8
    lbfgs_max_iter: int = 60
    lbfgs_eps: float = 1e-3

    @classmethod
    def from_config(cls, cfg: dict) -> "LineSearchParams":
        b = "optimization.line_search"
        bt = f"{b}.backtracking"
        return cls(
            mode=str(_opt(cfg, f"{b}.mode", "wolfe")),
            step_decr=float(_opt(cfg, f"{bt}.step_decr", 0.5)),
            step_incr=float(_opt(cfg, f"{bt}.step_incr", 2.1)),
            max_iter=int(_opt(cfg, f"{bt}.max_iter", 55)),
            min_step=float(_opt(cfg, f"{bt}.min_step", 1e-16)),
            max_step=float(_opt(cfg, f"{bt}.max_step", 1e18)),
            c1=float(_opt(cfg, f"{bt}.c1", 1e-4)),
            c2=float(_opt(cfg, f"{bt}.c2", 0.9)),
            lbfgs_m=int(_opt(cfg, f"{b}.lbfgs.m", 8)),
            lbfgs_max_iter=int(_opt(cfg, f"{b}.lbfgs.convergence.max_iter",
                                    60)),
            lbfgs_eps=float(_opt(cfg, f"{b}.lbfgs.convergence.eps", 1e-3)),
        )


@dataclass
class HyperParams:
    """reference: param/HyperParams.java:41 (grid and HOAG search)."""

    switch_on: bool = False
    restart: bool = False
    mode: str = "hoag"  # hoag | grid
    hoag_init_step: float = 1.0
    hoag_step_decr_factor: float = 0.7
    hoag_test_loss_reduce_limit: float = 1e-5
    hoag_outer_iter: int = 10
    hoag_l1: List[float] = field(default_factory=lambda: [0.0])
    hoag_l2: List[float] = field(default_factory=lambda: [0.0])
    grid_l1: List[float] = field(default_factory=list)
    grid_l2: List[float] = field(default_factory=list)

    @classmethod
    def from_config(cls, cfg: dict) -> "HyperParams":
        h = "hyper.hoag"
        return cls(
            switch_on=bool(_opt(cfg, "hyper.switch_on", False)),
            restart=bool(_opt(cfg, "hyper.restart", False)),
            mode=str(_opt(cfg, "hyper.mode", "hoag")),
            hoag_init_step=float(_opt(cfg, f"{h}.init_step", 1.0)),
            hoag_step_decr_factor=float(_opt(cfg, f"{h}.step_decr_factor",
                                             0.7)),
            hoag_test_loss_reduce_limit=float(
                _opt(cfg, f"{h}.test_loss_reduce_limit", 1e-5)),
            hoag_outer_iter=int(_opt(cfg, f"{h}.outer_iter", 10)),
            hoag_l1=[float(x) for x in _opt(cfg, f"{h}.l1", [0.0])],
            hoag_l2=[float(x) for x in _opt(cfg, f"{h}.l2", [0.0])],
            grid_l1=[float(x) for x in _opt(cfg, "hyper.grid.l1", [])],
            grid_l2=[float(x) for x in _opt(cfg, "hyper.grid.l2", [])],
        )


@dataclass
class RandomParams:
    """Latent-factor init (reference: param/RandomParams.java:40)."""

    mode: str = "normal"  # normal | uniform
    seed: int = 111111
    normal_mean: float = 0.0
    normal_std: float = 0.01
    uniform_range_start: float = -0.01
    uniform_range_end: float = 0.01

    @classmethod
    def from_config(cls, cfg: dict) -> "RandomParams":
        return cls(
            mode=str(_opt(cfg, "random.mode", "normal")),
            seed=int(_opt(cfg, "random.seed", 111111)),
            normal_mean=float(_opt(cfg, "random.normal.mean", 0.0)),
            normal_std=float(_opt(cfg, "random.normal.std", 0.01)),
            uniform_range_start=float(
                _opt(cfg, "random.uniform.range_start", -0.01)),
            uniform_range_end=float(
                _opt(cfg, "random.uniform.range_end", 0.01)),
        )


@dataclass
class CommonParams:
    """The convex and GBST families' blocks (reference:
    param/CommonParams.java:40-45) and the root-level scalars they read:
    `k` (an int for multiclass_linear and GBST, [use_first_order, dim] for
    FM and FFM), `bias_need_latent_factor`, and GBST's `tree_num`,
    `learning_rate`, `type` (as `gbst_type`), `leaf_random_init_range`,
    the per-tree sample rates and `uniform_base_prediction`."""

    fs_scheme: str = "local"
    verbose: bool = False
    data: DataParams = field(default_factory=DataParams)
    feature: FeatureParams = field(default_factory=FeatureParams)
    model: ModelParams = field(default_factory=ModelParams)
    loss: LossParams = field(default_factory=LossParams)
    line_search: LineSearchParams = field(default_factory=LineSearchParams)
    hyper: HyperParams = field(default_factory=HyperParams)
    random: RandomParams = field(default_factory=RandomParams)
    k: Any = None
    bias_need_latent_factor: bool = False
    instance_sample_rate: float = 1.0
    feature_sample_rate: float = 1.0
    uniform_base_prediction: float = 0.5
    tree_num: int = 1
    learning_rate: float = 1.0
    gbst_type: str = "gradient_boosting"  # gradient_boosting | random_forest
    leaf_random_init_range: List[float] = field(
        default_factory=lambda: [-2.0, 2.0])
    raw: dict = field(default_factory=dict, repr=False)

    @classmethod
    def from_config(cls, cfg: dict) -> "CommonParams":
        return cls(
            fs_scheme=str(_opt(cfg, "fs_scheme", "local")),
            verbose=bool(_opt(cfg, "verbose", False)),
            data=DataParams.from_config(cfg),
            feature=FeatureParams.from_config(cfg),
            model=ModelParams.from_config(cfg),
            loss=LossParams.from_config(cfg),
            line_search=LineSearchParams.from_config(cfg),
            hyper=HyperParams.from_config(cfg),
            random=RandomParams.from_config(cfg),
            k=_opt(cfg, "k", None),
            bias_need_latent_factor=bool(
                _opt(cfg, "bias_need_latent_factor", False)),
            instance_sample_rate=float(_opt(cfg, "instance_sample_rate",
                                            1.0)),
            feature_sample_rate=float(_opt(cfg, "feature_sample_rate", 1.0)),
            uniform_base_prediction=float(
                _opt(cfg, "uniform_base_prediction", 0.5)),
            tree_num=int(_opt(cfg, "tree_num", 1)),
            learning_rate=float(_opt(cfg, "learning_rate", 1.0)),
            gbst_type=str(_opt(cfg, "type", "gradient_boosting")),
            leaf_random_init_range=[
                float(x) for x in _opt(cfg, "leaf_random_init_range",
                                       [-2.0, 2.0])],
            raw=cfg,
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
