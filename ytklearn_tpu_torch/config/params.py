"""Typed GBDT parameters parsed from HOCON configs.

The fields of ``ytklearn_tpu/config/params.py`` (``ModelParams``,
``GBDTParams.from_config``) that the GBDT predictor reads, with the same
config paths, defaults and ``???`` handling, so one config file drives
both packages.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .hocon import MISSING, get_path


def _req(cfg: dict, path: str):
    v = get_path(cfg, path, MISSING)
    if v is MISSING or v == "???":
        raise ValueError(f"config value {path!r} is required but unset (???)")
    return v


def _opt(cfg: dict, path: str, default):
    v = get_path(cfg, path, default)
    return default if v is MISSING or v == "???" else v


@dataclass
class ModelParams:
    data_path: str = ""

    @classmethod
    def from_config(cls, cfg: dict) -> "ModelParams":
        return cls(data_path=str(_req(cfg, "model.data_path")))


@dataclass
class GBDTParams:
    fs_scheme: str = "local"
    gbdt_type: str = "gradient_boosting"  # gradient_boosting | random_forest
    model: ModelParams = field(default_factory=ModelParams)
    round_num: int = 50
    loss_function: str = "sigmoid"
    sigmoid_zmax: float = 0.0

    @classmethod
    def from_config(cls, cfg: dict) -> "GBDTParams":
        o = "optimization"
        return cls(
            fs_scheme=str(_opt(cfg, "fs_scheme", "local")),
            gbdt_type=str(_opt(cfg, "type", "gradient_boosting")),
            model=ModelParams.from_config(cfg),
            round_num=int(_opt(cfg, f"{o}.round_num", 50)),
            loss_function=str(_opt(cfg, f"{o}.loss_function", "sigmoid")),
            sigmoid_zmax=float(_opt(cfg, f"{o}.sigmoid_zmax", 0.0)),
        )
