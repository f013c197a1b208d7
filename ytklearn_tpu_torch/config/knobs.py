"""Registry of the ``YTK_*`` environment knobs the port reads.

Same names, types and defaults as the JAX package's registry
(``ytklearn_tpu/config/knobs.py``), cut to the knobs the GBDT serving path,
the GBDT device-engine trainer, the convex families' blocked evaluation,
the text ingest and the host binning read. Every read goes through the typed accessors below, which re-read
``os.environ`` on each call, so a test or an operator may set a knob at run
time.

The micro-batcher's policy (``--max-batch``, ``--max-wait-ms``,
``--max-queue``) comes from CLI flags in both packages; neither declares an
environment knob for it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Knob", "KNOBS", "get_str", "get_int", "get_float", "get_bool"]


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool"
    default: object  # parsed value returned when the env var is unset
    doc: str


KNOBS: Dict[str, Knob] = {}


def _knob(name: str, type_: str, default, doc: str) -> None:
    if name in KNOBS:
        raise ValueError(f"duplicate knob declaration: {name}")
    KNOBS[name] = Knob(name, type_, default, doc)


_knob("YTK_SERVE_LADDER", "str", None,
      "serving batch-shape ladder, e.g. `1,8,64,512`")
_knob("YTK_SERVE_FUSED", "bool", False,
      "serve GBDT through the fused heap-walk CUDA kernel (bit-identical "
      "to the stacked rung)")
_knob("YTK_SERVE_BINNED", "bool", False,
      "serve GBDT on the binned rung: rows binned once per batch, the "
      "binned heap-walk CUDA kernel (wins over `YTK_SERVE_FUSED`)")
_knob("YTK_SERVE_PRECISION", "str", "f64",
      "serving precision rung for the einsum scorers (`f64` | `bf16`); "
      "GBDT and GBST score in f64 whatever it asks")
_knob("YTK_TRANSFORM_CACHE", "int", 1_000_000,
      "bound on the serve-time feature-hash resolution cache (raw name -> "
      "scoring column and murmur sign, per loaded model); past it new "
      "names compute uncached")

# -- convex families (same defaults as ytklearn_tpu/config/knobs.py:86-90) --
_knob("YTK_ROW_CHUNK", "int", None,
      "fixed row chunk of the blocked convex loss/grad/score evaluation")
_knob("YTK_CHUNK_BUDGET_MB", "int", 1024,
      "score-intermediate memory budget that sizes the automatic row chunk")

# -- gbdt engine (same defaults as ytklearn_tpu/config/knobs.py:93-125) ----
_knob("YTK_PARTITION", "bool", True,
      "leaf-partitioned GBDT histogram phases (`0` turns them off)")
_knob("YTK_NO_PARTITION", "bool", False,
      "hard-disable leaf-partitioned histograms (wins over `YTK_PARTITION`)")
_knob("YTK_LADDER", "str", None,
      "comma-separated budget-ladder divisors for partitioned histogram "
      "passes (default: `64,256` on cuda, `8,32` on the CPU)")
_knob("YTK_FUSED", "bool", True,
      "fused gather+histogram kernel for partitioned passes (`0` gathers "
      "the rows first and runs the full-scan kernel on them)")
_knob("YTK_FUSED_MAX_ROWS", "int", 1 << 18,
      "max gathered rows per fused-kernel call")
_knob("YTK_GOSS_A", "float", 1.0,
      "GOSS top-gradient-magnitude keep fraction per tree; a value < 1 "
      "enables gradient-based one-side sampling")
_knob("YTK_GOSS_B", "float", 0.1,
      "GOSS sample rate on the non-top remainder (sampled rows carry the "
      "1/b gradient amplification); active only when `YTK_GOSS_A` < 1")
_knob("YTK_EFB", "bool", True,
      "exclusive feature bundling at binning time: merge mutually exclusive "
      "sparse columns into offset-binned bundles (no-op when none exist)")
_knob("YTK_EFB_CONFLICT", "int", 0,
      "max conflicting rows tolerated per EFB bundle (0 = strictly "
      "exclusive, lossless)")

# -- ingest and host binning (same defaults as ytklearn_tpu/config/knobs.py:
# 79-83; the port reads YTK_NO_NATIVE at every dispatch, not once) --------
_knob("YTK_NO_NATIVE", "bool", False,
      "disable the native C++ text parser (the Python parser runs)")
_knob("YTK_SKETCH_ROWS", "int", 1 << 25,
      "rows above which host quantile binning streams through the weighted "
      "quantile sketch instead of the full-sort path")

_FALSY = ("0", "false", "no", "off")


def _declared(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in "
            "ytklearn_tpu_torch/config/knobs.py"
        ) from None


def get_raw(name: str) -> Optional[str]:
    """The raw env string, or None when unset."""
    _declared(name)
    return os.environ.get(name)


def get_str(name: str) -> Optional[str]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else knob.default


def get_int(name: str) -> Optional[int]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else knob.default


def get_float(name: str) -> Optional[float]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else knob.default


def get_bool(name: str) -> bool:
    """Unset or empty -> declared default; `0`/`false`/`no`/`off` (any
    case) -> False; anything else -> True."""
    knob = _declared(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(knob.default)
    return raw.strip().lower() not in _FALSY
