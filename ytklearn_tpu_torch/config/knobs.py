"""Registry of the ``YTK_*`` environment knobs the port reads.

Same names, types and defaults as the JAX package's registry
(``ytklearn_tpu/config/knobs.py``), cut to the knobs the GBDT serving path
reads. Every read goes through the typed accessors below, which re-read
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

__all__ = ["Knob", "KNOBS", "get_str", "get_bool"]


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "bool"
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
      "binned GBDT scoring rung; not ported yet, so the scorer refuses it")
_knob("YTK_SERVE_PRECISION", "str", "f64",
      "serving precision rung for the einsum scorers (`f64` | `bf16`); "
      "GBDT scores in f64 whatever it asks")

_FALSY = ("0", "false", "no", "off")


def _declared(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in "
            "ytklearn_tpu_torch/config/knobs.py"
        ) from None


def get_str(name: str) -> Optional[str]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else knob.default


def get_bool(name: str) -> bool:
    """Unset or empty -> declared default; `0`/`false`/`no`/`off` (any
    case) -> False; anything else -> True."""
    knob = _declared(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(knob.default)
    return raw.strip().lower() not in _FALSY
