"""Carry the JAX package's GBDT state into the port, as plain numpy data.

The port never imports the JAX package, so these functions take what a
caller can read off it without JAX: numpy arrays and field dicts (e.g.
``dataclasses.asdict`` of its GrowSpec, ``TreeArrays._asdict()`` of its
device tree after ``np.asarray``). The tests feed both packages the same
bins, gradients and spec through them.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .binning import FeatureBins
from .engine import GrowSpec, TreeArrays

_DROPPED_SPEC_FIELDS = ("force_dense", "fused_interpret")


def feature_bins_from_numpy(values, counts, max_bins: Optional[int] = None,
                            exact=None) -> FeatureBins:
    """The reference's FeatureBins arrays -> the port's FeatureBins."""
    values = np.ascontiguousarray(values, np.float32)
    counts = np.ascontiguousarray(counts, np.int32)
    return FeatureBins(
        values=values, counts=counts,
        max_bins=int(values.shape[1] if max_bins is None else max_bins),
        exact=None if exact is None else np.asarray(exact, bool),
    )


def grow_spec_from_fields(fields: Dict[str, object]) -> GrowSpec:
    """The reference GrowSpec's fields -> the port's GrowSpec growing the
    same tree. The reference gathers a budget's rows in XLA at a 128-row
    unit when `force_dense` (its CPU path) and fuses a rung only where its
    Pallas kernel runs (on a TPU, or under the interpreter); the port has
    one implementation per rung, so those flags become `bm` and `fused`."""
    d = dict(fields)
    force_dense = bool(d.get("force_dense", False))
    interpret = bool(d.get("fused_interpret", False))
    d["fused"] = bool(d.get("fused", True)) and (not force_dense or interpret)
    if force_dense:
        d["bm"] = 128
    for k in _DROPPED_SPEC_FIELDS:
        d.pop(k, None)
    d["ladder"] = tuple(int(x) for x in d.get("ladder", (8, 32)))
    return GrowSpec(**d)


_TREE_DTYPES = {
    "feat": torch.int32, "slot": torch.int32, "slot_r": torch.int32,
    "left": torch.int32, "right": torch.int32, "leaf": torch.float32,
    "gain": torch.float32, "hess": torch.float32, "cnt": torch.float32,
    "depth": torch.int32, "n_nodes": torch.int32,
}


def tree_arrays_from_numpy(fields: Dict[str, np.ndarray], device="cpu"
                           ) -> TreeArrays:
    """The reference TreeArrays' fields (numpy) -> the port's TreeArrays
    on `device`."""
    return TreeArrays(**{
        k: torch.as_tensor(np.array(fields[k]), dtype=dt, device=device)
        for k, dt in _TREE_DTYPES.items()
    })


def tree_arrays_to_numpy(tr: TreeArrays) -> Dict[str, np.ndarray]:
    """The port's TreeArrays -> {field: numpy array} on the host."""
    return {k: v.detach().cpu().numpy() for k, v in tr._asdict().items()}
