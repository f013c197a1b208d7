"""The GBDT training data container (``ytklearn_tpu/gbdt/data.py:GBDTData``).

X is a dense (n, F) float32 matrix with NaN marking a missing value, as a
numpy array or as a torch tensor (which may already lie on the training
device: a generator can make it there and skip the host copy). The text
ingest (`GBDTIngest`) is not ported yet (ROADMAP.md 1.1, `cli train`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

import numpy as np
import torch

Array = Union[np.ndarray, torch.Tensor]


@dataclass
class GBDTData:
    X: Array  # (n, F) f32, NaN = missing until filled
    y: Array  # (n,) f32
    weight: Array  # (n,) f32
    n_real: int
    feature_names: List[str]  # index -> name
    missing_fill: Optional[np.ndarray] = None  # (F,) fill values used

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])


def to_tensor(a: Array, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy array or tensor -> contiguous `dtype` tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype).contiguous()
