"""The multiclass linear model (``ytklearn_tpu/models/multiclass.py``;
reference optimizer/MulticlassLinearHoagOptimizer.java:82 and
dataflow/MulticlassLinearModelDataFlow.java): dim = n_features * (K-1),
feature-major with stride K-1; the K-th class's score is 0.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.params import CommonParams
from ..io.reader import SparseDataset
from .base import ConvexModel, gather_rows
from .linear import densify


class MulticlassLinearModel(ConvexModel):
    name = "multiclass_linear"

    def __init__(self, params: CommonParams, n_features: int,
                 dense: Optional[bool] = None, device=None):
        super().__init__(params, n_features, device)
        self.K = int(params.k)
        if not self.loss.is_multiclass:
            raise ValueError("multiclass_linear needs a multiclass loss, "
                             f"got {self.loss.name!r}")
        self.n_labels = self.K
        self.dense = dense if dense is not None else n_features <= 4096

    @property
    def dim(self) -> int:
        return self.n_features * (self.K - 1)

    def layout(self):
        return [("W", 0, self.dim, (self.n_features, self.K - 1))]

    def regular_blocks(self):
        """The bias's K-1 weights are excluded when need_bias."""
        start = (self.K - 1) if self.params.model.need_bias else 0
        return [(start, self.dim)]

    def make_batch(self, ds: SparseDataset) -> Tuple[np.ndarray, ...]:
        if self.dense:
            return (densify(ds, self.n_features), ds.y, ds.weight)
        return (ds.idx, ds.val, ds.y, ds.weight)

    def score_bytes_per_row(self, width: int) -> int:
        return width * max(self.K - 1, 1) * 4

    def scores(self, w, *xargs):
        """(n, K) scores, the last class's fixed at 0."""
        W = w.reshape(self.n_features, self.K - 1)
        if self.dense:
            (X,) = xargs
            s = X @ W
        else:
            idx, val = xargs
            s = torch.einsum("nw,nwk->nk", val, gather_rows(W, idx))
        return torch.cat([s, torch.zeros_like(s[:, :1])], dim=1)

    # -- model text: name,w_0,...,w_{K-2} ---------------------------------

    def model_line(self, name, i, w, precision, is_bias):
        W = np.asarray(w).reshape(self.n_features, self.K - 1)
        d = self.params.model.delim
        return name + d + d.join(repr(float(v)) for v in W[i])

    def apply_model_line(self, w, gidx, info: Sequence[str]):
        W = w.reshape(self.n_features, self.K - 1)
        for j in range(self.K - 1):
            W[gidx, j] = float(info[1 + j])
