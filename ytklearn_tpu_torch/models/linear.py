"""The linear family (``ytklearn_tpu/models/linear.py``; reference
optimizer/LinearHoagOptimizer.java:76-209 and
dataflow/LinearModelDataFlow.java:68-199).

Two layouts, chosen by the dimension as in the reference:
  dense   X (n, dim) f32 and scores X @ w, for dim <= 4096
  sparse  padded ELL idx/val (n, width) and scores sum_j val * w[idx]
score = x . w with the bias folded in as feature 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config.params import CommonParams
from ..io.reader import SparseDataset
from .base import ConvexModel, gather_rows


def ell_scores(w, idx, val):
    """x . w of padded ELL rows (reference: LinearHoagOptimizer.Xv:76-87);
    padding slots (idx 0, val 0) add nothing."""
    return torch.sum(val * gather_rows(w, idx), dim=-1)


def densify(ds: SparseDataset, n_cols: int) -> np.ndarray:
    """(n, n_cols) f32 from the ELL rows; the slots are written in reverse
    so a trailing padding slot (0, 0.0) cannot overwrite the bias."""
    X = np.zeros((ds.n, n_cols), np.float32)
    X[np.arange(ds.n)[:, None], ds.idx[:, ::-1]] = ds.val[:, ::-1]
    return X


class LinearModel(ConvexModel):
    name = "linear"

    def __init__(self, params: CommonParams, dim: int,
                 dense: Optional[bool] = None, device=None):
        super().__init__(params, dim, device)
        self.dense = dense if dense is not None else dim <= 4096

    @property
    def dim(self) -> int:
        return self.n_features

    def layout(self):
        return [("w", 0, self.dim, (self.dim,))]

    def regular_range(self) -> Tuple[int, int]:
        """L1/L2 apply to [start, dim): the bias is excluded
        (reference: LinearHoagOptimizer.getRegularStart/End)."""
        return (1 if self.params.model.need_bias else 0), self.dim

    def regular_blocks(self):
        return [self.regular_range()]

    def make_batch(self, ds: SparseDataset) -> Tuple[np.ndarray, ...]:
        if self.dense:
            return (densify(ds, self.dim), ds.y, ds.weight)
        return (ds.idx, ds.val, ds.y, ds.weight)

    def scores(self, w, *xargs):
        if self.dense:
            (X,) = xargs
            return X @ w
        idx, val = xargs
        return ell_scores(w, idx, val)

    def precision(self, w, *batch, l2_vec, g_weight):
        """Laplace diagonal precision for Thompson sampling (reference:
        LinearHoagOptimizer.calPrecision:179): sum_i weight_i D_i x_ij^2,
        the bias slot 0, plus g_weight * l2."""
        *xargs, y, weight = batch
        D = self.loss.second_derivative(self.scores(w, *xargs), y)
        if self.dense:
            (X,) = xargs
            prec = (weight * D) @ (X * X)
            if self.params.model.need_bias:
                prec[0] = 0.0
        else:
            idx, val = xargs
            contrib = (weight * D)[:, None] * (val * val)
            if self.params.model.need_bias:
                contrib = torch.where(idx == 0, 0.0, contrib)
            prec = torch.zeros((self.dim,), dtype=w.dtype, device=w.device)
            prec.index_put_((idx.reshape(-1).long(),), contrib.reshape(-1),
                            accumulate=True)
        return prec + g_weight * l2_vec

    # -- model text ------------------------------------------------------

    def dump_model(self, fs, w: np.ndarray, precision: Optional[np.ndarray],
                   feature_map: Dict[str, int], rank: int = 0,
                   n_parts: int = 1) -> None:
        """`name,w,precision` a nonzero weight, the bias always with
        precision `null` (reference: LinearModelDataFlow.dumpModel:
        133-199)."""
        p = self.params.model
        w = np.asarray(w)
        start, end = self._feature_slice(rank, n_parts)
        d = p.delim
        model_lines = []
        dict_lines = []
        for name, i in feature_map.items():
            if not (start <= i < end):
                continue
            if name.lower() == p.bias_feature_name.lower():
                model_lines.append(f"{name}{d}{w[i]:f}{d}null\n")
                continue
            if abs(w[i]) <= 0.0:
                continue
            prec = precision[i] if precision is not None else 0.0
            model_lines.append(f"{name}{d}{w[i]:f}{d}{prec:f}\n")
            dict_lines.append(f"{name}\n")
        model_path, dict_path = self._part_paths(rank)
        self._write(fs, model_path, dict_path, model_lines, dict_lines,
                    rank, n_parts)

    def apply_model_line(self, w, gidx, info):
        w[gidx] = float(info[1])
