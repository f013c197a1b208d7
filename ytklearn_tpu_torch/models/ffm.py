"""The field-aware factorization machine (``ytklearn_tpu/models/ffm.py``;
reference optimizer/FFMHoagOptimizer.java:90 and
dataflow/FFMModelDataFlow.java): dim = n + n * F * k, V[feature, field, :];
a row holds (feature, value, field) triples, a feature's field being its
name's prefix before field_delim, through model.field_dict_path.

The pairwise terms are summed per field pair, as the reference package
does:
    T[a, b, :] = sum_{p: field_p = a} val_p V[feat_p, b, :]    (n, F, F, k)
    fx = x . w1 + 0.5 (sum_{a,b} T[a,b] . T[b,a]
                       - sum_p val_p^2 |V[feat_p, field_p]|^2)
with two einsums; the second term takes out the p = q diagonal.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from ..config.params import CommonParams
from ..io.reader import SparseDataset
from .base import ConvexModel, gather_rows, random_init
from .fm import masked, parse_k


def load_field_dict(fs, path: str) -> Dict[str, int]:
    """field name -> index in the file's line order (reference:
    FFMModelDataFlow.java:234-241)."""
    fmap: Dict[str, int] = {}
    with fs.open(path) as f:
        for line in f:
            name = line.strip()
            if name and name not in fmap:
                fmap[name] = len(fmap)
    return fmap


class FFMModel(ConvexModel):
    name = "ffm"

    def __init__(self, params: CommonParams, n_features: int, n_fields: int,
                 device=None):
        super().__init__(params, n_features, device)
        self.need_first_order, self.sok = parse_k(params.k)
        self.need_second_order = self.sok > 0
        self.n_fields = n_fields
        self.v_start = n_features

    @property
    def dim(self) -> int:
        return self.n_features * (1 + self.n_fields * self.sok)

    def layout(self):
        return [("w1", 0, self.v_start, (self.n_features,)),
                ("V", self.v_start, self.dim,
                 (self.n_features, self.n_fields, self.sok))]

    def regular_blocks(self):
        fo_start = 1 if self.params.model.need_bias else 0
        return [(fo_start, self.v_start), (self.v_start, self.dim)]

    def init_weights(self) -> np.ndarray:
        w = np.zeros((self.dim,), np.float32)
        w[self.v_start:] = random_init(self.params, self.dim - self.v_start)
        if self.params.model.need_bias:
            w[self.v_start:self.v_start + self.n_fields * self.sok] = 0.0
        return w

    def make_batch(self, ds: SparseDataset) -> Tuple[np.ndarray, ...]:
        if ds.field is None:
            raise ValueError("FFM requires a dataset ingested with a field "
                             "map")
        return (ds.idx, ds.val, ds.field, ds.y, ds.weight)

    def score_bytes_per_row(self, width: int) -> int:
        """The (width, F, k) latent gather and the (F, F, k) field-pair
        tensor."""
        F = self.n_fields
        return (width * F + F * F) * max(self.sok, 1) * 4

    def scores(self, w, *xargs):
        idx, val, field = xargs
        w = masked(self, w, self.n_fields * self.sok)
        wx = torch.sum(val * gather_rows(w[:self.v_start], idx), dim=-1)
        if not self.need_second_order:
            return wx
        F, k = self.n_fields, self.sok
        Vr = gather_rows(w[self.v_start:].reshape(self.n_features, F * k),
                         idx).reshape(idx.shape + (F, k))
        onehot = (field[..., None] == torch.arange(F, device=field.device)
                  ).to(val.dtype)  # (n, width, F)
        T = torch.einsum("nwa,nwbk->nabk", onehot * val[..., None], Vr)
        cross = torch.einsum("nabk,nbak->n", T, T)
        own = torch.take_along_dim(
            Vr, field[..., None, None].long(), dim=2)[:, :, 0, :]
        diag = torch.sum((val * val) * torch.sum(own * own, dim=-1), dim=-1)
        return wx + 0.5 * (cross - diag)

    # -- model text: name,w,v[field 0: k ...],v[field 1: k ...],... --------

    def model_line(self, name, i, w, precision, is_bias):
        w = np.asarray(w)
        d = self.params.model.delim
        stride = self.n_fields * self.sok
        lat = w[self.v_start + i * stride:self.v_start + (i + 1) * stride]
        return f"{name}{d}{w[i]:f}{d}" + d.join(repr(float(v)) for v in lat)

    def apply_model_line(self, w, gidx, info: Sequence[str]):
        w[gidx] = float(info[1])
        stride = self.n_fields * self.sok
        start = self.v_start + gidx * stride
        for f in range(min(stride, len(info) - 2)):
            w[start + f] = float(info[2 + f])
