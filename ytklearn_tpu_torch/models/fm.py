"""The factorization machine (``ytklearn_tpu/models/fm.py``; reference
optimizer/FMHoagOptimizer.java:88 and dataflow/FMModelDataFlow.java).

Layout [w1 (n_features)] ++ [V (n_features, k)], V drawn by `random_init`
with the bias's latent row zeroed; model text `name,w,v1,...,vk`.

fx = x . w1 + 0.5 sum_f [(sum_j v_jf x_j)^2 - sum_j (v_jf x_j)^2]; autograd
gives the reference's closed-form gradient. The first/second-order
switches and the bias latent are masks on the weights inside the score:
masked slots start at 0 and get a zero gradient, the reference's g[i] = 0.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..config.params import CommonParams
from .base import ConvexModel, gather_rows, random_init


def parse_k(k):
    """`k = [first_order (0/1), latent dim]` -> (need_first_order, dim)."""
    if not (isinstance(k, (list, tuple)) and len(k) == 2):
        raise ValueError("fm/ffm config k must be [first_order(0/1), "
                         f"latent_dim]: {k!r}")
    return int(k[0]) >= 1, int(k[1])


def masked(model, w, latent_bias: int):
    """`w` with the masked slots zeroed: the first order when it is off,
    the latent block when the second order is off, else the bias's
    `latent_bias` latent weights unless bias_need_latent_factor."""
    p = model.params
    zero = []
    if not model.need_first_order:
        zero.append((1 if p.model.need_bias else 0, model.v_start))
    if not model.need_second_order:
        zero.append((model.v_start, model.dim))
    elif p.model.need_bias and not p.bias_need_latent_factor:
        zero.append((model.v_start, model.v_start + latent_bias))
    if not zero:
        return w
    w = w.clone()
    for s, e in zero:
        w[s:e] = 0.0
    return w


class FMModel(ConvexModel):
    name = "fm"

    def __init__(self, params: CommonParams, n_features: int, device=None):
        super().__init__(params, n_features, device)
        self.need_first_order, self.sok = parse_k(params.k)
        self.need_second_order = self.sok > 0
        self.v_start = n_features

    @property
    def dim(self) -> int:
        return self.n_features * (1 + self.sok)

    def layout(self):
        return [("w1", 0, self.v_start, (self.n_features,)),
                ("V", self.v_start, self.dim, (self.n_features, self.sok))]

    def regular_blocks(self):
        """The first order (bias excluded) and the latent block
        (reference: FMHoagOptimizer.getRegularStart/End)."""
        fo_start = 1 if self.params.model.need_bias else 0
        return [(fo_start, self.v_start), (self.v_start, self.dim)]

    def init_weights(self) -> np.ndarray:
        w = np.zeros((self.dim,), np.float32)
        w[self.v_start:] = random_init(self.params, self.dim - self.v_start)
        if self.params.model.need_bias:
            w[self.v_start:self.v_start + self.sok] = 0.0  # bias latent
        return w

    def score_bytes_per_row(self, width: int) -> int:
        """The (width, k) latent gather and its products."""
        return max(self.sok, 1) * width * 4

    def scores(self, w, *xargs):
        idx, val = xargs
        w = masked(self, w, self.sok)
        wx = torch.sum(val * gather_rows(w[:self.v_start], idx), dim=-1)
        if not self.need_second_order:
            return wx
        V = w[self.v_start:].reshape(self.n_features, self.sok)
        vx = gather_rows(V, idx) * val[..., None]  # (n, width, k)
        S = torch.sum(vx, dim=1)  # sum v x        (n, k)
        S2 = torch.sum(vx * vx, dim=1)  # sum (v x)^2  (n, k)
        return wx + 0.5 * torch.sum(S * S - S2, dim=-1)

    # -- model text: name,w,v1,...,vk --------------------------------------

    def model_line(self, name, i, w, precision, is_bias):
        w = np.asarray(w)
        d = self.params.model.delim
        V = w[self.v_start:].reshape(self.n_features, self.sok)
        lat = d.join(repr(float(v)) for v in V[i])
        return f"{name}{d}{w[i]:f}{d}{lat}"

    def apply_model_line(self, w, gidx, info: Sequence[str]):
        w[gidx] = float(info[1])
        start = self.v_start + gidx * self.sok
        for f in range(self.sok):
            w[start + f] = float(info[2 + f])
