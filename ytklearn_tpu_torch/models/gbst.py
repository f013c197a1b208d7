"""Gradient-boosted soft trees: gbmlr, gbsdt, gbhmlr, gbhsdt
(``ytklearn_tpu/models/gbst.py``; reference optimizer/GBMLRHoagOptimizer
.java:130, GBSDTHoagOptimizer.java:135, GBHMLRHoagOptimizer.java:136,
GBHSDTHoagOptimizer.java:142 and dataflow/GBMLRDataFlow.java).

One tree is a soft mixture of K experts, gated by a softmax over
[K-1 logits, 0] (gbmlr, gbsdt) or by a complete binary tree of sigmoids in
heap order (gbhmlr, gbhsdt: a leaf's probability is the product of the
gates on its root path). The experts are per-feature linear functions
(gbmlr, gbhmlr: 2K-1 weights a feature, K-1 gates then K experts) or K
global scalars (gbsdt, gbhsdt: dim = K + n_features * (K-1)).

    fx = z + sum_p pi_p(x) expert_p(x)   (z: the earlier trees; RF: 0)

The per-feature gate mask multiplies the gate weights inside the score, so
a masked feature neither gates nor gets a gradient (the reference's
g[i] = 0). Autograd gives the gradient; the (rows, width, stride) weight
gather is an embedding lookup (`gather_rows`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..config.params import CommonParams
from ..io.fs import is_tmp_path
from .base import ConvexModel, gather_rows

GBST_NAMES = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")


def heap_leaf_probs(sig: torch.Tensor) -> torch.Tensor:
    """(..., K-1) heap-ordered sigmoid gates -> (..., K) leaf
    probabilities; a gate is P(left child) (reference: the mu/gx loop of
    GBHMLRHoagOptimizer, loss/HSoftmaxFunction.java's heap)."""
    K = sig.shape[-1] + 1
    lead = sig.shape[:-1]
    level = torch.ones(lead + (1,), dtype=sig.dtype, device=sig.device)
    for _ in range(int(math.log2(K))):
        n = level.shape[-1]
        gates = sig[..., n - 1:2 * n - 1]
        level = torch.stack([level * gates, level * (1.0 - gates)],
                            dim=-1).reshape(lead + (2 * n,))
    return level


class GBSTModel(ConvexModel):
    """The four GBST variants; `variant` picks the layout and the gating."""

    #: the trainer's batch (idx, val, z, gate_mask, y, weight): the gate
    #: mask is per feature, not per row
    batch_row_mask = (True, True, True, False, True, True)

    def __init__(self, params: CommonParams, n_features: int, variant: str,
                 device=None):
        super().__init__(params, n_features, device)
        if variant not in GBST_NAMES:
            raise ValueError(f"unknown GBST variant {variant!r}")
        self.variant = self.name = variant
        self.K = int(params.k)
        self.hier = variant in ("gbhmlr", "gbhsdt")
        self.scalar_leaves = variant in ("gbsdt", "gbhsdt")
        if self.hier and (self.K & (self.K - 1)) != 0:
            raise ValueError(f"{variant} requires K a power of two, got "
                             f"{self.K}")
        self.is_rf = params.gbst_type == "random_forest"
        self.stride = self.K - 1 if self.scalar_leaves else 2 * self.K - 1

    # -- layout ----------------------------------------------------------

    @property
    def dim(self) -> int:
        lead = self.K if self.scalar_leaves else 0
        return lead + self.n_features * self.stride

    def layout(self):
        if self.scalar_leaves:
            return [("leaves", 0, self.K, (self.K,)),
                    ("gates", self.K, self.dim,
                     (self.n_features, self.stride))]
        return [("W", 0, self.dim, (self.n_features, self.stride))]

    def regular_blocks(self):
        """The leaves and the gates without the bias's (gbsdt family), or
        every feature's block but the bias's (reference:
        GBSDTHoagOptimizer/GBMLRHoagOptimizer.getRegularStart/End)."""
        K = self.K
        bias = self.params.model.need_bias
        if self.scalar_leaves:
            return [(0, K), ((2 * K - 1) if bias else K, self.dim)]
        return [((2 * K - 1) if bias else 0, self.dim)]

    def init_weights(self, tree_seed: int = 0) -> np.ndarray:
        """A tree's random init from RandomState(random.seed + tree), the
        JAX package's draws (reference GBMLRDataFlow.initW /
        GBSDTDataFlow.initW): the bias's block zeroed, gbsdt-family leaves
        uniform in leaf_random_init_range."""
        p = self.params
        K = self.K
        r = p.random
        rng = np.random.RandomState(r.seed + tree_seed)
        if r.mode == "uniform":
            w = rng.uniform(r.uniform_range_start, r.uniform_range_end,
                            self.dim).astype(np.float32)
        else:
            w = (rng.randn(self.dim) * r.normal_std
                 + r.normal_mean).astype(np.float32)
        if self.scalar_leaves:
            lo, hi = p.leaf_random_init_range
            w[:K] = rng.uniform(lo, hi, K).astype(np.float32)
            if p.model.need_bias:
                w[K:2 * K - 1] = 0.0  # the bias's gates
        elif p.model.need_bias:
            w[:2 * K - 1] = 0.0  # the bias's whole block
        return w

    def score_bytes_per_row(self, width: int) -> int:
        """The (width, stride) weight gather of a row."""
        return width * self.stride * 4

    # -- math ------------------------------------------------------------

    def tree_output(self, w, idx, val, gate_mask):
        """One tree's output (without z); gate_mask (n_features,) f32."""
        K = self.K
        gv = val * gather_rows(gate_mask, idx)  # (n, width)
        if self.scalar_leaves:
            U = gather_rows(w[K:].reshape(self.n_features, K - 1), idx)
            pi = self._gate_probs(torch.einsum("nw,nwk->nk", gv, U))
            return pi @ w[:K]
        Wr = gather_rows(w.reshape(self.n_features, self.stride), idx)
        gate_in = torch.einsum("nw,nwk->nk", gv, Wr[..., :K - 1])
        experts = torch.einsum("nw,nwk->nk", val, Wr[..., K - 1:])
        return torch.sum(self._gate_probs(gate_in) * experts, dim=-1)

    def _gate_probs(self, gate_in):
        """(n, K-1) gate logits -> (n, K) mixture probabilities: the heap
        product of sigmoids, or a softmax over [logits, 0] (the reference
        appends an implicit 0)."""
        if self.hier:
            return heap_leaf_probs(torch.sigmoid(gate_in))
        z = torch.cat([gate_in, torch.zeros_like(gate_in[:, :1])], dim=1)
        return torch.softmax(z, dim=-1)

    def scores(self, w, *xargs):
        idx, val, z, gate_mask = xargs
        fx = self.tree_output(w, idx, val, gate_mask)
        # GB: the loss at z + tree; RF: the tree alone
        return fx if self.is_rf else z + fx

    def rf_predict_scores(self, w, idx, val, z, gate_mask, tree_num):
        """RF: the averaged ensemble score (reference (z + fx) / treeNum)."""
        return (z + self.tree_output(w, idx, val, gate_mask)) / tree_num

    # -- model text, a tree at a time --------------------------------------
    # reference GBMLRDataFlow.dumpModel: tree-%05d/model-%05d with a "k:K"
    # line, then `name,v0,...,v_{stride-1},` a feature (a trailing delim),
    # masked gates written as 0.0; the gbsdt family's leaf line follows k:

    def dump_tree(self, fs, w: np.ndarray, gate_mask: np.ndarray,
                  feature_map: Dict[str, int], tree_id: int,
                  rank: int = 0) -> None:
        p = self.params.model
        K, S, d = self.K, self.stride, p.delim
        w = np.asarray(w)
        off = K if self.scalar_leaves else 0
        path = f"{p.data_path}/tree-{tree_id:05d}/model-{rank:05d}"
        dict_path = f"{p.data_path}_dict/dict-{rank:05d}"
        with fs.atomic_open(path) as mf, fs.atomic_open(dict_path) as df:
            mf.write(f"k:{K}\n")
            if self.scalar_leaves:
                mf.write(d.join(repr(float(v)) for v in w[:K]) + "\n")
            for name, i in feature_map.items():
                is_bias = name.lower() == p.bias_feature_name.lower()
                vals = list(w[off + i * S:off + (i + 1) * S])
                if not is_bias and gate_mask[i] == 0:
                    vals[:K - 1] = [0.0] * (K - 1)
                mf.write(name + d + d.join(repr(float(v)) for v in vals)
                         + d + "\n")
                if not is_bias:
                    df.write(name + "\n")

    def load_tree(self, fs, feature_map: Dict[str, int],
                  tree_id: int) -> Optional[np.ndarray]:
        p = self.params.model
        K, S = self.K, self.stride
        off = K if self.scalar_leaves else 0
        tree_dir = f"{p.data_path}/tree-{tree_id:05d}"
        if not fs.exists(tree_dir):
            return None
        w = np.zeros((self.dim,), np.float32)
        for path in sorted(fs.recur_get_paths([tree_dir])):
            if is_tmp_path(path):
                continue  # an atomic writer's temp file
            with fs.open(path) as f:
                expect_leaves = False
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    if line.startswith("k:"):
                        expect_leaves = self.scalar_leaves
                        continue
                    info = [s for s in line.split(p.delim) if s != ""]
                    if expect_leaves:
                        w[:K] = [float(v) for v in info[:K]]
                        expect_leaves = False
                        continue
                    gidx = feature_map.get(info[0])
                    if gidx is not None:
                        start = off + gidx * S
                        w[start:start + S] = [float(v)
                                              for v in info[1:1 + S]]
        return w

    def dump_tree_info(self, fs, finished: int, base_score: float) -> None:
        """reference GBMLRDataFlow.dumpModelInfo."""
        p = self.params
        with fs.atomic_open(f"{p.model.data_path}/tree-info") as f:
            f.write(f"K:{self.K}\n")
            f.write(f"tree_num:{p.tree_num}\n")
            f.write(f"finished_tree_num:{finished}\n")
            f.write(f"uniform_base_prediction:{base_score}\n")

    def load_tree_info(self, fs) -> Optional[Dict[str, float]]:
        path = f"{self.params.model.data_path}/tree-info"
        if not fs.exists(path):
            return None
        out: Dict[str, float] = {}
        with fs.open(path) as f:
            for line in f:
                if ":" in line:
                    k, v = line.strip().split(":", 1)
                    out[k] = float(v)
        return out
