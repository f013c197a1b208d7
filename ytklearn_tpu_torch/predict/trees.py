"""The tree families' online predictors (the JAX package's
``predict/trees.py``): GBDT (reference predictor/GBDTOnlinePredictor.java
:55-300) and the four GBST soft-tree variants (reference
predictor/GBMLR|GBSDT|GBHMLR|GBHSDTOnlinePredictor).

GBDT: absent features route to the split's default (missing) child,
matching NaN at train time. Sums are Python floats (f64) added tree by
tree in ascending order: the fold every scoring rung reproduces bit for
bit. GBST: each tree's mixture replayed in numpy float64 over the
transformed features, its leaf id the argmax gate.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np

from ..config.params import GBDTParams
from ..gbdt.tree import GBDTModel
from ..io.fs import LocalFileSystem, is_tmp_path
from ..losses import create_loss
from ..models.gbst import GBST_NAMES
from .base import OnlinePredictor
from .continuous import ContinuousPredictor


class GBDTPredictor(OnlinePredictor):
    """Serves the GBDT text model on feature dicts."""

    def __init__(self, config, fs: Optional[LocalFileSystem] = None):
        super().__init__(config, fs)
        self.params = GBDTParams.from_config(self.config)
        p = self.params
        self.loss = create_loss(p.loss_function, {"sigmoid_zmax": p.sigmoid_zmax})
        self.learn_type = p.gbdt_type
        self._load_model()

    def _load_model(self) -> None:
        path = self.params.model.data_path
        if not self.fs.exists(path):
            raise FileNotFoundError(f"gbdt model doesn't exist: {path}")
        with self.fs.open(path) as f:
            self.model = GBDTModel.loads(f.read())
        self.K = self.model.num_tree_in_group
        self.n_outputs = self.K
        # use_round_num: serve only the first N rounds if configured smaller
        # (reference: GBDTOnlinePredictor.useRoundNum)
        rounds = len(self.model.trees) // max(self.K, 1)
        conf_rounds = self.params.round_num
        self.use_rounds = min(rounds, conf_rounds) if conf_rounds > 0 else rounds

    def _tree_walk(self, tree, features: Dict[str, float]) -> int:
        nid = 0
        while not tree.is_leaf(nid):
            v = features.get(tree.feat_name[nid])
            if v is None or (isinstance(v, float) and math.isnan(v)):
                go_left = tree.default_left[nid]
            else:
                go_left = v <= tree.split[nid]
            nid = tree.left[nid] if go_left else tree.right[nid]
        return nid

    def score(self, features) -> float:
        if self.K > 1:
            raise ValueError("multiclass gbdt: use scores()")
        s = 0.0
        for i in range(self.use_rounds):
            t = self.model.trees[i]
            s += t.leaf_value[self._tree_walk(t, features)]
        if self.learn_type == "random_forest":
            s /= max(self.use_rounds, 1)
        return s + self.model.base_prediction

    def scores(self, features) -> List[float]:
        if self.K == 1:
            return [self.score(features)]
        s = [0.0] * self.K
        for i in range(self.use_rounds * self.K):
            t = self.model.trees[i]
            s[i % self.K] += t.leaf_value[self._tree_walk(t, features)]
        if self.learn_type == "random_forest":
            s = [v / max(self.use_rounds, 1) for v in s]
        return [v + self.model.base_prediction for v in s]

    def predict_leaf(self, features: Dict[str, float]) -> List[int]:
        """Leaf node id per tree (reference: GBDTOnlinePredictor.predictLeaf:258)."""
        return [
            self._tree_walk(t, features)
            for t in self.model.trees[: self.use_rounds * self.K]
        ]


class GBSTPredictor(ContinuousPredictor):
    """gbmlr / gbsdt / gbhmlr / gbhsdt: score = base + lr sum_t fx_t(x)
    (gradient_boosting) or that sum over the trees (random_forest); fx_t
    is the tree's softmax- or heap-sigmoid-gated mixture of per-feature
    linear experts (gbmlr, gbhmlr) or scalar leaves (gbsdt, gbhsdt).
    predict_leaf returns each tree's argmax gate (reference
    GBMLROnlinePredictor.predictLeaf). The text parser is its own, apart
    from GBSTModel.load_tree, as in the reference."""

    def __init__(self, variant: str, config, fs=None):
        if variant not in GBST_NAMES:
            raise ValueError(f"unknown GBST variant {variant!r}")
        self.variant = variant
        self.hier = variant in ("gbhmlr", "gbhsdt")
        self.scalar_leaves = variant in ("gbsdt", "gbhsdt")
        super().__init__(config, fs)

    def _load_model(self) -> None:
        p = self.params
        K = self.K = int(p.k)
        self.is_rf = p.gbst_type == "random_forest"
        self.lr = float(p.learning_rate)
        self.base_score = float(self.loss.pred2score(
            p.uniform_base_prediction))
        self.n_trees = int(p.tree_num)
        info_path = f"{p.model.data_path}/tree-info"
        if self.fs.exists(info_path):
            with self.fs.open(info_path) as f:
                for line in f:
                    if ":" not in line:
                        continue
                    k, v = line.strip().split(":", 1)
                    if k == "finished_tree_num":
                        self.n_trees = int(float(v))
                    elif k == "uniform_base_prediction":
                        self.base_score = float(v)
        self.stride = (K - 1) if self.scalar_leaves else (2 * K - 1)
        self.leaves: List[np.ndarray] = []  # the gbsdt family's leaves
        self.tree_maps: List[Dict[str, np.ndarray]] = []  # name -> weights
        d = p.model.delim
        for t in range(self.n_trees):
            tree_dir = f"{p.model.data_path}/tree-{t:05d}"
            if not self.fs.exists(tree_dir):
                self.n_trees = t
                break
            tmap: Dict[str, np.ndarray] = {}
            leaf_vals = None
            for part in sorted(self.fs.recur_get_paths([tree_dir])):
                if is_tmp_path(part):
                    continue  # an atomic writer's temp file
                with self.fs.open(part) as f:
                    expect_leaves = False
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        if line.startswith("k:"):
                            expect_leaves = self.scalar_leaves
                            continue
                        info = [s for s in line.split(d) if s != ""]
                        if expect_leaves:
                            leaf_vals = np.asarray(
                                [float(v) for v in info[:K]], np.float64)
                            expect_leaves = False
                            continue
                        tmap[info[0]] = np.asarray(
                            [float(v) for v in info[1:1 + self.stride]],
                            np.float64)
            self.tree_maps.append(tmap)
            self.leaves.append(leaf_vals if leaf_vals is not None
                               else np.zeros(K, np.float64))

    def _gate_probs(self, gate_in: np.ndarray) -> np.ndarray:
        """The numpy twin of GBSTModel._gate_probs for one row."""
        if self.hier:
            sig = 1.0 / (1.0 + np.exp(-gate_in))  # (K-1,) heap order
            level = np.ones(1, np.float64)
            for _ in range(int(math.log2(self.K))):
                n = len(level)
                gates = sig[n - 1:2 * n - 1]
                level = np.stack([level * gates, level * (1.0 - gates)],
                                 axis=-1).reshape(-1)
            return level
        z = np.concatenate([gate_in, [0.0]])
        e = np.exp(z - z.max())
        return e / e.sum()

    def _tree_fx_and_leaf(self, t: int, feats) -> tuple:
        """One tree's (fx, argmax leaf); feats [(name, value)] with the
        bias pseudo-feature when configured."""
        K = self.K
        tmap = self.tree_maps[t]
        gate_in = np.zeros(K - 1, np.float64)
        if self.scalar_leaves:
            experts = self.leaves[t]
            for name, val in feats:
                w = tmap.get(name)
                if w is not None:
                    gate_in += w * val
        else:
            experts = np.zeros(K, np.float64)
            for name, val in feats:
                w = tmap.get(name)
                if w is not None:
                    gate_in += w[:K - 1] * val
                    experts += w[K - 1:] * val
        pi = self._gate_probs(gate_in)
        return float(np.dot(pi, experts)), int(np.argmax(pi))

    def _feats_with_bias(self, features) -> list:
        feats = self._prep(features)
        p = self.params.model
        if p.need_bias:
            feats.append((p.bias_feature_name, 1.0))
        return feats

    def score(self, features) -> float:
        feats = self._feats_with_bias(features)
        z = self.base_score
        for t in range(self.n_trees):
            z += self.lr * self._tree_fx_and_leaf(t, feats)[0]
        if self.is_rf:
            z /= max(self.n_trees, 1)
        return z

    def predict_leaf(self, features) -> List[int]:
        feats = self._feats_with_bias(features)
        return [self._tree_fx_and_leaf(t, feats)[1]
                for t in range(self.n_trees)]
