"""GBDT online predictor (reference: predictor/GBDTOnlinePredictor.java
:55-300; the JAX package's ``predict/trees.py::GBDTPredictor``).

Absent features route to the split's default (missing) child, matching NaN
at train time. Sums are Python floats (f64) added tree by tree in
ascending order: the fold every scoring rung reproduces bit for bit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

from ..config.params import GBDTParams
from ..gbdt.tree import GBDTModel
from ..io.fs import LocalFileSystem
from ..losses import create_loss
from .base import OnlinePredictor


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
