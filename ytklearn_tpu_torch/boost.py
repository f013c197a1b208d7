"""The GBST boosting loop, on one device (``ytklearn_tpu/boost.py``;
reference operation/GBMLROperation.java:39-124).

Each tree is one full L-BFGS fit of the soft mixture against the residual
objective (the loss at z + the tree's output), then folded into z with the
learning rate (GBMLRDataFlow.accumulate:540). Before each fit the trainer
draws the tree's Bernoulli instance and feature masks and re-inits the
weights; after it, it dumps the tree and the tree-info file, so the dump
trail is the checkpoint `continue_train` resumes from. gradient_boosting
and random_forest; `loss.just_evaluate` stops after the first fit. The
multi-process streams and the preemption guard come with ROADMAP.md 1.7
and 1.5.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .config.params import CommonParams
from .device import resolve_device
from .eval import EvalSet
from .io.fs import LocalFileSystem
from .io.reader import DataIngest, IngestResult
from .models.gbst import GBSTModel
from .optimize import LBFGSConfig, minimize_lbfgs
from .optimize.blocked import make_rows

log = logging.getLogger("ytklearn_tpu_torch.boost")


@dataclass
class BoostResult:
    n_trees: int
    train_loss: float  # the ensemble's avg loss
    test_loss: Optional[float]
    train_metrics: Dict[str, float] = field(default_factory=dict)
    test_metrics: Dict[str, float] = field(default_factory=dict)
    per_tree_loss: List[float] = field(default_factory=list)  # fit avg
    per_tree_iter: List[int] = field(default_factory=list)
    per_tree_status: List[str] = field(default_factory=list)


def _ensemble_loss(loss_fn, scores, y, weight) -> float:
    per_row = torch.where(weight > 0, loss_fn.loss(scores, y), 0.0)
    return float(torch.sum(weight * per_row))


class GBSTTrainer:
    """Boosted soft-tree trainer of gbmlr, gbsdt, gbhmlr and gbhsdt on
    `device` (cuda by default; it raises without a GPU unless the caller
    passes "cpu")."""

    def __init__(self, params: CommonParams, variant: str, fs=None,
                 transform_hook: Optional[Callable] = None, device=None):
        self.params = params
        self.variant = variant
        self.fs = fs or LocalFileSystem()
        self.transform_hook = transform_hook
        self.device = resolve_device(device)
        self.time_stats: Dict[str, object] = {}

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def train(self, ingest: Optional[IngestResult] = None) -> BoostResult:
        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        if ingest is None:
            ingest = DataIngest(p, fs=self.fs,
                                transform_hook=self.transform_hook).load()
        ts["load"] = time.time() - t0
        ts["parser"] = ingest.parser
        ds, ds_t = ingest.train, ingest.test
        model = GBSTModel(p, ds.dim, self.variant, device=self.device)
        loss_fn = model.loss
        base_score = float(loss_fn.pred2score(p.uniform_base_prediction))
        lr = p.learning_rate
        g_weight = float(np.sum(ds.weight))
        g_weight_test = float(np.sum(ds_t.weight)) if ds_t else 0.0

        idx, val, y, weight = (self._put(a) for a in
                               (ds.idx, ds.val, ds.y, ds.weight))
        # padding rows keep weight 0; z starts at the base score
        z = self._put(np.full((ds.n,), base_score, np.float32))
        if ds_t is not None:
            idx_t, val_t, y_t, weight_t = (self._put(a) for a in
                                           (ds_t.idx, ds_t.val, ds_t.y,
                                            ds_t.weight))
            z_t = self._put(np.full((ds_t.n,), base_score, np.float32))

        width = int(idx.shape[1]) if idx.ndim > 1 else 1
        row_chunk = model.suggest_row_chunk(int(idx.shape[0]), width)
        if row_chunk is not None:
            log.info("blocked evaluation: row chunk %d", row_chunk)
        tree_out = make_rows(model.tree_output, row_chunk,
                             row_mask=(True, True, False))
        eval_set = (EvalSet(p.loss.evaluate_metric)
                    if p.loss.evaluate_metric else None)
        cfg = LBFGSConfig.from_params(p.line_search)
        l1_vec, l2_vec = model.reg_vectors(p.loss.l1[0], p.loss.l2[0])

        # continue_train: replay the finished trees into z (reference
        # GBMLRDataFlow.loadModel and a per-tree accumulate)
        finished = 0
        info = model.load_tree_info(self.fs)
        if (p.model.continue_train or p.loss.just_evaluate) \
                and info is not None:
            finished = int(info["finished_tree_num"])
            full_mask = torch.ones((model.n_features,), dtype=torch.float32,
                                   device=self.device)
            for t in range(finished):
                wt = model.load_tree(self.fs, ingest.feature_map, t)
                if wt is None:
                    raise FileNotFoundError(
                        f"tree-{t:05d} missing for continue_train")
                wt = self._put(wt)
                z = z + lr * tree_out(wt, idx, val, full_mask)
                if ds_t is not None:
                    z_t = z_t + lr * tree_out(wt, idx_t, val_t, full_mask)
            log.info("continue_train: replayed %d finished trees", finished)

        # two numpy streams, the JAX package's single-process draws: the
        # instance stream (process index 0 keeps the seed) and the feature
        # stream
        rng_inst = np.random.RandomState(p.random.seed % (2 ** 32))
        rng_feat = np.random.RandomState(p.random.seed + 104729)
        compensate = 1.0 / p.instance_sample_rate
        out = BoostResult(n_trees=0, train_loss=0.0, test_loss=None)
        tree_secs: List[float] = []
        ts["trees"] = tree_secs

        for tree in range(finished, p.tree_num):
            t_tree = time.time()
            # the tree's Bernoulli masks (reference randomNextSample)
            inst = (rng_inst.rand(ds.n) <= p.instance_sample_rate).astype(
                np.float32)
            inst[ds.n_real:] = 0.0
            gmask_np = (rng_feat.rand(model.n_features)
                        <= p.feature_sample_rate).astype(np.float32)
            if p.model.need_bias:
                gmask_np[0] = 1.0
            gmask = self._put(gmask_np)
            w_eff = self._put(np.asarray(ds.weight) * inst * compensate)
            w0 = self._put(model.init_weights(tree_seed=tree))
            res = minimize_lbfgs(
                model.pure_loss, w0, cfg,
                batch=(idx, val, z, gmask, y, w_eff),
                l1_vec=l1_vec, l2_vec=l2_vec, g_weight=g_weight,
                callback=((lambda it, st: True) if p.loss.just_evaluate
                          else None),
                row_chunk=row_chunk, row_mask=model.batch_row_mask)
            out.per_tree_loss.append(res.loss / g_weight)
            out.per_tree_iter.append(res.n_iter)
            out.per_tree_status.append(res.status)
            if p.loss.just_evaluate:
                break

            # accumulate (reference GBMLRDataFlow.accumulate, lr-shrunk)
            z = z + lr * tree_out(res.w, idx, val, gmask)
            if ds_t is not None:
                z_t = z_t + lr * tree_out(res.w, idx_t, val_t, gmask)
            model.dump_tree(self.fs, res.w.cpu().numpy(), gmask_np,
                            ingest.feature_map, tree)
            model.dump_tree_info(self.fs, tree + 1, base_score)

            tl = _ensemble_loss(loss_fn, self._ensemble(z, tree + 1), y,
                                weight) / g_weight
            msg = (f"[tree={tree}] {time.time() - t0:.1f}s fit avg loss="
                   f"{out.per_tree_loss[-1]:.6f} ensemble avg loss={tl:.6f}")
            if ds_t is not None:
                ttl = _ensemble_loss(loss_fn, self._ensemble(z_t, tree + 1),
                                     y_t, weight_t) / max(g_weight_test,
                                                          1e-12)
                msg += f" test={ttl:.6f}"
            tree_secs.append(time.time() - t_tree)
            log.info(msg)

        out.n_trees = max(p.tree_num - finished, 0) + finished
        n_div = max(out.n_trees, 1)
        ens = self._ensemble(z, n_div)
        out.train_loss = _ensemble_loss(loss_fn, ens, y, weight) / g_weight
        if eval_set is not None:
            out.train_metrics = eval_set.evaluate(loss_fn.predict(ens), y,
                                                  weight)
        if ds_t is not None:
            ens_t = self._ensemble(z_t, n_div)
            out.test_loss = _ensemble_loss(loss_fn, ens_t, y_t, weight_t) \
                / max(g_weight_test, 1e-12)
            if eval_set is not None:
                out.test_metrics = eval_set.evaluate(loss_fn.predict(ens_t),
                                                     y_t, weight_t)
        ts["train"] = time.time() - t0 - ts["load"]
        log.info("boosting done: %d trees, train loss %.6f, metrics %s; "
                 "load %.1fs, train %.1fs", out.n_trees, out.train_loss,
                 out.train_metrics, ts["load"], ts["train"])
        return out

    def _ensemble(self, z, n_trees: int):
        """GB: z is the ensemble score; RF: its average over the trees
        (reference (z) / treeNum at predict time)."""
        if self.params.gbst_type == "random_forest":
            return z / n_trees
        return z
