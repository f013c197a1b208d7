"""The GBST boosting loop, on one device or on the ranks of a mesh
(``ytklearn_tpu/boost.py``; reference operation/GBMLROperation.java:
39-124).

Each tree is one full L-BFGS fit of the soft mixture against the residual
objective (the loss at z + the tree's output), then folded into z with the
learning rate (GBMLRDataFlow.accumulate:540). Before each fit the trainer
draws the tree's Bernoulli instance and feature masks and re-inits the
weights; after it, it dumps the tree and the tree-info file, so the dump
trail is the checkpoint `continue_train` resumes from. gradient_boosting
and random_forest; `loss.just_evaluate` stops after the first fit.
`train()` runs under the preemption guard (resilience/preempt.py): a
SIGTERM or SIGINT is deferred to the next tree boundary, where every
finished tree is on disk already, and `Preempted` is raised; the relaunch
(`--resume auto`) continues at the last finished tree and ends with the
uninterrupted run's trees. The obs spans are the convex trainer's:
`train.load` (the ingest), one `train.round` a tree fit (with the L-BFGS
phases and spans inside) and `train.evaluate`, with the `mem.train.load.*`
and `mem.train.train.*` gauges.

With `mesh` (parallel/mesh.py) the weights and the gate mask are
replicated and the rows sharded, padded with weight-0 rows, as in
train.py: every fit's loss and gradient, the ensemble losses and the
metrics are the ranks' sums psummed; the tree-info and the trees of a
warm start are process 0's reads; only rank 0 dumps. The instance stream
draws over the rows of one ingest (`--devices`: every rank draws the
global vector and keeps its block, as the reference's one-process mesh)
or over a process's own rows from seed + 7919 x its index
(`--coordinator`, the reference's multi-process stream).
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
from .obs import health, span as obs_span
from .parallel import collectives as coll
from .parallel.mesh import process_count, process_index
from .resilience import trainer_guard

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


def _ensemble_loss(loss_fn, scores, y, weight, mesh=None) -> float:
    per_row = torch.where(weight > 0, loss_fn.loss(scores, y), 0.0)
    s = torch.sum(weight * per_row)
    return float(s if mesh is None else coll.psum(s, mesh))


class GBSTTrainer:
    """Boosted soft-tree trainer of gbmlr, gbsdt, gbhmlr and gbhsdt on
    `device` (cuda by default; it raises without a GPU unless the caller
    passes "cpu"), or on this rank's device of `mesh`."""

    def __init__(self, params: CommonParams, variant: str, fs=None,
                 transform_hook: Optional[Callable] = None, device=None,
                 mesh=None):
        self.params = params
        self.variant = variant
        self.fs = fs or LocalFileSystem()
        self.transform_hook = transform_hook
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self.time_stats: Dict[str, object] = {}

    def _put(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _preempt_now(self) -> bool:
        hit = self._guard is not None and self._guard.triggered
        return hit if self.mesh is None else coll.any_rank(hit, self.mesh)

    def _rows(self, ds):
        """(this rank's rows, the length of the instance stream's draw,
        where the rank's rows start in it)."""
        mesh = self.mesh
        if mesh is None:
            return ds, ds.n, 0
        loc = ds.shard(mesh)
        if mesh.shared_ingest:
            return loc, loc.n * mesh.world, mesh.rank * loc.n
        return loc, loc.n, 0

    _guard = None  # PreemptionGuard while train() runs

    def train(self, ingest: Optional[IngestResult] = None) -> BoostResult:
        with trainer_guard(self):
            return self._train(ingest)

    def _train(self, ingest: Optional[IngestResult]) -> BoostResult:
        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        health.install_trace_counters()
        if ingest is None:
            with obs_span("train.load", model=self.variant):
                ingest = DataIngest(p, fs=self.fs,
                                    transform_hook=self.transform_hook).load()
        ts["load"] = time.time() - t0
        health.record_memory("train.load")
        ts["parser"] = ingest.parser
        ds, ds_t = ingest.train, ingest.test
        mesh = self.mesh
        model = GBSTModel(p, ds.dim, self.variant, device=self.device)
        loss_fn = model.loss
        base_score = float(loss_fn.pred2score(p.uniform_base_prediction))
        lr = p.learning_rate
        g_weight = float(np.sum(ds.weight))
        g_weight_test = float(np.sum(ds_t.weight)) if ds_t else 0.0
        if process_count() > 1:
            g_weight = float(sum(coll.host_allgather_objects(g_weight)))
            g_weight_test = float(sum(coll.host_allgather_objects(
                g_weight_test)))
        loc, n_draw, lo = self._rows(ds)
        loc_t = self._rows(ds_t)[0] if ds_t is not None else None

        idx, val, y, weight = (self._put(a) for a in
                               (loc.idx, loc.val, loc.y, loc.weight))
        # padding rows keep weight 0; z starts at the base score
        z = self._put(np.full((loc.n,), base_score, np.float32))
        if loc_t is not None:
            idx_t, val_t, y_t, weight_t = (self._put(a) for a in
                                           (loc_t.idx, loc_t.val, loc_t.y,
                                            loc_t.weight))
            z_t = self._put(np.full((loc_t.n,), base_score, np.float32))

        width = int(idx.shape[1]) if idx.ndim > 1 else 1
        shards = mesh.world if mesh is not None else 1
        row_chunk = model.suggest_row_chunk(int(idx.shape[0]) * shards,
                                            width, n_shards=shards)
        if row_chunk is not None:
            log.info("blocked evaluation: row chunk %d", row_chunk)
        tree_out = make_rows(model.tree_output, row_chunk,
                             row_mask=(True, True, False), mesh=mesh)
        eval_set = (EvalSet(p.loss.evaluate_metric)
                    if p.loss.evaluate_metric else None)
        cfg = LBFGSConfig.from_params(p.line_search)
        l1_vec, l2_vec = model.reg_vectors(p.loss.l1[0], p.loss.l2[0])

        # continue_train: replay the finished trees into z (reference
        # GBMLRDataFlow.loadModel and a per-tree accumulate); process 0
        # reads the dumps (only rank 0 writes them)
        finished = 0
        info = coll.load_on_rank0(lambda: model.load_tree_info(self.fs))
        if (p.model.continue_train or p.loss.just_evaluate) \
                and info is not None:
            finished = int(info["finished_tree_num"])
            full_mask = torch.ones((model.n_features,), dtype=torch.float32,
                                   device=self.device)
            trees_w = coll.load_on_rank0(lambda: [
                model.load_tree(self.fs, ingest.feature_map, t)
                for t in range(finished)])
            for t, wt in enumerate(trees_w):
                if wt is None:
                    raise FileNotFoundError(
                        f"tree-{t:05d} missing for continue_train")
                wt = self._put(wt)
                z = z + lr * tree_out(wt, idx, val, full_mask)
                if loc_t is not None:
                    z_t = z_t + lr * tree_out(wt, idx_t, val_t, full_mask)
            log.info("continue_train: replayed %d finished trees", finished)

        # two numpy streams, the JAX package's: the instance stream (the
        # process index folded in, so process 0 keeps the seed) and the
        # feature stream, the same on every rank
        rng_inst = np.random.RandomState(
            (p.random.seed + 7919 * process_index()) % (2 ** 32))
        rng_feat = np.random.RandomState(p.random.seed + 104729)
        compensate = 1.0 / p.instance_sample_rate
        out = BoostResult(n_trees=0, train_loss=0.0, test_loss=None)
        tree_secs: List[float] = []
        ts["trees"] = tree_secs

        for tree in range(finished, p.tree_num):
            if self._preempt_now():
                # trees [0, tree) and the tree-info are on disk: the dump
                # trail is the checkpoint (reference boost.py:169-175)
                self._guard.preempt(p.model.data_path, family=self.variant,
                                    trees=tree)
            t_tree = time.time()
            # the tree's Bernoulli masks (reference randomNextSample)
            inst = (rng_inst.rand(n_draw) <= p.instance_sample_rate).astype(
                np.float32)
            inst[ds.n_real:] = 0.0
            inst = inst[lo:lo + loc.n]
            gmask_np = (rng_feat.rand(model.n_features)
                        <= p.feature_sample_rate).astype(np.float32)
            if p.model.need_bias:
                gmask_np[0] = 1.0
            gmask = self._put(gmask_np)
            w_eff = self._put(np.asarray(loc.weight) * inst * compensate)
            w0 = self._put(model.init_weights(tree_seed=tree))
            with obs_span("train.round", round=tree):
                res = minimize_lbfgs(
                    model.pure_loss, w0, cfg,
                    batch=(idx, val, z, gmask, y, w_eff),
                    l1_vec=l1_vec, l2_vec=l2_vec, g_weight=g_weight,
                    callback=((lambda it, st: True) if p.loss.just_evaluate
                              else None),
                    row_chunk=row_chunk, row_mask=model.batch_row_mask,
                    mesh=mesh)
            out.per_tree_loss.append(res.loss / g_weight)
            out.per_tree_iter.append(res.n_iter)
            out.per_tree_status.append(res.status)
            if p.loss.just_evaluate:
                break

            # accumulate (reference GBMLRDataFlow.accumulate, lr-shrunk)
            z = z + lr * tree_out(res.w, idx, val, gmask)
            if loc_t is not None:
                z_t = z_t + lr * tree_out(res.w, idx_t, val_t, gmask)
            if mesh is None or mesh.rank == 0:
                model.dump_tree(self.fs, res.w.cpu().numpy(), gmask_np,
                                ingest.feature_map, tree)
                model.dump_tree_info(self.fs, tree + 1, base_score)

            tl = _ensemble_loss(loss_fn, self._ensemble(z, tree + 1), y,
                                weight, mesh) / g_weight
            msg = (f"[tree={tree}] {time.time() - t0:.1f}s fit avg loss="
                   f"{out.per_tree_loss[-1]:.6f} ensemble avg loss={tl:.6f}")
            if loc_t is not None:
                ttl = _ensemble_loss(loss_fn, self._ensemble(z_t, tree + 1),
                                     y_t, weight_t, mesh) \
                    / max(g_weight_test, 1e-12)
                msg += f" test={ttl:.6f}"
            tree_secs.append(time.time() - t_tree)
            log.info(msg)

        out.n_trees = max(p.tree_num - finished, 0) + finished
        n_div = max(out.n_trees, 1)
        ens = self._ensemble(z, n_div)
        out.train_loss = _ensemble_loss(loss_fn, ens, y, weight,
                                        mesh) / g_weight
        with obs_span("train.evaluate"):
            if eval_set is not None:
                out.train_metrics = eval_set.evaluate(
                    loss_fn.predict(ens), y, weight, mesh=mesh)
            if loc_t is not None:
                ens_t = self._ensemble(z_t, n_div)
                out.test_loss = _ensemble_loss(loss_fn, ens_t, y_t,
                                               weight_t, mesh) \
                    / max(g_weight_test, 1e-12)
                if eval_set is not None:
                    out.test_metrics = eval_set.evaluate(
                        loss_fn.predict(ens_t), y_t, weight_t, mesh=mesh)
        ts["train"] = time.time() - t0 - ts["load"]
        health.record_memory("train.train")
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
