"""GBDT training on the host engine: the reference's per-level and per-split
host loop (``ytklearn_tpu/gbdt/trainer.py:1349-1800``).

    GBDTTrainer(params, engine="host", device=...).train(train, test)

and `engine="auto"` sends precise LAD (l1 with `lad_refine_appr = false`)
and `tree_maker = "feature"` here, as the reference does (on one device
the feature-parallel maker is the level-wise or loss-wise maker, by
`tree_grow_policy`; its column-sharded form waits for a mesh, ROADMAP.md
1.7). Per round: predictions -> (g, h) -> a row and a feature mask from
one `np.random.RandomState(20170425)` drawn `rand(n)`, `rand(F)` every
round from the first trained round on -> K trees, each grown

  level-wise: one histogram of every active row by level-local node, one
    split search over the level's nodes, one position update, a level at
    a time (reference TreeGrowPolicy.LEVEL);
  loss-wise: best-first, the frontier node of the largest gain (the
    lowest node id on a tie) split next; the smaller child's histogram
    summed over exactly its rows, the sibling's by f32 subtraction from
    the parent's (reference TreeGrowPolicy.LOSS and its HistogramPool);

-> under l1 the precise LAD refine: each leaf's value is lr times the
weighted median of y - score over its rows, on the host in numpy as the
reference computes it (f32 residuals, a stable argsort, an f32 cumsum and
searchsorted) -> the tree's scores on the train and test rows -> its
value conversion.

The bins come from the host samplers (`build_bins`, the reference's host
engine's), the bin matrix from `bin_matrix_device` (`bin_matrix`'s rule).
No TPU kernel is on this path: the reference's device functions here are
XLA scatter-adds and gathers (its docstring: "fine on CPU, slow on
TPU"), and the port's are plain torch. The rows stay on the device; the
engine reads to the host what the reference reads there: the split
search's results (once a level, or once a split), each node-row
selection's size, and the precise refine's inputs. `host_syncs` counts
those reads.

The histogram sums g, h and the count of each (node, feature, bin) in
float64 and rounds once to f32: the order of a float64 sum almost never
shows after that rounding, so the card's atomic adds give the CPU's
sums. The reference sums in f32 in one scatter-add, within about 1e-6
relative. Predictions for the gradients are taken in float64 and rounded
once for the same reason (the card's and the CPU's f32 sigmoid may round
apart in the last ulp); the split search is engine.split_kernel, whose
fixed-order prefix sums give the same splits on every device. So a
host-engine run on the card dumps the CPU's model text byte for byte.

Resume (`continue_train`) replays the dumped trees and restarts the
sampling stream at its first draw, as the reference does: at sampling
rates of 1 the draws decide nothing and a resumed run equals the
uninterrupted one byte for byte; below 1 it does not (ROADMAP.md §3).
GOSS and EFB are device-engine features: the host engine logs and trains
unsampled and unbundled.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..eval import EvalSet
from .binning import bin_matrix_device, build_bins
from .data import GBDTData, GBDTIngest, to_tensor
from .engine import split_kernel
from .tree import GBDTModel, Tree

log = logging.getLogger("ytklearn_tpu_torch.gbdt")

#: the host engine's sampling stream (reference trainer.py:1606)
HOST_SEED = 20170425
#: (rows x features) elements a histogram adds in one index_add_
HIST_CHUNK = 1 << 22


# ---------------------------------------------------------------------------
# The device functions (the reference's hist_kernel, node_hist_kernel,
# pos_update_kernel, _traverse_kernel and _assign_kernel), in plain torch
# ---------------------------------------------------------------------------


def hist_rows(bins_t: torch.Tensor, rows: torch.Tensor, node: torch.Tensor,
              g: torch.Tensor, h: torch.Tensor, n_nodes: int,
              B: int) -> torch.Tensor:
    """(n_nodes, F, B, 3) f32 sums of (g, h, 1) over `rows`, rows[i]
    adding to node node[i] at its bin of every feature: float64 sums,
    rounded once. One index_add_ a chunk of rows, whose (rows x F) ids and
    values stay below HIST_CHUNK elements (the reference's (n F, 3) array
    is 704 MB at 2^20 rows in float64); each cell takes its rows in row
    order, as np.add.at does, on the CPU."""
    F = bins_t.shape[0]
    dev = bins_t.device
    out = torch.zeros((n_nodes * F * B, 3), dtype=torch.float64, device=dev)
    offs = torch.arange(F, device=dev) * B
    step = max(1, HIST_CHUNK // F)
    for lo in range(0, rows.numel(), step):
        r = rows[lo:lo + step]
        ids = (node[lo:lo + step].long() * (F * B))[:, None] + offs[None] \
            + bins_t[:, r].t().long()
        vals = torch.stack([g[r], h[r], torch.ones_like(g[r])], dim=1)
        out.index_add_(0, ids.reshape(-1),
                       vals.double().repeat_interleave(F, dim=0))
    return out.to(torch.float32).reshape(n_nodes, F, B, 3)


def hist_kernel(bins_t: torch.Tensor, pos: torch.Tensor, g: torch.Tensor,
                h: torch.Tensor, n_nodes: int, B: int) -> torch.Tensor:
    """(n_nodes, F, B, 3) histogram of (g, h, count) by level-local node
    over the rows with pos >= 0 (reference trainer.py:90)."""
    rows = torch.nonzero(pos >= 0).squeeze(1)
    return hist_rows(bins_t, rows, pos.index_select(0, rows), g, h, n_nodes,
                     B)


def node_hist_kernel(bins_t: torch.Tensor, in_node: torch.Tensor,
                     g: torch.Tensor, h: torch.Tensor, B: int
                     ) -> torch.Tensor:
    """(F, B, 3) histogram of one node's rows (reference trainer.py:127):
    exactly the rows where in_node holds."""
    rows = torch.nonzero(in_node).squeeze(1)
    node = torch.zeros_like(rows)
    return hist_rows(bins_t, rows, node, g, h, 1, B)[0]


def pos_update_kernel(bins_t: torch.Tensor, pos: torch.Tensor,
                      node_feat: torch.Tensor, node_slot: torch.Tensor,
                      node_child_base: torch.Tensor) -> torch.Tensor:
    """Each row's next-level-local node: child base + (bin > slot), or -1
    where its node became a leaf or it was inactive (reference
    trainer.py:111)."""
    safe = pos.clamp_min(0).long()
    f = node_feat[safe]
    slot = node_slot[safe]
    base = node_child_base[safe]
    b = bins_t.gather(0, f.clamp_min(0).long()[None])[0]
    new = torch.where(base >= 0, base + (b > slot).to(base.dtype),
                      torch.full_like(base, -1))
    return torch.where(pos >= 0, new, torch.full_like(new, -1))


def walk(bins_t: torch.Tensor, feat, slot, left, right,
         depth: int) -> torch.Tensor:
    """Every row's leaf in a slot-space tree, a fixed-depth walk in which
    leaves (feat < 0) hold (reference trainer.py:1964-1992)."""
    node = torch.zeros(bins_t.shape[1], dtype=torch.long,
                       device=bins_t.device)
    for _ in range(depth):
        f = feat[node]
        b = bins_t.gather(0, f.clamp_min(0).long()[None])[0]
        nxt = torch.where(b <= slot[node], left[node], right[node])
        node = torch.where(f < 0, node, nxt.long())
    return node


# ---------------------------------------------------------------------------
# The engine, mixed into GBDTTrainer
# ---------------------------------------------------------------------------


class HostEngine:
    """The host engine's methods of GBDTTrainer (reference trainer.py:
    1349-1800); they read self.params, self.loss, self.node_value_fn,
    self.device and the dump helpers of the trainer."""

    host_syncs = 0

    def _node_value(self, G, H) -> np.float32:
        """node_value_fn on f32 scalars, on the CPU."""
        return np.float32(self.node_value_fn(
            torch.tensor(G, dtype=torch.float32),
            torch.tensor(H, dtype=torch.float32)).item())

    def _to_host(self, t: torch.Tensor) -> np.ndarray:
        self.host_syncs += 1
        return t.cpu().numpy()

    def _splits(self, hist: torch.Tensor, feat_mask: torch.Tensor):
        """split_kernel over (N, F, B, 3) histograms, read to the host in
        one transfer: (chg, flat_idx, slot_l, GL, HL, CL, GR, HR, CR), each
        an (N,) array, f32 or int (every value is exact in float64)."""
        out = split_kernel(hist, feat_mask, self._cfg())
        host = self._to_host(torch.stack([o.double() for o in out], dim=1))
        f32 = [host[:, i].astype(np.float32) for i in (0, 3, 4, 5, 6, 7, 8)]
        return (f32[0], host[:, 1].astype(np.int64),
                host[:, 2].astype(np.int64), *f32[1:])

    def _root_stats(self, hist: torch.Tensor, F: int):
        """Node totals from a (F, B, 3) histogram: every active row hits
        every feature, so the (F, B) sum counts each F times; summed in
        float64 on the host."""
        s = self._to_host(hist).astype(np.float64).sum(axis=(0, 1)) / F
        return np.float32(s[0]), np.float32(s[1]), float(s[2])

    def _set_root(self, tree: Tree, hist0: torch.Tensor, F: int) -> None:
        G, H, C = self._root_stats(hist0, F)
        tree.hess_sum[0], tree.sample_cnt[0] = float(H), int(round(C))
        tree.leaf_value[0] = float(self._node_value(G, H)
                                   * np.float32(self.params.learning_rate))

    def _decide_split(self, chg, cl, cr, hl, hr) -> bool:
        p = self.params
        return bool(
            np.isfinite(chg)
            and chg > p.min_split_loss
            and cl + cr >= p.min_split_samples
            and (hl + hr) >= p.min_child_hessian_sum * 2.0
        )

    def _finish_split(self, tree: Tree, names, nid: int, fid: int,
                      slot_l: int, slot_r: int, stats):
        """Record a split on the host tree, in slot space until the value
        conversion (reference trainer.py:1358)."""
        gl, hl, cl, gr, hr, cr = stats
        tree.feat[nid] = fid
        tree.feat_name[nid] = names[fid] if names else str(fid)
        tree.slot[nid] = slot_l
        tree.split[nid] = float(slot_r)  # the interval's right end
        left, right = tree.add_children(nid)
        lr = np.float32(self.params.learning_rate)
        tree.leaf_value[left] = float(self._node_value(gl, hl) * lr)
        tree.leaf_value[right] = float(self._node_value(gr, hr) * lr)
        tree.hess_sum[left], tree.sample_cnt[left] = float(hl), int(cl)
        tree.hess_sum[right], tree.sample_cnt[right] = float(hr), int(cr)
        return left, right

    def _caps(self):
        p = self.params
        return (p.max_leaf_cnt if p.max_leaf_cnt > 0 else 1 << 30,
                p.max_depth if p.max_depth > 0 else 1 << 30)

    def build_tree_level_wise(self, bins_t, g, h, pos0, F: int, B: int,
                              feat_mask, names) -> Tree:
        """Level-synchronous growth: one histogram, one split search and
        one position update a level (reference trainer.py:1374)."""
        tree = Tree()
        pos = pos0  # level-local node of each row (-1: inactive)
        level_nids = [0]  # tree node of each level-local node
        hist = hist_kernel(bins_t, pos, g, h, 1, B)
        self.host_syncs += 1
        self._set_root(tree, hist[0], F)
        max_leaves, max_depth = self._caps()
        dev = bins_t.device
        for depth in range(max_depth):
            n_nodes = len(level_nids)
            if n_nodes == 0:
                break
            if depth > 0:  # the root's histogram is the first level's
                hist = hist_kernel(bins_t, pos, g, h, n_nodes, B)
                self.host_syncs += 1
            chg, flat_idx, slot_l, GL, HL, CL, GR, HR, CR = self._splits(
                hist, feat_mask)
            node_feat = np.full((n_nodes,), -1, np.int32)
            node_slot = np.zeros((n_nodes,), np.int32)
            child_base = np.full((n_nodes,), -1, np.int32)
            next_nids: List[int] = []
            leaves_after = tree.leaf_cnt()
            for k in range(n_nodes):
                nid = level_nids[k]
                if not (leaves_after < max_leaves
                        and self._decide_split(chg[k], CL[k], CR[k], HL[k],
                                               HR[k])):
                    continue
                fid, slot_r = divmod(int(flat_idx[k]), B)
                left, right = self._finish_split(
                    tree, names, nid, fid, int(slot_l[k]), slot_r,
                    (GL[k], HL[k], CL[k], GR[k], HR[k], CR[k]))
                tree.gain[nid] = float(chg[k])
                node_feat[k] = fid
                node_slot[k] = int(slot_l[k])
                child_base[k] = len(next_nids)
                next_nids.extend([left, right])
                leaves_after = tree.leaf_cnt()
            if not next_nids:
                break
            pos = pos_update_kernel(
                bins_t, pos, torch.from_numpy(node_feat).to(dev),
                torch.from_numpy(node_slot).to(dev),
                torch.from_numpy(child_base).to(dev))
            level_nids = next_nids
        return tree

    def build_tree_loss_wise(self, bins_t, g, h, pos_active, F: int, B: int,
                             feat_mask, names) -> Tree:
        """Best-first growth with a histogram a node and sibling
        subtraction (reference trainer.py:1454)."""
        tree = Tree()
        # the tree node of each row (-1: left out by the row sampling)
        tree_pos = torch.where(pos_active >= 0, 0, -1).to(torch.int32)
        root = node_hist_kernel(bins_t, tree_pos >= 0, g, h, B)
        self.host_syncs += 1
        self._set_root(tree, root, F)
        hists: Dict[int, torch.Tensor] = {0: root}
        frontier = {0: tuple(a[0] for a in self._splits(root[None],
                                                        feat_mask))}
        max_leaves, max_depth = self._caps()
        depth_of = {0: 0}
        while tree.leaf_cnt() < max_leaves:
            cand = [(v[0], nid) for nid, v in frontier.items()
                    if depth_of[nid] < max_depth
                    and self._decide_split(v[0], v[5], v[8], v[4], v[7])]
            if not cand:
                break
            _chg, nid = max(cand, key=lambda t: (t[0], -t[1]))
            c, flat_idx, slot_l, GL, HL, CL, GR, HR, CR = frontier.pop(nid)
            fid, slot_r = divmod(int(flat_idx), B)
            left, right = self._finish_split(
                tree, names, nid, fid, int(slot_l), slot_r,
                (GL, HL, CL, GR, HR, CR))
            tree.gain[nid] = float(c)
            depth_of[left] = depth_of[right] = depth_of[nid] + 1
            # move the node's rows to its children
            b = bins_t[fid]
            tree_pos = torch.where(
                tree_pos == nid,
                torch.where(b > int(slot_l), right, left).to(torch.int32),
                tree_pos)
            # the smaller child by its rows, the sibling by subtraction
            small, big = (left, right) if CL <= CR else (right, left)
            small_hist = node_hist_kernel(bins_t, tree_pos == small, g, h, B)
            self.host_syncs += 1
            parent_hist = hists.pop(nid)
            hists[small] = small_hist
            hists[big] = parent_hist - small_hist
            # both children's searches in one call, one read
            both = self._splits(torch.stack([hists[small], hists[big]]),
                                feat_mask)
            frontier[small] = tuple(a[0] for a in both)
            frontier[big] = tuple(a[1] for a in both)
        return tree

    def _tree_leaf_assignment(self, tree: Tree, bins_t) -> torch.Tensor:
        """Every row's leaf in a slot-space tree."""
        dev = bins_t.device

        def t32(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        return walk(bins_t, t32(tree.feat), t32(tree.slot), t32(tree.left),
                    t32(tree.right), max(tree.max_depth(), 1))

    def _tree_scores_dev(self, tree: Tree, bins_t) -> torch.Tensor:
        """A slot-space tree's leaf value at every row (bin <= slot goes
        left; reference trainer.py:1523)."""
        leaf = torch.as_tensor(np.asarray(tree.leaf_value, np.float32),
                               device=bins_t.device)
        return leaf[self._tree_leaf_assignment(tree, bins_t)]

    def _refine_lad(self, tree: Tree, bins_t, y_np: np.ndarray, scores,
                    w_np: np.ndarray) -> None:
        """Precise LAD: each leaf's value is lr times the weighted median
        of y - score over its rows of positive weight (reference
        trainer.py:1778, TreeRefiner.java:72-123), in numpy on the host:
        f32 residuals, a stable argsort, an f32 cumsum, searchsorted."""
        pos = self._to_host(self._tree_leaf_assignment(tree, bins_t))
        resid = y_np - self._to_host(scores)
        lr = self.params.learning_rate
        for nid in range(tree.n_nodes()):
            if not tree.is_leaf(nid):
                continue
            m = (pos == nid) & (w_np > 0)
            if not m.any():
                continue
            r, ww = resid[m], w_np[m]
            order = np.argsort(r, kind="stable")
            cw = np.cumsum(ww[order])
            cut = 0.5 * cw[-1]
            tree.leaf_value[nid] = float(r[order][np.searchsorted(cw, cut)]) \
                * lr

    def _host_scores(self, model: GBDTModel, bins, bins_t, n: int,
                     base_np) -> torch.Tensor:
        """Base scores plus a resumed model's trees replayed."""
        K = self.K
        base_t = torch.as_tensor(np.asarray(base_np, np.float32),
                                 device=self.device)
        scores = base_t.expand((n, K) if K > 1 else (n,)).clone()
        for i, t in enumerate(model.trees):
            add = self._tree_scores_from_raw(t, bins, bins_t)
            if K > 1:
                scores[:, i % K] += add
            else:
                scores = scores + add
        return scores

    def _train_host(self, train: Optional[GBDTData],
                    test: Optional[GBDTData]):
        """The reference's _train_host (trainer.py:1535)."""
        from .trainer import _host, _wavg_loss

        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        self.host_syncs = 0
        if train is None:
            ingest = GBDTIngest(p, self.fs, transform_hook=self.transform_hook)
            train, test = ingest.load()
            ts["parser"] = ingest.parser
        ts["load"] = time.time() - t0
        dev = self.device
        X = _host(train.X)
        n, F = X.shape
        K = self.K
        self._missing_fill = train.missing_fill
        names = train.feature_names
        w_np = np.ascontiguousarray(_host(train.weight), np.float32)
        bins = build_bins(X, w_np, p, names)
        self._bins_sidecar = (list(names or []), bins)
        self._quality_features = self._build_quality_features(train)
        B = bins.max_bins

        def bins_on_device(Xs):
            # bin_matrix's rule, on the device (gbdt/binning.py)
            return bin_matrix_device(
                to_tensor(Xs, torch.float32, dev).t().contiguous(), bins)

        bins_t = bins_on_device(X)
        del X
        y = to_tensor(train.y, torch.float32, dev)
        weight = to_tensor(train.weight, torch.float32, dev)
        log.info("host engine: %d rows, %d features, %d max bins", n, F, B)
        base_np = self._base_score(train)
        model = GBDTModel(base_prediction=float(np.mean(base_np)),
                          num_tree_in_group=K, obj_name=self.loss.name)
        model, start = self._load_resume_model(model, names)
        scores = self._host_scores(model, bins, bins_t, n, base_np)
        test_state = None
        if test is not None:
            bt = bins_on_device(_host(test.X))
            test_state = [bt, to_tensor(test.y, torch.float32, dev),
                          to_tensor(test.weight, torch.float32, dev),
                          self._host_scores(model, bins, bt, test.n,
                                            base_np)]
        ts["preprocess"] = time.time() - t0 - ts["load"]
        eval_set = EvalSet(p.eval_metric, K=max(K, 2)) \
            if p.eval_metric else None
        round_log: List[Dict] = []
        self.tree_seconds: List[float] = []
        if p.just_evaluate:
            return self._finalize_host(model, scores, y, weight, test_state,
                                       eval_set, round_log)
        lad = self.loss.name == "l1" and K == 1
        y_np = self._to_host(y) if lad else None
        live = weight > 0
        rng = np.random.RandomState(HOST_SEED)
        t_train0 = time.time()
        for rnd in range(start, p.round_num):
            if self._guard is not None and self._guard.triggered:
                # the host engine appends converted trees as it goes: the
                # dump is the checkpoint, the resume re-enters this round
                self._dump_model(model)
                self._guard.preempt(p.model.data_path, family="gbdt_host",
                                    rounds=rnd, trees=len(model.trees))
            # predictions in float64, rounded once: the same on every device
            preds = self.loss.predict(scores.double()).float()
            gs, hs = self.loss.grad_hess(preds, y)
            inst = (rng.rand(n) <= p.instance_sample_rate).astype(np.float32)
            inst[train.n_real:] = 0.0
            pos0 = torch.from_numpy(
                np.where(inst > 0, 0, -1).astype(np.int32)).to(dev)
            fmask = rng.rand(F) <= p.feature_sample_rate
            if not fmask.any():
                fmask[rng.randint(F)] = True
            fmask_dev = torch.from_numpy(fmask).to(dev)
            for grp in range(K):
                t_tree = time.time()
                g = gs[:, grp] if K > 1 else gs
                h = hs[:, grp] if K > 1 else hs
                g = torch.where(live, g * weight, 0.0)
                h = torch.where(live, h * weight, 0.0)
                grow = (self.build_tree_loss_wise
                        if p.tree_grow_policy == "loss"
                        else self.build_tree_level_wise)
                tree = grow(bins_t, g, h, pos0, F, B, fmask_dev, names)
                if lad:
                    self._refine_lad(tree, bins_t, y_np, scores, w_np)
                add = self._tree_scores_dev(tree, bins_t)
                if K > 1:
                    scores[:, grp] += add
                else:
                    scores = scores + add
                if test_state is not None:
                    add_t = self._tree_scores_dev(tree, test_state[0])
                    if K > 1:
                        test_state[3][:, grp] += add_t
                    else:
                        test_state[3] = test_state[3] + add_t
                self._convert_tree(tree, bins)
                model.trees.append(tree)
                self.tree_seconds.append(time.time() - t_tree)
            rec = {"round": rnd, "elapsed": time.time() - t0,
                   "train_loss": float(_wavg_loss(self.loss, scores, y,
                                                  weight))}
            if test_state is not None:
                rec["test_loss"] = float(_wavg_loss(
                    self.loss, test_state[3], test_state[1], test_state[2]))
            round_log.append(rec)
            log.info("[round=%d] %.1fs train loss=%.6f%s", rnd,
                     rec["elapsed"], rec["train_loss"],
                     f" test loss={rec['test_loss']:.6f}"
                     if "test_loss" in rec else "")
            if p.model.dump_freq > 0 and (rnd + 1) % p.model.dump_freq == 0:
                self._dump_model(model)
        ts["train"] = time.time() - t_train0
        ts["host_syncs"] = self.host_syncs
        if test_state is not None:
            self._stash_quality_scores(test_state[3], test_state[2])
        else:
            self._stash_quality_scores(scores, weight)
        self._dump_model(model)
        return self._finalize_host(model, scores, y, weight, test_state,
                                   eval_set, round_log)

    def _finalize_host(self, model, scores, y, weight, test_state, eval_set,
                       round_log):
        from .trainer import GBDTResult, _wavg_loss

        res = GBDTResult(model=model,
                         train_loss=float(_wavg_loss(self.loss, scores, y,
                                                     weight)),
                         test_loss=None, round_log=round_log)
        if eval_set is not None:
            res.train_metrics = eval_set.evaluate(self.loss.predict(scores),
                                                  y, weight)
        scores_t = None
        if test_state is not None:
            _, y_t, w_t, scores_t = test_state
            res.test_loss = float(_wavg_loss(self.loss, scores_t, y_t, w_t))
            if eval_set is not None:
                res.test_metrics = eval_set.evaluate(
                    self.loss.predict(scores_t), y_t, w_t)
        self.final_scores = (scores, scores_t)
        return res
