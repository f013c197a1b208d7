"""The feature-parallel exact-greedy tree maker: columns sharded over the
ranks (``ytklearn_tpu/gbdt/feature_parallel.py``, reference
optimizer/gbdt/FeatureParallelTreeMakerByLevel.java:147).

Every rank holds all rows of its contiguous slice of the columns (the
feature axis padded to a multiple of the world with all-zero columns,
masked out of the search, as the reference's avgAssign pads its column
ranges). Gradients and positions are replicated: under `--devices` every
rank computes them on the whole data, which is the all_gather the
reference issues at :274. Per level:

  1. the f32 histogram of the rows of the level's nodes over the owned
     columns (kernel K1 through `hist.hist_wave(use_bf16=False)` on the
     card, its plain version on the CPU);
  2. split_kernel over those columns, the local flat index moved to the
     global feature id, and the best split per node merged with
     `pargmax_tuple` (equal gains go to the lower rank, that is the lower
     global feature id: the data-parallel maker's first-max);
  3. the router: the owner of each splitting node's feature contributes
     each of its rows' bins, a `psum` shares them (one (n,) vector, never
     the (N, n) rows: the reference's position allgather at :443), and
     each row moves to its next-level node.

Growth is level-synchronous on the host, as HostEngine.
build_tree_level_wise, so the two makers grow the same trees on the same
inputs (the histograms' float order aside).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..parallel import collectives as coll
from ..parallel.mesh import Mesh
from .engine import ordered_sum, split_kernel
from .hist import hist_wave
from .tree import Tree


def shard_features(mesh: Mesh, bins_t: torch.Tensor
                   ) -> Tuple[torch.Tensor, int]:
    """(F, n) bin matrix -> (this rank's (F_pad / world, n) columns, F_pad),
    F_pad the feature count padded to a multiple of the world with
    all-zero columns (reference :40-51)."""
    D = mesh.world
    F, n = bins_t.shape
    F_pad = (F + D - 1) // D * D
    F_loc = F_pad // D
    lo = mesh.rank * F_loc
    local = torch.zeros((F_loc, n), dtype=torch.int32, device=bins_t.device)
    hi = min(F, lo + F_loc)
    if hi > lo:
        local[: hi - lo] = bins_t[lo:hi].to(torch.int32)
    return local.contiguous(), F_pad


def level_step(mesh: Mesh, bins_local: torch.Tensor, pos: torch.Tensor,
               g: torch.Tensor, h: torch.Tensor, fmask_local: torch.Tensor,
               B: int, cfg, n_nodes: int):
    """One level (reference :64-103): the owned columns' f32 histogram,
    the local best split per node, the global merge. Returns the merged
    (chg, fid, slot_r, slot_l, GL, HL, CL, GR, HR, CR), each (n_nodes,)."""
    F_loc = bins_local.shape[0]
    ids = torch.arange(n_nodes, dtype=torch.int32, device=pos.device)
    # f32 sums: this is the exactness-minded maker (bf16 would part its
    # gains from the data-parallel maker's)
    hist = hist_wave(bins_local, pos, g, h, ids, B, max_nodes=n_nodes,
                     use_bf16=False)
    # the nodes' own gains from rank 0's totals (global feature 0's), as
    # the level-wise maker takes them: another column's sums may round apart
    tot = ordered_sum(hist[:, 0, :, :2], dim=1)
    chg, flat, slotl, GL, HL, CL, GR, HR, CR = split_kernel(
        hist, fmask_local, cfg, node_tot=coll.from_rank0(tot, mesh))
    fid = (mesh.rank * F_loc
           + torch.div(flat, B, rounding_mode="floor")).to(torch.int32)
    slot_r = (flat % B).to(torch.int32)
    best, payload = coll.pargmax_tuple(
        chg, (fid, slot_r, slotl, GL, HL, CL, GR, HR, CR), mesh)
    return (best,) + payload


def route(mesh: Mesh, bins_local: torch.Tensor, pos: torch.Tensor,
          node_feat: torch.Tensor, node_slot: torch.Tensor,
          node_child_base: torch.Tensor) -> torch.Tensor:
    """Each row's next-level node (reference :105-135): child base + (bin
    > slot), or -1 where its node became a leaf or it was inactive; the
    bin of the row's split feature comes from the feature's owner."""
    F_loc = bins_local.shape[0]
    fl = node_feat - mesh.rank * F_loc
    mine = (node_feat >= 0) & (fl >= 0) & (fl < F_loc)
    safe = pos.clamp_min(0).long()
    r = fl[safe].clamp(0, F_loc - 1).long()
    b_local = bins_local.gather(0, r[None])[0].to(torch.int32)
    b = coll.psum(torch.where(mine[safe], b_local, torch.zeros_like(b_local)),
                  mesh)
    base = node_child_base[safe]
    new = torch.where(base >= 0, base + (b > node_slot[safe]).to(base.dtype),
                      torch.full_like(base, -1))
    return torch.where(pos >= 0, new, torch.full_like(new, -1))


def build_tree_level_feature_parallel(trainer, mesh: Mesh,
                                      bins_local: torch.Tensor, F_pad: int,
                                      g, h, pos0, F: int, B: int, feat_mask,
                                      names) -> Tree:
    """Level-synchronous exact-greedy growth with the feature-sharded
    search (reference :138-238); the host decisions are the host engine's
    (`_decide_split`, `_finish_split`)."""
    p = trainer.params
    tree = Tree()
    pos = pos0
    level_nids = [0]
    dev = pos.device
    F_loc = bins_local.shape[0]
    fmask_pad = torch.cat([feat_mask.to(torch.bool),
                           torch.zeros(F_pad - F, dtype=torch.bool,
                                       device=dev)])
    fmask_local = fmask_pad[mesh.rank * F_loc: (mesh.rank + 1) * F_loc]
    max_leaves, max_depth = trainer._caps()
    lr = np.float32(p.learning_rate)
    for depth in range(max_depth):
        n_nodes = len(level_nids)
        if n_nodes == 0:
            break
        n_pad = 1 << (n_nodes - 1).bit_length()
        out = level_step(mesh, bins_local, pos, g, h, fmask_local, B,
                         trainer._cfg(), n_pad)
        host = trainer._to_host(torch.stack([o.double() for o in out], 1))
        chg = host[:, 0].astype(np.float32)
        fid, slot_r, slot_l = (host[:, i].astype(np.int64) for i in (1, 2, 3))
        GL, HL, CL, GR, HR, CR = (host[:, i].astype(np.float32)
                                  for i in range(4, 10))
        if depth == 0:
            # the root's totals ride the first level (GL + GR is the node
            # total even with no valid split: an all -inf argmax takes
            # slot 0, whose exclusive left sum is 0)
            Gt, Ht, Ct = GL[0] + GR[0], HL[0] + HR[0], CL[0] + CR[0]
            tree.hess_sum[0], tree.sample_cnt[0] = float(Ht), int(round(Ct))
            tree.leaf_value[0] = float(trainer._node_value(Gt, Ht) * lr)
        node_feat = np.full((n_pad,), -1, np.int32)
        node_slot = np.zeros((n_pad,), np.int32)
        child_base = np.full((n_pad,), -1, np.int32)
        next_nids: List[int] = []
        leaves_after = tree.leaf_cnt()
        for k in range(n_nodes):
            nid = level_nids[k]
            if not (leaves_after < max_leaves
                    and trainer._decide_split(chg[k], CL[k], CR[k], HL[k],
                                              HR[k])):
                continue
            left, right = trainer._finish_split(
                tree, names, nid, int(fid[k]), int(slot_l[k]),
                int(slot_r[k]), (GL[k], HL[k], CL[k], GR[k], HR[k], CR[k]))
            tree.gain[nid] = float(chg[k])
            node_feat[k] = int(fid[k])
            node_slot[k] = int(slot_l[k])
            child_base[k] = len(next_nids)
            next_nids.extend([left, right])
            leaves_after = tree.leaf_cnt()
        if not next_nids:
            break
        pos = route(mesh, bins_local, pos, torch.from_numpy(node_feat).to(dev),
                    torch.from_numpy(node_slot).to(dev),
                    torch.from_numpy(child_base).to(dev))
        level_nids = next_nids
    return tree
