"""GBDT boosting trainer: the device engine.

The counterpart of the device path of ``ytklearn_tpu/gbdt/trainer.py``
(reference optimizer/GBDTOptimizer.java:174-530):

    GBDTTrainer(params, hist_precision="bf16"|"f32"|"int8", device=...)
        .train(train=GBDTData, test=GBDTData) -> GBDTResult
    GBDTTrainer(params).train()  # loads data.train/test through GBDTIngest

Per round: predictions -> (g, h) -> one tree grown by engine.grow on the
device (histogram kernels K1/K3 in bf16 or f32, the JAX trainer's default
bf16, or K2/K4 in int8; routing kernel K5) -> score and loss updates.
Each round's key is fold_in(PRNGKey(20170425), round), split into the
feature, row and GOSS keys (gbdt.prng, bit for bit the JAX trainer's
draws): `instance_sample_rate` and `feature_sample_rate` below 1 mask rows
and columns, and GOSS (`goss=(a, b)`, a < 1) grows each tree on its
sampled fit rows. EFB (`efb`, the `YTK_EFB` knob, on by default) bundles
mutually exclusive sparse columns into offset-binned columns before the
bin matrix reaches the device; the plan stays on the host, the engine
takes its range tables and every grown tree is unbundled back to the
original features before its value conversion.
Tree arrays
stay in whole-run device buffers and are fetched once at the end (and at
`dump_freq` checkpoints). Binning runs on the device too (sort + rank
pick + compare-count, gbdt/binning.py). The model text, its `.bins.json`
sidecar and the feature importance file are the JAX trainer's, byte for
byte for the same trees.

Runs on `cuda` unless the caller passes `device="cpu"` (the kernels' plain
versions). Not ported, each raising NotImplementedError with its
ROADMAP.md item: resume, softmax (K > 1), l1 with LAD refine, the other
losses and the host engine (1.5), a mesh (1.7), and on CUDA trees of more
nodes than the histogram kernels' shared-memory lookup holds (1.8). The
quality sidecar is an obs-plane item (1.12).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import knobs
from ..config.params import GBDTParams
from ..device import resolve_device
from ..eval import EvalSet
from ..io.fs import LocalFileSystem
from ..losses import TRAINABLE, create_loss
from . import prng
from .binning import (
    BundlePlan,
    FeatureBins,
    bin_edges_path,
    bin_matrix_device,
    build_bins_maybe_device,
    build_bundle_plan,
    bundle_bin_matrix_t,
    dump_bin_edges,
    model_text_digest,
)
from .data import GBDTData, GBDTIngest, to_tensor
from .engine import GrowSpec, grow, wave_log_rows
from .hist import BM_DEFAULT, check_tile_fits
from .tree import GBDTModel, Tree, unbundle_tree

log = logging.getLogger("ytklearn_tpu_torch.gbdt")

#: the root of every run's key chain (the JAX trainer's, trainer.py:938)
ROOT_SEED = 20170425

_TREE_FIELDS = ("feat", "slot", "slot_r", "left", "right", "leaf", "gain",
                "hess", "cnt")


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


@dataclass
class _DevInputs:
    """Device-resident training inputs prepared once per run."""

    bins: FeatureBins
    bins_t: torch.Tensor  # (F, n_pad) u8 (B <= 256) or i32
    y: torch.Tensor
    weight: torch.Tensor
    real_mask: torch.Tensor
    n_score: int
    F: int  # engine-visible columns (EFB-bundled when a plan exists)
    B: int  # bin axis padded to a power of two
    aux_bins: tuple  # () or (bins_t of the test set,)
    y_t: Optional[torch.Tensor]
    w_t: Optional[torch.Tensor]
    nt_score: int
    ranges: Optional[tuple] = None  # EFB (range_lo, range_hi) (F, B) i32


@dataclass
class GBDTResult:
    model: GBDTModel
    train_loss: float
    test_loss: Optional[float]
    train_metrics: Dict[str, float] = field(default_factory=dict)
    test_metrics: Dict[str, float] = field(default_factory=dict)
    round_log: List[Dict] = field(default_factory=list)


class GBDTTrainer:
    def __init__(
        self,
        params: GBDTParams,
        device=None,
        fs=None,
        engine: str = "auto",
        wave: Optional[int] = None,
        use_bf16_hist: bool = True,
        hist_precision: Optional[str] = None,  # bf16 | f32 | int8
        goss: Optional[Tuple[float, float]] = None,  # (a, b); a >= 1 = off
        efb: Optional[bool] = None,  # None = YTK_EFB knob
        mesh=None,
    ):
        self.params = params
        self.device = resolve_device(device)
        self.fs = fs or LocalFileSystem()
        p = params
        if mesh is not None:
            raise _not_ported("multi-GPU training (mesh)",
                              "1.7, multi-GPU data-parallel GBDT")
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"engine must be auto|device|host, got {engine!r}")
        if engine == "host" or p.tree_maker == "feature":
            raise _not_ported("the host engine and the feature-parallel "
                              "maker", "1.5, rest of the GBDT trainer")
        self.engine = "device"
        if hist_precision is None:
            hist_precision = "bf16" if use_bf16_hist else "f32"
        if hist_precision not in ("bf16", "f32", "int8"):
            raise ValueError(
                f"hist_precision must be bf16|f32|int8, got {hist_precision!r}"
            )
        self.hist_precision = hist_precision
        self.use_bf16_hist = hist_precision != "f32"
        self.K = p.num_tree_in_group
        if self.K > 1:
            raise _not_ported("softmax multiclass (K > 1 trees per round)",
                              "1.5, rest of the GBDT trainer")
        self.loss = create_loss(p.loss_function,
                                {"sigmoid_zmax": p.sigmoid_zmax})
        if self.loss.name == "l1":
            raise _not_ported("l1 loss with LAD leaf refinement",
                              "1.5, rest of the GBDT trainer")
        if self.loss.name not in TRAINABLE:
            raise _not_ported(f"training with loss {self.loss.name!r}",
                              "1.5, rest of the GBDT trainer")
        if p.model.continue_train:
            raise _not_ported("continue_train (resume)",
                              "1.5, rest of the GBDT trainer")
        self.wave = wave
        if goss is None:
            goss = (knobs.get_float("YTK_GOSS_A"),
                    knobs.get_float("YTK_GOSS_B"))
        a, b = float(goss[0]), float(goss[1])
        if not (0.0 < a <= 1.0) or not (0.0 <= b <= 1.0):
            raise ValueError(
                f"goss=(a, b) needs 0 < a <= 1 and 0 <= b <= 1, got {goss!r}"
            )
        self.goss = (a, b)
        self.efb = knobs.get_bool("YTK_EFB") if efb is None else bool(efb)
        self._efb_plan: Optional[BundlePlan] = None
        self._missing_fill = None
        self._bins_sidecar = None
        self.sync_log: List[Tuple[int, float]] = []
        self.time_stats: Dict[str, float] = {}

    # -- spec and inputs ----------------------------------------------------

    def _grow_spec(self, F: int, B: int, goss_scale: float = 1.0
                   ) -> GrowSpec:
        p = self.params
        caps = []
        if p.max_leaf_cnt > 0:
            caps.append(2 * p.max_leaf_cnt - 1)
        if p.max_depth > 0:
            caps.append(2 ** (p.max_depth + 1) - 1)
        if not caps:
            raise ValueError("gbdt needs optimization.max_depth or "
                             "max_leaf_cnt")
        M = min(caps)
        if self.device.type == "cuda":
            check_tile_fits(B, M)  # the histogram kernels' node lookup
        NW = self.wave if self.wave is not None else 64
        NW = max(1, min(NW, (M + 1) // 2))
        partition = (not knobs.get_bool("YTK_NO_PARTITION")
                     and knobs.get_bool("YTK_PARTITION"))
        ladder_env = knobs.get_str("YTK_LADDER")
        on_card = self.device.type == "cuda"
        if ladder_env:
            ladder = tuple(int(x) for x in ladder_env.split(",") if x.strip())
        else:
            # the reference's TPU ladder on the card, its CPU ladder here
            ladder = (64, 256) if on_card else (8, 32)
        return GrowSpec(
            F=F, B=B, max_nodes=M, wave=NW, policy=p.tree_grow_policy,
            max_depth=p.max_depth, max_leaves=p.max_leaf_cnt,
            lr=p.learning_rate, l1=p.l1, l2=p.l2,
            min_h=p.min_child_hessian_sum, max_abs=p.max_abs_leaf_val,
            min_split_loss=p.min_split_loss,
            min_split_samples=float(p.min_split_samples),
            # the row unit of gathered rungs and of GOSS's fit matrix: the
            # reference's TPU unit on the card, its CPU unit here
            bm=BM_DEFAULT if on_card else 128,
            use_bf16=self.use_bf16_hist,
            hist_mode="int8" if self.hist_precision == "int8" else "mxu",
            partition=partition, ladder=ladder,
            fused=knobs.get_bool("YTK_FUSED"),
            fused_max_rows=knobs.get_int("YTK_FUSED_MAX_ROWS"),
            goss_a=self.goss[0], goss_b=self.goss[1], goss_scale=goss_scale,
        )

    def _pad_rows(self, a, n_pad: int, dtype=torch.float32) -> torch.Tensor:
        t = to_tensor(a, dtype, self.device)
        return torch.nn.functional.pad(t, (0, n_pad - t.shape[0]))

    def _transposed(self, X) -> torch.Tensor:
        return to_tensor(X, torch.float32, self.device).t().contiguous()

    def _bin_rows(self, X_t: torch.Tensor, bins: FeatureBins, B: int):
        """(F, n) raw values -> (F or bundled columns, n_pad) bins, rows
        zero-padded to a multiple of 16384 before binning, as the
        reference does."""
        n = X_t.shape[1]
        n_pad = -(-n // BM_DEFAULT) * BM_DEFAULT
        Xp = torch.nn.functional.pad(X_t, (0, n_pad - n)).contiguous()
        bins_t = bin_matrix_device(Xp, bins)
        if self._efb_plan is not None:
            bins_t = bundle_bin_matrix_t(bins_t, self._efb_plan)
        if B <= 256:
            bins_t = bins_t.to(torch.uint8)
        return bins_t, n_pad

    def _prep_device_inputs(self, train: GBDTData, test: Optional[GBDTData]
                            ) -> _DevInputs:
        p = self.params
        self._missing_fill = train.missing_fill
        X_t = self._transposed(train.X)
        bins = build_bins_maybe_device(X_t, train.weight, p,
                                       train.feature_names)
        B_real = bins.max_bins
        B = max(8, 1 << (B_real - 1).bit_length())  # pad to a power of two
        # EFB: bundles are capped at the padded bin width B, so the
        # histogram shape never grows; the sidecar keeps the original edges
        self._efb_plan = None
        if self.efb:
            budget = knobs.get_int("YTK_EFB_CONFLICT")
            self._efb_plan = build_bundle_plan(X_t, bins, budget, B)
            if self._efb_plan is not None:
                log.info("EFB: %s (conflict budget %d)",
                         self._efb_plan.summary(), budget)
        plan = self._efb_plan
        self._bins_sidecar = (list(train.feature_names or []), bins)
        bins_t, n_pad = self._bin_rows(X_t, bins, B)
        del X_t
        y = self._pad_rows(train.y, n_pad)
        weight = self._pad_rows(train.weight, n_pad)
        real_mask = torch.arange(n_pad, device=self.device) < train.n
        aux_bins, y_t, w_t, nt_pad = (), None, None, 0
        if test is not None:
            bt, nt_pad = self._bin_rows(self._transposed(test.X), bins, B)
            aux_bins = (bt,)
            y_t = self._pad_rows(test.y, nt_pad)
            w_t = self._pad_rows(test.weight, nt_pad)
        log.info("%d rows, %d features, %d bins (pad %d)", train.n_real,
                 train.n_features, B_real, B)
        ranges = None
        if plan is not None:
            ranges = tuple(torch.from_numpy(r).to(self.device)
                           for r in plan.range_tables(B))
        return _DevInputs(
            bins=bins, bins_t=bins_t, y=y, weight=weight, real_mask=real_mask,
            n_score=n_pad, F=bins_t.shape[0], B=B, aux_bins=aux_bins,
            y_t=y_t, w_t=w_t, nt_score=nt_pad, ranges=ranges,
        )

    def _base_score(self, train: GBDTData) -> np.float32:
        p = self.params
        if p.sample_dependent_base_prediction:
            # in the arrays' own dtype, as the reference averages
            mean = float(np.average(_host(train.y)[: train.n_real],
                                    weights=_host(train.weight)[: train.n_real]))
            return np.float32(self.loss.pred2score(mean))
        return np.float32(self.loss.pred2score(p.uniform_base_prediction))

    def _make_tree_bufs(self, M: int):
        """Whole-run tree buffers, written on the device, fetched once."""
        T = self.params.round_num * self.K
        dev = self.device

        def full(shape, v, dt):
            return torch.full(shape, v, dtype=dt, device=dev)

        i32, f32 = torch.int32, torch.float32
        bufs = {
            "feat": full((T, M), -1, i32), "slot": full((T, M), 0, i32),
            "slot_r": full((T, M), 0, i32), "left": full((T, M), -1, i32),
            "right": full((T, M), -1, i32), "leaf": full((T, M), 0.0, f32),
            "gain": full((T, M), 0.0, f32), "hess": full((T, M), 0.0, f32),
            "cnt": full((T, M), 0.0, f32), "n_nodes": full((T,), 0, i32),
            "wlog": full((T, wave_log_rows(M), 5), 0.0, f32),
        }
        rounds = self.params.round_num
        return bufs, full((rounds,), 0.0, f32), full((rounds,), 0.0, f32)

    # -- the round loop -----------------------------------------------------

    def _sample_masks(self, rnd: int, dd: _DevInputs):
        """This round's (include, feat_mask, GOSS key) from its key
        fold_in(PRNGKey(ROOT_SEED), rnd) split into kf, ki, kg (reference
        trainer.py:704-724). The keys stay on the CPU (no device sync);
        the row draw runs on the device, the feature draw (over the
        engine-visible, possibly bundled, columns) on the CPU. A round
        that samples nothing derives no key."""
        p = self.params
        include = dd.real_mask
        goss_on = 0.0 < self.goss[0] < 1.0
        if (p.instance_sample_rate >= 1.0 and p.feature_sample_rate >= 1.0
                and not goss_on):
            return include, torch.ones(dd.F, dtype=torch.bool,
                                       device=self.device), None
        kf, ki, kg = prng.split(prng.fold_in(prng.PRNGKey(ROOT_SEED), rnd),
                                3)
        if p.instance_sample_rate < 1.0:
            rate = float(np.float32(p.instance_sample_rate))
            include = include & (prng.uniform(ki, dd.n_score,
                                              device=self.device) <= rate)
        if p.feature_sample_rate < 1.0:
            rate = float(np.float32(p.feature_sample_rate))
            fmask = prng.uniform(kf, dd.F) <= rate
            fmask[0] |= ~fmask.any()
            fmask = fmask.to(self.device)
        else:
            fmask = torch.ones(dd.F, dtype=torch.bool, device=self.device)
        return include, fmask, prng.fold_in(kg, 0) if goss_on else None

    def _round(self, rnd: int, dd: _DevInputs, spec: GrowSpec, state):
        """grads -> one tree -> score and loss updates (reference
        trainer.py:697-767 with K = 1)."""
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        preds = self.loss.predict(scores)
        g, h = self.loss.grad_hess(preds, dd.y)
        include, fmask, key = self._sample_masks(rnd, dd)
        tr, pos, aux_pos, wlog = grow(
            spec, dd.bins_t, include, g * dd.weight, h * dd.weight,
            fmask, aux=dd.aux_bins, key=key, ranges=dd.ranges)
        if 0.0 < spec.goss_a < 1.0:
            # grow fitted the sampled rows; the train rows come back first
            pos, aux_pos = aux_pos[0], aux_pos[1:]
        leaf = tr.leaf
        scores = scores + leaf[pos.long()]
        if scores_t is not None:
            scores_t = scores_t + leaf[aux_pos[0].long()]
        for name in _TREE_FIELDS:
            bufs[name][rnd] = getattr(tr, name)
        bufs["n_nodes"][rnd] = tr.n_nodes
        bufs["wlog"][rnd] = wlog
        loss_buf[rnd] = _wavg_loss(self.loss, scores, dd.y, dd.weight)
        if scores_t is not None:
            tloss_buf[rnd] = _wavg_loss(self.loss, scores_t, dd.y_t, dd.w_t)
        return scores, scores_t, bufs, loss_buf, tloss_buf

    def _run_rounds(self, dd, spec, state, model, names, t0: float):
        """Every round ends in host reads already (one per wave), so the
        loss of a sync round is read right away; `sync_log` holds
        (round, seconds since train() began) at each sync."""
        p = self.params
        sync_every = max(1, p.round_num // 20)
        self.sync_log = []
        t_train0 = time.time()
        for rnd in range(p.round_num):
            state = self._round(rnd, dd, spec, state)
            if (rnd + 1) % sync_every == 0 or rnd == p.round_num - 1:
                tl = float(state[3][rnd])
                self.sync_log.append((rnd, time.time() - t0))
                msg = f"[round={rnd}] {time.time() - t0:.1f}s train loss={tl:.6f}"
                if state[1] is not None:
                    msg += f" test loss={float(state[4][rnd]):.6f}"
                log.info(msg)
            if p.model.dump_freq > 0 and (rnd + 1) % p.model.dump_freq == 0:
                self._append_trees_from_bufs(model, state[2], dd.bins, names,
                                             len(model.trees), rnd + 1)
                self._dump_model(model)
        ts = self.time_stats
        ts["train"] = time.time() - t_train0
        if self.sync_log:
            # skip the first sync window (it absorbs kernel builds)
            r0, s0 = (self.sync_log[1] if len(self.sync_log) >= 3
                      else self.sync_log[0])
            r1, s1 = self.sync_log[-1]
            if r1 > r0:
                ts["trees_per_sec_steady"] = (r1 - r0) * self.K / max(
                    s1 - s0, 1e-9)
        return state

    # -- entry --------------------------------------------------------------

    def train(self, train: Optional[GBDTData] = None,
              test: Optional[GBDTData] = None) -> GBDTResult:
        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        if train is None:
            train, test = GBDTIngest(p, self.fs).load()
        ts["load"] = time.time() - t0
        dd = self._prep_device_inputs(train, test)
        self.dev_inputs = dd  # kept for a caller that times the kernels
        ts["preprocess"] = time.time() - t0 - ts["load"]
        # GOSS sizes its counts on the real share of the padded rows
        spec = self._grow_spec(dd.F, dd.B, goss_scale=min(
            1.0, train.n_real / max(dd.n_score, 1)))
        self.grow_spec = spec
        base = self._base_score(train)
        # np.mean, as the reference takes it: a -0.0 base (sigmoid at 0.5)
        # is dumped as 0.0
        model = GBDTModel(base_prediction=float(np.mean(base)),
                          num_tree_in_group=1, obj_name=self.loss.name)
        scores = torch.full((dd.n_score,), float(base), dtype=torch.float32,
                            device=self.device)
        scores_t = (torch.full((dd.nt_score,), float(base),
                               dtype=torch.float32, device=self.device)
                    if dd.y_t is not None else None)
        bufs, loss_buf, tloss_buf = self._make_tree_bufs(spec.max_nodes)
        state = (scores, scores_t, bufs, loss_buf, tloss_buf)
        names = train.feature_names
        rounds = 0
        if not p.just_evaluate:
            state = self._run_rounds(dd, spec, state, model, names, t0)
            rounds = p.round_num
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        self.wave_log = bufs["wlog"].cpu().numpy()
        self._sampling_stats(ts, spec, train.n_features)
        t_fin = time.time()
        out = self._finalize(model, dd, state, names, rounds)
        ts["finalize"] = time.time() - t_fin
        return out

    def _sampling_stats(self, ts: Dict, spec: GrowSpec, F: int) -> None:
        """GOSS's kept rows a tree (the wave log's column 4 at the root
        pass, reference trainer.py:880-891) and the columns EFB saved."""
        wl = self.wave_log
        goss_on = 0.0 < spec.goss_a < 1.0
        ts["goss"] = goss_on
        if goss_on:
            used = (wl[..., 3] > 0).any(axis=-1)
            ts["goss_a"] = float(spec.goss_a)
            ts["goss_b"] = float(spec.goss_b)
            ts["goss_rows_per_tree"] = float(
                (wl[:, 0, 4] * used).sum() / max(float(used.sum()), 1.0))
        if self._efb_plan is not None:
            ts["efb_cols_saved"] = float(F - self._efb_plan.n_cols)

    # -- trees and the dump ---------------------------------------------------

    def _append_trees_from_bufs(self, model: GBDTModel, bufs,
                                bins: FeatureBins, names, have: int,
                                want: int) -> None:
        """Convert device tree buffers [have, want) into host Trees (one
        device->host fetch)."""
        if want <= have:
            return
        host = {k: v[have:want].cpu().numpy() for k, v in bufs.items()
                if k != "wlog"}
        for i in range(want - have):
            model.trees.append(self._arrays_to_tree(
                {k: v[i] for k, v in host.items()}, bins, names))

    def _arrays_to_tree(self, d: Dict[str, np.ndarray], bins, names) -> Tree:
        nn = int(d["n_nodes"])
        t = Tree()
        t.feat = [int(v) for v in d["feat"][:nn]]
        t.slot = [int(v) for v in d["slot"][:nn]]
        t.split = [float(v) for v in d["slot_r"][:nn]]  # slot space for now
        t.left = [int(v) for v in d["left"][:nn]]
        t.right = [int(v) for v in d["right"][:nn]]
        t.default_left = [True] * nn
        t.leaf_value = [float(v) for v in d["leaf"][:nn]]
        t.gain = [float(v) for v in d["gain"][:nn]]
        t.hess_sum = [float(v) for v in d["hess"][:nn]]
        t.sample_cnt = [int(round(float(v))) for v in d["cnt"][:nn]]
        if self._efb_plan is not None:
            # bundle columns and slots -> original features, before names
            # and values: the dump reads as an unbundled run's
            unbundle_tree(t, self._efb_plan)
        t.feat_name = [
            (names[f] if (names and 0 <= f < len(names)) else str(f))
            if f >= 0 else ""
            for f in t.feat
        ]
        self._convert_tree(t, bins)
        return t

    def _convert_tree(self, tree: Tree, bins: FeatureBins) -> None:
        """Slot interval -> real split value + default direction
        (reference: GBDTOptimizer.convertModel:669 + addDefaultDirection)."""
        st = self.params.split_type
        for nid in range(tree.n_nodes()):
            if tree.is_leaf(nid):
                continue
            fid = tree.feat[nid]
            cond = bins.split_value(fid, tree.slot[nid],
                                    int(tree.split[nid]), split_type=st)
            tree.split[nid] = cond
            if self._missing_fill is not None:
                tree.default_left[nid] = bool(self._missing_fill[fid] <= cond)

    def _dump_model(self, model: GBDTModel) -> None:
        """Sidecar first, then the model text (atomic), then the feature
        importance file: a fingerprint-watch reload of the model always
        finds edges at least as fresh."""
        p = self.params
        if not p.model.data_path:
            raise ValueError("model.data_path is required to dump the model")
        model_text = model.dumps(with_stats=True)
        digest = model_text_digest(model_text)
        if self._bins_sidecar is not None:
            names, bins = self._bins_sidecar
            if len(names) == len(bins.counts):
                dump_bin_edges(self.fs, bin_edges_path(p.model.data_path),
                               names, bins, split_type=p.split_type,
                               model_digest=digest)
        with self.fs.atomic_open(p.model.data_path) as f:
            f.write(model_text)
        if p.model.feature_importance_path:
            imp = model.feature_importance()
            with self.fs.atomic_open(p.model.feature_importance_path) as f:
                f.write("feature_name\tsum_split_count\tsum_gain\n")
                for name, (cnt, gain) in imp.items():
                    f.write(f"{name}\t{cnt}\t{gain}\n")

    def _finalize(self, model, dd: _DevInputs, state, names, rounds: int
                  ) -> GBDTResult:
        p = self.params
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        self._append_trees_from_bufs(model, bufs, dd.bins, names,
                                     len(model.trees), rounds)
        if not p.just_evaluate:
            self._dump_model(model)
        res = GBDTResult(
            model=model,
            train_loss=float(_wavg_loss(self.loss, scores, dd.y, dd.weight)),
            test_loss=(float(_wavg_loss(self.loss, scores_t, dd.y_t, dd.w_t))
                       if scores_t is not None else None),
        )
        loss_np = loss_buf.cpu().numpy()
        tloss_np = tloss_buf.cpu().numpy()
        for rnd in range(rounds):
            rec = {"round": rnd, "train_loss": float(loss_np[rnd])}
            if scores_t is not None:
                rec["test_loss"] = float(tloss_np[rnd])
            res.round_log.append(rec)
        if p.eval_metric:
            ev = EvalSet(p.eval_metric)
            res.train_metrics = ev.evaluate(self.loss.predict(scores), dd.y,
                                            dd.weight)
            if scores_t is not None:
                res.test_metrics = ev.evaluate(self.loss.predict(scores_t),
                                               dd.y_t, dd.w_t)
        self.final_scores = (scores, scores_t)
        return res


def _wavg_loss(loss, scores, y, weight) -> torch.Tensor:
    per = torch.where(weight > 0, loss.loss(scores, y),
                      torch.zeros_like(scores))
    return torch.sum(weight * per) / torch.clamp_min(torch.sum(weight), 1e-12)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
