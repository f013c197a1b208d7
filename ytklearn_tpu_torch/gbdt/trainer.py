"""GBDT boosting trainer: the device engine, and the host engine's entry.

The counterpart of the device path of ``ytklearn_tpu/gbdt/trainer.py``
(reference optimizer/GBDTOptimizer.java:174-530):

    GBDTTrainer(params, hist_precision="bf16"|"f32"|"int8", device=...)
        .train(train=GBDTData, test=GBDTData) -> GBDTResult
    GBDTTrainer(params).train()  # loads data.train/test through GBDTIngest

Per round: predictions -> (g, h) -> K trees grown by engine.grow on the
device, one a class group (K = class_num under softmax, else 1; histogram
kernels K1/K3 in bf16 or f32, the JAX trainer's default bf16, or K2/K4 in
int8; routing kernel K5) -> score and loss updates. Each round's key is
fold_in(PRNGKey(20170425), round), split into the feature, row and GOSS
keys (gbdt.prng, bit for bit the JAX trainer's draws), drawn once a round:
`instance_sample_rate` and `feature_sample_rate` below 1 mask rows and
columns, and GOSS (`goss=(a, b)`, a < 1) grows each group's tree on its
sampled fit rows with the key fold_in(kg, group). Under l1 every tree's
leaves are refined to lr times the weighted median of the residual y -
score over the leaf's rows, on a rank grid of 4096 sorted residuals
(`_lad_refine`, the reference's approximate LAD, `lad_refine_appr`).
EFB (`efb`, the `YTK_EFB` knob, on by default) bundles mutually exclusive
sparse columns into offset-binned columns before the bin matrix reaches
the device; the plan stays on the host, the engine takes its range tables
and every grown tree is unbundled back to the original features before its
value conversion. `model.continue_train` resumes from the dumped model:
its split names resolve against this run's columns, its trees are replayed
on the (pre-bundle) bin matrix into the starting scores, and training
starts at round len(trees) // K.
Tree arrays stay in whole-run device buffers (round_num * K trees) and are
fetched once at the end (and at `dump_freq` checkpoints). Binning runs on
the device for one sample_by_quantile spec, on the host for any other
(gbdt/binning.py). The model text, its `.bins.json` sidecar and the feature
importance file are the JAX trainer's, byte for byte for the same trees.

The weighted gradients of rows of weight 0 (the padding rows among them)
are 0: the reference multiplies, which leaves NaN where a loss's gradient
is infinite at the padding rows' label 0 (mape), and NaN reaches every
histogram.

`engine="host"`, and what the reference's `engine="auto"` sends there
(precise LAD, `lad_refine_appr = false` under l1, and `tree_maker =
"feature"`), train on the host engine (gbdt/host_engine.py).

`train()` runs under the preemption guard (resilience/preempt.py): a
SIGTERM or SIGINT is deferred to the next round start of either engine,
where the finished rounds' trees are dumped through the atomic dump and
`Preempted` is raised; `continue_train` (`--resume auto`) then re-enters
at that round, and the device engine's result equals the uninterrupted
run's byte for byte. A sync round's loss read is the `gbdt.sync` chaos
site.

Runs on `cuda` unless the caller passes `device="cpu"` (the kernels' plain
versions). Trees of any size and features of any bin width train: past
the histogram kernels' shared-memory node lookup they take its global
kind, and past one shared-memory tile of bins their tiles hold ranges of
bins (gbdt/hist.py).

Ranks (`mesh`, a parallel.Mesh; reference trainer.py:250-263, :284-326,
:343-348, :445-549, :1212-1230, :1544-1565, :1837). Each rank trains on
its contiguous row shard, padded so the shards are equal (BM_DEFAULT rows
a rank on the card, 8 on the CPU), through engine.grow's sharded path;
the feature axis pads to a multiple of the world with masked all-zero
columns. With one rank (and one ingesting process) the bins are built on
the device as above; with more, on the host: `--devices` (shared ingest)
builds them once over every row (or takes the launcher's, with its EFB
plan), `--coordinator` merges each process's through build_bins_global,
and turns EFB off loudly (`gbdt.efb.downgrade`). The row draw is the
global one, sliced; the base score is the global weighted mean; the
losses, the LAD refine, the eval metrics and the quality sidecar's score
block see every rank's rows; a continue_train model is read on process 0
and handed to the others; a preemption is agreed on by every rank at the
round start; only rank 0 dumps. The host engine runs under `--devices`
only, each rank on the whole data (rows padded to a multiple of the
world, as the reference's one-process mesh does), and `tree_maker =
"feature"` there grows with the column-sharded maker
(gbdt/feature_parallel.py); under `--coordinator` it is refused, as in
the reference.

Observability (the JAX trainer's): the device engine's run is four
profiler phases (obs/profiler.py), `gbdt.load` (when train() loads the
data), `gbdt.preprocess`, `gbdt.train` (capture=True: with a capture dir,
a torch.profiler trace of the rounds) and `gbdt.finalize`, each followed
by `health.record_memory`; the spans `gbdt.round` (one a round),
`gbdt.sync` (one a sync read) and `gbdt.efb.plan`; `time_stats` mirrored
into the `gbdt.stat.*` gauges. There is no `gbdt.compile` phase: the port
has no compile probe, so the kernel libraries' loads and the kernels'
first launches (a "compile" here, obs/health.py) happen in the first
round and land in the build ledger under the label `gbdt.round`. The
retrace sentinel arms at the first sync and checks at each later one.
YTK_PROFILE_DIR writes a torch.profiler trace of the rounds (skipped and
counted when another capture holds the profiler), closed at a
preemption too.

Every dump writes the model-quality sidecar `<model>.sketch.json`
(obs/quality.py) before the model text, as the JAX trainer does: per-
feature GK summaries and presence rates of the training matrix, built at
binning time, and, at the final dump, the score distribution of the
held-out set (else of the training rows). A served model is judged
against it by the drift monitor.
"""

from __future__ import annotations

import logging
import signal
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
from ..losses import GBDT_TRAINABLE, create_loss
from ..obs import event as obs_event, gauge as obs_gauge, health, \
    inc as obs_inc, profiler, span as obs_span
from ..parallel import collectives as coll
from ..parallel.mesh import equal_row_target, local_rows, put_row_sharded
from ..obs.quality import (
    build_score_block,
    build_training_sketch,
    dump_quality_sidecar,
    quality_sidecar_path,
)
from ..resilience import chaos_point, trainer_guard
from . import prng
from .engine import GrowSpec, grow, make_gain_fns, ordered_cumsum, \
    wave_log_rows
from .binning import (
    BundlePlan,
    FeatureBins,
    bin_edges_path,
    bin_matrix_device,
    build_bins_global,
    build_bins_maybe_device,
    build_bundle_plan,
    bundle_bin_matrix_t,
    dump_bin_edges,
    model_text_digest,
)
from .data import GBDTData, GBDTIngest, to_tensor
from .hist import BM_DEFAULT
from .host_engine import HostEngine
from .tree import GBDTModel, Tree, unbundle_tree

log = logging.getLogger("ytklearn_tpu_torch.gbdt")

#: the root of every run's key chain (the JAX trainer's, trainer.py:938)
ROOT_SEED = 20170425
#: rank-grid resolution of the approximate LAD refine (trainer.py:1914)
LAD_Q = 4096

_TREE_FIELDS = ("feat", "slot", "slot_r", "left", "right", "leaf", "gain",
                "hess", "cnt")


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
    # the engine's feature axis: F padded to a multiple of the world
    F_prog: int = 0
    # the share of real rows among the padded ones GOSS sizes on
    goss_scale: float = 1.0
    # continue_train with EFB: the pre-bundle (F, n_pad) bins of the train
    # (and test) rows for the score replay, freed right after it
    replay_bins: Optional[list] = None


@dataclass
class GBDTResult:
    model: GBDTModel
    train_loss: float
    test_loss: Optional[float]
    train_metrics: Dict[str, float] = field(default_factory=dict)
    test_metrics: Dict[str, float] = field(default_factory=dict)
    round_log: List[Dict] = field(default_factory=list)


class GBDTTrainer(HostEngine):
    _guard = None  # PreemptionGuard while train() runs

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
        transform_hook=None,
    ):
        self.params = params
        self.device = resolve_device(device)
        self.fs = fs or LocalFileSystem()
        self.transform_hook = transform_hook  # for train() without data
        p = params
        self.mesh = mesh
        if mesh is not None and device is None:
            self.device = resolve_device(mesh.device)
        #: set by the --devices launcher: (FeatureBins, BundlePlan or None)
        #: built once over every row
        self.shared_prep = None
        if engine not in ("auto", "device", "host"):
            raise ValueError(f"engine must be auto|device|host, got {engine!r}")
        self.K = p.num_tree_in_group
        if engine == "auto":
            # the reference's rule (trainer.py:198-209): precise LAD and the
            # feature-parallel maker run on the host engine
            precise_lad = (p.loss_function == "l1" and self.K == 1
                           and not p.lad_refine_appr)
            engine = ("host" if precise_lad or p.tree_maker == "feature"
                      else "device")
        self.engine = engine
        if hist_precision is None:
            hist_precision = "bf16" if use_bf16_hist else "f32"
        if hist_precision not in ("bf16", "f32", "int8"):
            raise ValueError(
                f"hist_precision must be bf16|f32|int8, got {hist_precision!r}"
            )
        self.hist_precision = hist_precision
        self.use_bf16_hist = hist_precision != "f32"
        self.loss = create_loss(p.loss_function,
                                {"sigmoid_zmax": p.sigmoid_zmax})
        if self.loss.name not in GBDT_TRAINABLE or (
                self.loss.is_multiclass and self.K < 2):
            raise ValueError(
                f"loss {self.loss.name!r} (class_num {p.class_num}) cannot "
                "train a GBDT: the trainer takes the scalar losses and "
                "softmax with class_num > 1")
        _gain, self.node_value_fn = make_gain_fns(*self._cfg())
        self.refine_lad = self.loss.name == "l1" and self.K == 1
        if self.refine_lad and not p.lad_refine_appr and engine == "device":
            log.warning("lad_refine_appr=false asks for the precise refine, "
                        "which only the host engine runs; the device "
                        "engine refines on the approximate rank grid")
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
        if a < 1.0 and engine == "host":
            log.warning("GOSS (goss_a=%.3f) is a device-engine feature; the "
                        "host engine trains unsampled", a)
        self.efb = knobs.get_bool("YTK_EFB") if efb is None else bool(efb)
        if self.efb and engine == "host":
            # a warning only when asked for: the knob is on by default
            (log.warning if efb else log.info)(
                "EFB is a device-engine feature; the host engine trains on "
                "the unbundled bin matrix")
        self._efb_plan: Optional[BundlePlan] = None
        self._missing_fill = None
        self._bins_sidecar = None
        self._quality_features: Optional[dict] = None
        self._quality_scores: Optional[np.ndarray] = None
        self.sync_log: List[Tuple[int, float]] = []
        self.time_stats: Dict[str, float] = {}

    def _cfg(self):
        p = self.params
        return (p.l1, p.l2, p.min_child_hessian_sum, p.max_abs_leaf_val)

    @property
    def _world(self) -> int:
        return 1 if self.mesh is None else self.mesh.world

    @property
    def _n_proc(self) -> int:
        """Processes with an ingest of their own (jax.process_count)."""
        m = self.mesh
        return 1 if m is None or m.shared_ingest else m.world

    @property
    def _is_rank0(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

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
        # rows are the first axis: (n,) weights, (n,) or (n, K) labels
        pad = (0, 0) * (t.dim() - 1) + (0, n_pad - t.shape[0])
        return torch.nn.functional.pad(t, pad)

    def _transposed(self, X) -> torch.Tensor:
        return to_tensor(X, torch.float32, self.device).t().contiguous()

    def _bin_rows(self, X_t: torch.Tensor, bins: FeatureBins, B: int,
                  keep_raw: bool = False):
        """(F, n) raw values -> (F or bundled columns, n_pad) bins, rows
        zero-padded to a multiple of 16384 before binning, as the
        reference does; with keep_raw also the pre-bundle (F, n_pad) bins
        (None without an EFB plan)."""
        n = X_t.shape[1]
        n_pad = -(-n // BM_DEFAULT) * BM_DEFAULT
        Xp = torch.nn.functional.pad(X_t, (0, n_pad - n)).contiguous()
        bins_t = raw = bin_matrix_device(Xp, bins)
        if self._efb_plan is not None:
            bins_t = bundle_bin_matrix_t(raw, self._efb_plan)
        if B <= 256:
            bins_t = bins_t.to(torch.uint8)
        keep = keep_raw and self._efb_plan is not None
        return bins_t, n_pad, raw if keep else None

    def _prep_device_inputs(self, train: GBDTData, test: Optional[GBDTData]
                            ) -> _DevInputs:
        if self._world == 1 and self._n_proc == 1:
            return self._prep_single(train, test)
        return self._prep_ranks(train, test)

    def _prep_single(self, train: GBDTData, test: Optional[GBDTData]
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
            with obs_span("gbdt.efb.plan", F=X_t.shape[0]):
                self._efb_plan = build_bundle_plan(X_t, bins, budget, B)
            if self._efb_plan is not None:
                log.info("EFB: %s (conflict budget %d)",
                         self._efb_plan.summary(), budget)
        plan = self._efb_plan
        self._bins_sidecar = (list(train.feature_names or []), bins)
        self._quality_features = self._build_quality_features(train)
        # a resumed model's trees split on original features: with EFB its
        # score replay walks the pre-bundle matrices (trainer.py:462, :508)
        resume = p.model.continue_train
        bins_t, n_pad, raw = self._bin_rows(X_t, bins, B, keep_raw=resume)
        del X_t
        replay = [raw] if raw is not None else None
        y = self._pad_rows(train.y, n_pad)
        weight = self._pad_rows(train.weight, n_pad)
        real_mask = torch.arange(n_pad, device=self.device) < train.n
        aux_bins, y_t, w_t, nt_pad = (), None, None, 0
        if test is not None:
            bt, nt_pad, raw_t = self._bin_rows(self._transposed(test.X), bins,
                                               B, keep_raw=resume)
            aux_bins = (bt,)
            if replay is not None:
                replay.append(raw_t)
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
            replay_bins=replay, F_prog=bins_t.shape[0],
            goss_scale=min(1.0, train.n_real / max(n_pad, 1)),
        )

    def _prep_ranks(self, train: GBDTData, test: Optional[GBDTData]
                    ) -> _DevInputs:
        """This rank's inputs: host bins (the launcher's, or
        build_bins_global), the EFB plan (off under --coordinator), and
        the rank's padded row shard binned on its device (reference
        trainer.py:445-549)."""
        p = self.params
        mesh = self.mesh
        self._missing_fill = train.missing_fill
        names = train.feature_names
        F = train.n_features
        X = _host(train.X)
        w_np = np.ascontiguousarray(_host(train.weight), np.float32)
        if self.shared_prep is not None:
            bins, plan = self.shared_prep
        else:
            log.info("building bins (%d features)...", F)
            bins = build_bins_global(X[: train.n], w_np, p, names)
            plan = None
        B_real = bins.max_bins
        B = max(8, 1 << (B_real - 1).bit_length())
        if self.efb and self._n_proc > 1:
            log.warning("EFB disabled: multi-process runs would need a "
                        "cross-process conflict merge; training unbundled")
            obs_inc("gbdt.efb.downgrade")
            obs_event("gbdt.efb.downgrade", reason="multi_process")
            plan = None
        elif self.efb and self.shared_prep is None:
            budget = knobs.get_int("YTK_EFB_CONFLICT")
            with obs_span("gbdt.efb.plan", F=F):
                plan = build_bundle_plan(
                    torch.from_numpy(np.ascontiguousarray(X.T)), bins,
                    budget, B)
        elif not self.efb:
            plan = None
        if plan is not None:
            log.info("EFB: %s", plan.summary())
        self._efb_plan = plan
        self._bins_sidecar = (list(names or []), bins)
        # only rank 0 dumps, so only rank 0 sketches the training rows
        self._quality_features = (self._build_quality_features(train)
                                   if self._is_rank0 else None)
        F_cols = plan.n_cols if plan is not None else F
        F_prog = -(-F_cols // mesh.world) * mesh.world
        resume = p.model.continue_train
        mult = BM_DEFAULT if self.device.type == "cuda" else 8

        def shard(Xs, n_rows):
            """(this rank's bins (F_prog, n_loc), pre-bundle bins or None,
            global row offset, n_loc, the padded row count). Only the
            rank's rows of X are read and binned."""
            n_pad = equal_row_target(n_rows, mesh, mult)
            lo, hi = (local_rows(n_pad, mesh) if mesh.shared_ingest
                      else (0, n_pad))
            real = max(0, min(hi, n_rows) - lo)
            Xr = to_tensor(np.asarray(Xs[lo: lo + real]), torch.float32,
                           self.device).t().contiguous()
            raw = bin_matrix_device(Xr, bins)
            del Xr
            bt = bundle_bin_matrix_t(raw, plan) if plan is not None else raw
            # padded rows and padded features: bin 0 (reference pad_inputs)
            bt = torch.nn.functional.pad(
                bt, (0, (hi - lo) - real, 0, F_prog - bt.shape[0]))
            if B <= 256:
                bt = bt.to(torch.uint8)
            keep = None
            if resume and plan is not None:
                keep = torch.nn.functional.pad(raw, (0, (hi - lo) - real))
            return bt, keep, lo, hi - lo, n_pad

        def rows(a, n_pad):
            """This rank's rows of a per-row array padded with zeros."""
            a = np.asarray(_host(a), np.float32)
            pad = ((0, n_pad - a.shape[0]),) + ((0, 0),) * (a.ndim - 1)
            return put_row_sharded(np.pad(a, pad), mesh)

        bins_t, raw, lo, n_loc, n_pad = shard(X, train.n)
        del X
        replay = [raw] if raw is not None else None
        y = rows(train.y, n_pad)
        weight = rows(train.weight, n_pad)
        idx = torch.arange(n_loc, device=self.device) + lo
        real_mask = idx < train.n_real
        aux_bins, y_t, w_t, nt_loc = (), None, None, 0
        if test is not None:
            bt, raw_t, _lo, nt_loc, nt_pad = shard(_host(test.X), test.n)
            aux_bins = (bt,)
            if replay is not None:
                replay.append(raw_t)
            y_t = rows(test.y, nt_pad)
            w_t = rows(test.weight, nt_pad)
        log.info("rank %d of %d: rows [%d, %d) of %d, %d features (%d "
                 "engine columns), %d bins (pad %d), backend %s", mesh.rank,
                 mesh.world, lo, lo + n_loc, train.n, F, F_prog, B_real, B,
                 mesh.backend)
        ranges = None
        if plan is not None:
            ranges = tuple(torch.from_numpy(r).to(self.device)
                           for r in plan.range_tables(B, F_pad=F_prog))
        # GOSS sizes on the real share of the padded rows: the global
        # share under one ingest, this process's under --coordinator
        n_ingest = n_loc * (mesh.world if mesh.shared_ingest else 1)
        return _DevInputs(
            bins=bins, bins_t=bins_t, y=y, weight=weight,
            real_mask=real_mask, n_score=n_loc, F=F_cols, B=B,
            aux_bins=aux_bins, y_t=y_t, w_t=w_t, nt_score=nt_loc,
            ranges=ranges, replay_bins=replay, F_prog=F_prog,
            goss_scale=min(1.0, train.n_real / max(n_ingest, 1)),
        )

    def _base_score(self, train: GBDTData) -> np.ndarray:
        """The starting score: pred2score of the weighted label mean (per
        class under softmax) or of uniform_base_prediction (reference
        trainer.py:1211-1246)."""
        p = self.params
        if p.sample_dependent_base_prediction and self._n_proc > 1:
            # the global weighted label mean over the process shards
            w = _host(train.weight)[: train.n_real]
            y = np.asarray(_host(train.y)[: train.n_real])
            wy = ((w[:, None] * y).sum(axis=0) if self.K > 1
                  else float(np.dot(w, y)))
            merged = coll.host_allgather_objects((wy, float(np.sum(w))))
            mean = np.sum([m[0] for m in merged], axis=0) / max(
                float(np.sum([m[1] for m in merged])), 1e-12)
            if self.K > 1:
                return np.asarray(self.loss.pred2score(mean), np.float32)
            return np.float32(self.loss.pred2score(float(mean)))
        if p.sample_dependent_base_prediction:
            # in the arrays' own dtype, as the reference averages
            y = _host(train.y)[: train.n_real]
            w = _host(train.weight)[: train.n_real]
            if self.K > 1:
                mean = np.average(y, axis=0, weights=w)
                return np.asarray(self.loss.pred2score(mean), np.float32)
            return np.float32(self.loss.pred2score(
                float(np.average(y, weights=w))))
        return np.float32(self.loss.pred2score(p.uniform_base_prediction))

    def _init_scores(self, model: GBDTModel, dd: _DevInputs, base
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Base scores, (n,) or (n, K), plus a resumed model's trees
        replayed tree by tree on the train and test bins (reference
        trainer.py:605-643); the pre-bundle replay matrices go after."""
        K = self.K
        base_t = torch.as_tensor(np.asarray(base, np.float32),
                                 device=self.device)

        def full(n):
            return base_t.expand((n, K) if K > 1 else (n,)).clone()

        scores = full(dd.n_score)
        scores_t = full(dd.nt_score) if dd.y_t is not None else None
        if model.trees:
            if dd.replay_bins is not None:
                sets = list(dd.replay_bins)
            else:
                sets = [dd.bins_t] + list(dd.aux_bins[:1])
            for i, t in enumerate(model.trees):
                add = self._tree_scores_from_raw(t, dd.bins, sets[0])
                if K > 1:
                    scores[:, i % K] += add
                else:
                    scores = scores + add
                if scores_t is not None:
                    add_t = self._tree_scores_from_raw(t, dd.bins, sets[1])
                    if K > 1:
                        scores_t[:, i % K] += add_t
                    else:
                        scores_t = scores_t + add_t
            del sets
        dd.replay_bins = None  # free the pre-bundle matrices
        return scores, scores_t

    def _tree_scores_from_raw(self, tree: Tree, bins: FeatureBins,
                              bins_t: torch.Tensor) -> torch.Tensor:
        """A converted (value-space) tree's leaf value for every column of
        the (F, n) bin matrix: each split's slot re-derived from its value
        (the last representative <= the split), then a fixed-depth walk in
        which leaves hold (reference trainer.py:1754)."""
        nn = tree.n_nodes()
        slot = np.full(nn, -1, np.int32)
        for nid in range(nn):
            if tree.is_leaf(nid):
                continue
            fid = tree.feat[nid]
            v = bins.values[fid, : int(bins.counts[fid])]
            slot[nid] = int(np.searchsorted(v, tree.split[nid],
                                            side="right")) - 1
        dev = bins_t.device

        def t32(a, dt=torch.int32):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        feat, slot_t = t32(tree.feat), t32(slot)
        left, right = t32(tree.left), t32(tree.right)
        leaf = t32(np.asarray(tree.leaf_value, np.float32), torch.float32)
        node = torch.zeros(bins_t.shape[1], dtype=torch.long, device=dev)
        for _ in range(max(tree.max_depth(), 1)):
            f = feat[node]
            b = bins_t.gather(0, f.clamp_min(0).long()[None])[0].to(
                torch.int32)
            nxt = torch.where(b <= slot_t[node], left[node], right[node])
            node = torch.where(f < 0, node, nxt.long())
        return leaf[node]

    def _load_resume_model(self, model: GBDTModel, names
                           ) -> Tuple[GBDTModel, int]:
        """continue_train: the dumped model at model.data_path, its split
        names resolved against this run's columns (an unknown name raises:
        resuming on different data), and the round to start at,
        len(trees) // K (reference trainer.py:269-312). No dump: a fresh
        run."""
        p = self.params
        if not p.model.continue_train:
            return model, 0

        def read():
            if not self.fs.exists(p.model.data_path):
                return None
            with self.fs.open(p.model.data_path) as f:
                return f.read()

        # process 0 reads and hands its text on: the dumps are rank 0's,
        # so another process's storage may not hold them
        text = coll.load_on_rank0(read)
        if text is None:
            return model, 0
        model = GBDTModel.loads(text)
        if names:
            index = {n: i for i, n in enumerate(names)}
            for t in model.trees:
                for nid in range(t.n_nodes()):
                    if t.is_leaf(nid):
                        continue
                    fid = index.get(t.feat_name[nid])
                    if fid is not None:
                        t.feat[nid] = fid
                    elif not t.feat_name[nid].isdigit():
                        raise ValueError(
                            f"continue_train: dumped split feature "
                            f"{t.feat_name[nid]!r} is not in this run's "
                            "feature set (resuming on different data?)")
        log.info("continue_train: loaded %d trees", len(model.trees))
        return model, len(model.trees) // self.K

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

    def _round_keys(self, rnd: int):
        """kf, ki, kg: this round's key fold_in(PRNGKey(ROOT_SEED), rnd)
        split in three (reference trainer.py:704). They stay on the CPU."""
        return prng.split(prng.fold_in(prng.PRNGKey(ROOT_SEED), rnd), 3)

    def _goss_key(self, rnd: int, grp: int):
        """Group `grp`'s GOSS key fold_in(kg, grp), or None with GOSS off."""
        if not 0.0 < self.goss[0] < 1.0:
            return None
        return prng.fold_in(self._round_keys(rnd)[2], grp)

    def _sample_masks(self, rnd: int, dd: _DevInputs):
        """This round's (include, feat_mask), drawn once for the round's K
        trees (reference trainer.py:704-724). The row draw runs on the
        device, the feature draw (over the engine-visible, possibly
        bundled, columns) on the CPU. A round that samples no rows or
        features derives no key."""
        p = self.params
        include = dd.real_mask
        pad = dd.F_prog - dd.F  # padded features are never sampled
        if p.instance_sample_rate >= 1.0 and p.feature_sample_rate >= 1.0:
            fmask = torch.ones(dd.F, dtype=torch.bool, device=self.device)
            return include, torch.nn.functional.pad(fmask, (0, pad))
        kf, ki, _ = self._round_keys(rnd)
        if p.instance_sample_rate < 1.0:
            rate = float(np.float32(p.instance_sample_rate))
            # the global draw over every rank's rows, this rank's slice
            lo = (0 if self.mesh is None else self.mesh.rank) * dd.n_score
            u = prng.uniform(ki, dd.n_score * self._world,
                             device=self.device)[lo: lo + dd.n_score]
            include = include & (u <= rate)
        if p.feature_sample_rate < 1.0:
            rate = float(np.float32(p.feature_sample_rate))
            fmask = prng.uniform(kf, dd.F) <= rate
            fmask[0] |= ~fmask.any()
            fmask = fmask.to(self.device)
        else:
            fmask = torch.ones(dd.F, dtype=torch.bool, device=self.device)
        return include, torch.nn.functional.pad(fmask, (0, pad))

    def _round(self, rnd: int, dd: _DevInputs, spec: GrowSpec, state):
        """grads -> K trees, one a class group on its column of g and h ->
        score and loss updates (reference trainer.py:697-770)."""
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        K = self.K
        gs, hs = self.loss.grad_hess(self.loss.predict(scores), dd.y)
        include, fmask = self._sample_masks(rnd, dd)
        live = dd.weight > 0
        for grp in range(K):
            g = gs[:, grp] if K > 1 else gs
            h = hs[:, grp] if K > 1 else hs
            tr, pos, aux_pos, wlog = grow(
                spec, dd.bins_t, include,
                torch.where(live, g * dd.weight, 0.0),
                torch.where(live, h * dd.weight, 0.0), fmask,
                aux=dd.aux_bins, key=self._goss_key(rnd, grp),
                ranges=dd.ranges, mesh=self.mesh)
            if 0.0 < spec.goss_a < 1.0:
                # grow fitted the sampled rows; the train rows come back first
                pos, aux_pos = aux_pos[0], aux_pos[1:]
            if self.refine_lad:
                # the medians are global: every rank refines on every row
                tr = tr._replace(leaf=_lad_refine(
                    tr, *(self._gather(a) for a in (
                        pos, dd.y, scores, dd.weight, dd.real_mask)),
                    self.params.learning_rate))
            # in place: the round's gradients are taken already
            (scores[:, grp] if K > 1 else scores).add_(tr.leaf[pos.long()])
            if scores_t is not None:
                (scores_t[:, grp] if K > 1 else scores_t).add_(
                    tr.leaf[aux_pos[0].long()])
            t_idx = rnd * K + grp
            for name in _TREE_FIELDS:
                bufs[name][t_idx] = getattr(tr, name)
            bufs["n_nodes"][t_idx] = tr.n_nodes
            bufs["wlog"][t_idx] = wlog
        loss_buf[rnd] = _wavg_loss(self.loss, scores, dd.y, dd.weight,
                                   self.mesh)
        if scores_t is not None:
            tloss_buf[rnd] = _wavg_loss(self.loss, scores_t, dd.y_t, dd.w_t,
                                        self.mesh)
        return scores, scores_t, bufs, loss_buf, tloss_buf

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of a row-sharded tensor, in rank order (the
        tensor itself without a mesh)."""
        if self.mesh is None:
            return t
        if t.dtype == torch.bool:
            return coll.all_gather(t.to(torch.uint8), self.mesh).bool()
        return coll.all_gather(t, self.mesh)

    def _preempt_now(self) -> bool:
        """The guard's flag, agreed on by every rank at a round start (a
        signal that reached one rank stops them all at the same round)."""
        hit = self._guard is not None and self._guard.triggered
        return hit if self.mesh is None else coll.any_rank(hit, self.mesh)

    def _watch_metrics(self, watch_eval, dd, state) -> str:
        """The watch flags' part of a sync line: the metrics of the train
        and (with a test set) test scores (reference trainer.py:1199-1208;
        the last round's are the finalized result's). Over ranks every
        rank adds its rows (a collective at the sync, on every rank)."""
        p, out = self.params, ""
        parts = []
        if p.watch_train:
            parts.append(("train", state[0], dd.y, dd.weight))
        if p.watch_test and state[1] is not None:
            parts.append(("test", state[1], dd.y_t, dd.w_t))
        for name, scores, y, w in parts:
            m = watch_eval.evaluate(self.loss.predict(scores), y, w,
                                    mesh=self.mesh)
            out += f" {name} " + " ".join(f"{k}={v:.6f}"
                                          for k, v in m.items())
        return out

    def _run_rounds(self, dd, spec, state, model, names, t0: float,
                    start: int = 0):
        """Every round ends in host reads already (one per wave), so the
        loss of a sync round is read right away; `sync_log` holds
        (round, seconds since train() began) at each sync."""
        p = self.params
        sync_every = max(1, (p.round_num - start) // 20)
        self.sync_log = []
        watch_eval = (EvalSet(p.eval_metric, K=max(self.K, 2))
                      if p.eval_metric and (p.watch_train or p.watch_test)
                      else None)
        # retrace alarm: the kernels are built and first launched in the
        # first round, so a build counted after the FIRST sync is an
        # unexpected one; with ytkprof on the sentinel arms and checks
        # with the round state's signature (late-binding over `state`)
        self._retrace = health.RetraceSentinel("gbdt.rounds")
        self._retrace_sig = (
            (lambda: profiler.abstract_signature(state))
            if profiler.enabled() else None
        )
        self._start_round_profile()
        t_train0 = time.time()
        for rnd in range(start, p.round_num):
            if self._preempt_now():
                # the round start is the safe preemption point: the dump
                # holds exactly the finished rounds, and the resumed run
                # re-enters at `rnd` (every round's key is round-indexed)
                self._preempt_checkpoint(model, state[2], dd.bins, names,
                                         rnd)
            with obs_span("gbdt.round", round=rnd), profiler.LEDGER.program(
                    "gbdt.round",
                    sig_fn=lambda: profiler.abstract_signature(state)):
                state = self._round(rnd, dd, spec, state)
            obs_inc("gbdt.rounds")
            if p.model.dump_freq > 0 and (rnd + 1) % p.model.dump_freq == 0:
                self._append_trees_from_bufs(model, state[2], dd.bins, names,
                                             len(model.trees),
                                             (rnd + 1) * self.K)
                self._dump_model(model)
            if (rnd + 1) % sync_every == 0 or rnd == p.round_num - 1:
                # after the round's dump, as the reference's lagged read
                # of the round before comes after that round's dump
                chaos_point("gbdt.sync")
                obs_inc("gbdt.syncs")
                with obs_span("gbdt.sync", round=rnd):
                    tl = float(state[3][rnd])
                self._health_sync(rnd, tl)
                self.sync_log.append((rnd, time.time() - t0))
                msg = f"[round={rnd}] {time.time() - t0:.1f}s train loss={tl:.6f}"
                if state[1] is not None:
                    msg += f" test loss={float(state[4][rnd]):.6f}"
                if watch_eval is not None and rnd != p.round_num - 1:
                    msg += self._watch_metrics(watch_eval, dd, state)
                log.info(msg)
        self._stop_round_profile()
        ts = self.time_stats
        ts["train"] = time.time() - t_train0
        if self.sync_log:
            # skip the first sync window (it absorbs kernel builds)
            r0, s0 = (self.sync_log[1] if len(self.sync_log) >= 3
                      else self.sync_log[0])
            r1, s1 = self.sync_log[-1]
            if r1 > r0:
                # trees, not rounds: K trees a round under softmax
                ts["trees_per_sec_steady"] = (r1 - r0) * self.K / max(
                    s1 - s0, 1e-9)
        return state

    def _preempt_checkpoint(self, model, bufs, bins, names, rnd: int
                            ) -> None:
        """Emergency checkpoint at round start `rnd`: the finished rounds'
        trees from the buffers, dumped, then Preempted (reference
        trainer.py:1143)."""
        self._append_trees_from_bufs(model, bufs, bins, names,
                                     len(model.trees), rnd * self.K)
        self._dump_model(model)
        # the Preempted raise skips the post-loop stop: close the rounds'
        # trace here or the very run being profiled loses it
        self._stop_round_profile()
        if self._guard is None or not self._guard.triggered:
            # a peer rank's signal: stop at the same round as it does
            from ..resilience import Preempted

            raise Preempted(int(signal.SIGTERM), self.params.model.data_path)
        self._guard.preempt(self.params.model.data_path, family="gbdt",
                            rounds=rnd, trees=len(model.trees))

    def _start_round_profile(self) -> None:
        """YTK_PROFILE_DIR: a torch.profiler trace of the rounds, when the
        process's one profiler slot is free (else skipped and counted)."""
        profile_dir = knobs.get_str("YTK_PROFILE_DIR")
        self._round_cap = (profiler.start_capture(profile_dir,
                                                  "YTK_PROFILE_DIR")
                           if profile_dir else None)

    def _stop_round_profile(self) -> None:
        cap, self._round_cap = getattr(self, "_round_cap", None), None
        path = cap.stop() if cap is not None else None
        if path is not None:
            log.info("torch profiler trace of the rounds written to %s",
                     path)

    # -- entry --------------------------------------------------------------

    def train(self, train: Optional[GBDTData] = None,
              test: Optional[GBDTData] = None) -> GBDTResult:
        """Train on the engine chosen at construction, under the preemption
        guard."""
        with trainer_guard(self):
            if self.engine == "device":
                return self._train_device(train, test)
            if self._n_proc > 1:
                raise ValueError(
                    "multi-process GBDT training requires the device engine "
                    "(host-loop makers read per-row device state eagerly); "
                    f"got engine={self.engine!r}")
            return self._train_host(train, test)

    def _train_device(self, train: Optional[GBDTData],
                      test: Optional[GBDTData]) -> GBDTResult:
        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        health.install_trace_counters()
        if train is None:
            ingest = GBDTIngest(p, self.fs, transform_hook=self.transform_hook)
            with profiler.phase("gbdt.load"):
                train, test = ingest.load()
            ts["parser"] = ingest.parser
        ts["load"] = time.time() - t0
        health.record_memory("gbdt.load")
        with profiler.phase("gbdt.preprocess", F=train.n_features):
            dd = self._prep_device_inputs(train, test)
        health.record_memory("gbdt.preprocess")
        self.dev_inputs = dd  # kept for a caller that times the kernels
        ts["preprocess"] = time.time() - t0 - ts["load"]
        # GOSS sizes its counts on the real share of the padded rows
        spec = self._grow_spec(dd.F_prog, dd.B, goss_scale=dd.goss_scale)
        self.grow_spec = spec
        base = self._base_score(train)
        # np.mean, as the reference takes it: a -0.0 base (sigmoid at 0.5)
        # is dumped as 0.0
        model = GBDTModel(base_prediction=float(np.mean(base)),
                          num_tree_in_group=self.K, obj_name=self.loss.name)
        names = train.feature_names
        model, start = self._load_resume_model(model, names)
        scores, scores_t = self._init_scores(model, dd, base)
        bufs, loss_buf, tloss_buf = self._make_tree_bufs(spec.max_nodes)
        state = (scores, scores_t, bufs, loss_buf, tloss_buf)
        rounds = start
        if not p.just_evaluate:
            with profiler.phase("gbdt.train", capture=True,
                                rounds=p.round_num - start):
                state = self._run_rounds(dd, spec, state, model, names, t0,
                                         start)
            health.record_memory("gbdt.train")
            rounds = p.round_num
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        self.wave_log = bufs["wlog"].cpu().numpy()
        self._sampling_stats(ts, spec, train.n_features)
        t_fin = time.time()
        with profiler.phase("gbdt.finalize"):
            out = self._finalize(model, dd, state, names, start, rounds)
        ts["finalize"] = time.time() - t_fin
        health.record_memory("gbdt.finalize")
        # every scalar time_stat mirrored into the registry (gbdt.stat.*):
        # the one snapshot benchmarks and production runs report from
        for k, v in ts.items():
            if isinstance(v, (bool, int, float)):
                obs_gauge(f"gbdt.stat.{k}", float(v))
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

    def _health_sync(self, rnd: int, tl: float) -> None:
        """Sentinels at a sync read: a NaN/inf train loss (strict mode
        aborts the run with the flight-dump path) and the unexpected-
        rebuild alarm — armed at the first sync, checked at every later
        one."""
        if not health.enabled():
            return
        health.check_loss("gbdt.sync", tl, round=rnd)
        sig_fn = getattr(self, "_retrace_sig", None)
        sig = sig_fn() if sig_fn is not None else None
        if self._retrace.baseline is None:
            self._retrace.arm(sig=sig)
        else:
            self._retrace.check(sig=sig, round=rnd)

    # -- trees and the dump ---------------------------------------------------

    def _append_trees_from_bufs(self, model: GBDTModel, bufs,
                                bins: FeatureBins, names, have: int,
                                want: int) -> None:
        """Convert device tree buffers [have, want) into host Trees (one
        device->host fetch). The buffers are indexed by round * K + group,
        so a resumed run's loaded trees leave their slots unused."""
        if want <= have:
            return
        host = {k: v[have:want].cpu().numpy()
                for k, v in bufs.items() if k != "wlog"}
        for i in range(want - have):
            tree = self._arrays_to_tree({k: v[i] for k, v in host.items()},
                                        bins, names)
            # tree sanity on the fetched arrays: an empty tree means
            # boosting stopped learning, a NaN gain rotten split statistics
            health.check_tree("gbdt.tree", len(tree.gain), tree.gain,
                              tree=have + i)
            model.trees.append(tree)

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

    def _build_quality_features(self, train: GBDTData) -> Optional[dict]:
        """Feature block of the `<model>.sketch.json` quality sidecar:
        per-feature GK summaries + presence rates of the real training
        rows, built once at binning time while the matrix is alive
        (reference gbdt/trainer.py:1806)."""
        names = list(train.feature_names or [])
        if not names:
            return None
        n_real = getattr(train, "n_real", None) or train.X.shape[0]
        with obs_span("gbdt.quality_sketch", features=len(names)):
            return build_training_sketch(
                _host(train.X)[:n_real], names,
                weight=_host(train.weight)[:n_real],
            )

    def _stash_quality_scores(self, scores, weight) -> None:
        """Score distribution for the quality sidecar: the trained
        ensemble's predictions over the held-out set when there is one
        (else the training rows), padded and zero-weight rows left out."""
        try:
            preds = _host(self.loss.predict(scores))
            w = _host(weight)[: preds.shape[0]]
            self._quality_scores = preds[w > 0]
        except Exception as e:  # noqa: BLE001 — sidecar evidence, never the run
            log.warning("quality score stash failed (%s: %s); the sketch "
                        "sidecar will carry no score block",
                        type(e).__name__, e)

    def _dump_model(self, model: GBDTModel) -> None:
        """Sidecars first (bin edges, quality sketch), then the model text
        (atomic), then the feature importance file: a fingerprint-watch
        reload of the model always finds sidecars at least as fresh."""
        p = self.params
        if not self._is_rank0:
            return  # rank 0 dumps (reference: GBDTOptimizer.java:434-437)
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
        if self._quality_features is not None:
            payload = dict(self._quality_features)
            if self._quality_scores is not None:
                payload["score"] = build_score_block(self._quality_scores)
            dump_quality_sidecar(
                self.fs, quality_sidecar_path(p.model.data_path), payload,
                model_digest=digest,
            )
        with self.fs.atomic_open(p.model.data_path) as f:
            f.write(model_text)
        if p.model.feature_importance_path:
            imp = model.feature_importance()
            with self.fs.atomic_open(p.model.feature_importance_path) as f:
                f.write("feature_name\tsum_split_count\tsum_gain\n")
                for name, (cnt, gain) in imp.items():
                    f.write(f"{name}\t{cnt}\t{gain}\n")

    def _finalize(self, model, dd: _DevInputs, state, names, start: int,
                  rounds: int) -> GBDTResult:
        p = self.params
        scores, scores_t, bufs, loss_buf, tloss_buf = state
        self._append_trees_from_bufs(model, bufs, dd.bins, names,
                                     len(model.trees), rounds * self.K)
        if not p.just_evaluate:
            # held-out predictions (else train) feed the quality sidecar's
            # score block before the final dump lands
            # every rank's rows (a collective under a mesh)
            if scores_t is not None:
                self._stash_quality_scores(self._gather(scores_t),
                                           self._gather(dd.w_t))
            else:
                self._stash_quality_scores(self._gather(scores),
                                           self._gather(dd.weight))
            self._dump_model(model)
        res = GBDTResult(
            model=model,
            train_loss=float(_wavg_loss(self.loss, scores, dd.y, dd.weight,
                                        self.mesh)),
            test_loss=(float(_wavg_loss(self.loss, scores_t, dd.y_t, dd.w_t,
                                        self.mesh))
                       if scores_t is not None else None),
        )
        loss_np = loss_buf.cpu().numpy()
        tloss_np = tloss_buf.cpu().numpy()
        for rnd in range(start, rounds):
            rec = {"round": rnd, "train_loss": float(loss_np[rnd])}
            if scores_t is not None:
                rec["test_loss"] = float(tloss_np[rnd])
            res.round_log.append(rec)
        if p.eval_metric:
            # the metrics see every rank's rows (n_score x world,
            # reference :549, :595)
            g = self._gather
            ev = EvalSet(p.eval_metric, K=max(self.K, 2))
            res.train_metrics = ev.evaluate(self.loss.predict(g(scores)),
                                            g(dd.y), g(dd.weight))
            if scores_t is not None:
                res.test_metrics = ev.evaluate(
                    self.loss.predict(g(scores_t)), g(dd.y_t), g(dd.w_t))
        self.final_scores = (scores, scores_t)
        return res


def _wavg_loss(loss, scores, y, weight, mesh=None) -> torch.Tensor:
    """The weighted mean loss; under a mesh over every rank's rows (the
    weighted sum and the weight summed by one psum)."""
    per = loss.loss(scores, y)
    per = torch.where(weight > 0, per, torch.zeros_like(per))
    if mesh is None:
        return torch.sum(weight * per) / torch.clamp_min(torch.sum(weight),
                                                         1e-12)
    num, den = coll.psum(torch.stack([torch.sum(weight * per),
                                      torch.sum(weight)]), mesh).unbind()
    return num / torch.clamp_min(den, 1e-12)


def _lad_refine(tr, pos, y, scores, weight, real_mask, lr) -> torch.Tensor:
    """The tree's leaves refined to lr * the weighted median of the residual
    y - score over each leaf's rows (the approximate LAD of reference
    trainer.py:1917-1950, TreeRefiner.java's GK mode): one sort of the
    valid residuals, a grid of LAD_Q of them at evenly spaced ranks, each
    row's grid cell (the last grid value <= its residual), a (M, LAD_Q)
    weight histogram, its prefix sums, and each leaf's first cell at or
    above half its weight; exact when the grid holds every row. A leaf
    without weight keeps its value. The prefix sums run in XLA CPU's order
    (ordered_cumsum). Unit and integer weights sum exactly (below 2^24), so
    the card's index_add_ equals the CPU's; fractional weights add in
    atomic order on the card and may differ from the CPU in the last ulp
    of a cell, which can move a median by one grid cell."""
    M = tr.leaf.shape[0]
    dev = tr.leaf.device
    r = y - scores
    valid = real_mask & (weight > 0)
    rs = torch.sort(torch.where(valid, r, 3.4e38)).values
    nv = int(valid.sum())
    # ranks i * (nv - 1) // (Q - 1), without the product overflowing int32
    i = torch.arange(LAD_Q, dtype=torch.int64, device=dev)
    span = max(nv - 1, 0)
    base, rem = span // (LAD_Q - 1), span % (LAD_Q - 1)
    grid = rs[i * base + (i * rem) // (LAD_Q - 1)]
    qi = torch.clamp(torch.searchsorted(grid, r.contiguous(), right=True) - 1,
                     0, LAD_Q - 1)
    flat = pos.long() * LAD_Q + qi
    w = torch.where(valid, weight, 0.0)
    hist = torch.zeros(M * LAD_Q, dtype=torch.float32, device=dev)
    hist.index_add_(0, flat, w)
    cw = ordered_cumsum(hist.view(M, LAD_Q), dim=1)
    tot = cw[:, -1]
    # the first cell at or above half: argmax's first maximum, on int32
    # (CUDA's argmax takes no bool)
    first = torch.argmax((cw >= 0.5 * tot[:, None]).to(torch.int32), dim=1)
    med = grid[first]
    is_leaf = (tr.feat == -1) & (torch.arange(M, device=dev) < tr.n_nodes)
    return torch.where(is_leaf & (tot > 0), med * lr, tr.leaf)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
