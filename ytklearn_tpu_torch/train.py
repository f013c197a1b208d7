"""The convex families' training session (``ytklearn_tpu/train.py``;
reference worker/TrainWorker.java:133-236, operation/HoagOperation.java
:35-40 and the grid and HOAG rounds of optimizer/HoagOptimizer.java:
457-902), on one device or on the ranks of a mesh.

Ingest parses the text into padded ELL arrays on the host, the model's
batch goes to the device once, and L-BFGS runs there (optimize/lbfgs.py).
Each iteration computes the test loss, and every fifth (and the first two)
the configured metrics; `model.dump_freq` dumps on the way, the best round
at the end. `train()` runs under the preemption guard
(resilience/preempt.py): a SIGTERM or SIGINT is deferred to the next
iteration callback, which dumps the current weights through the ordinary
dump and raises `Preempted`; the relaunch (`--resume auto`) warm-starts
from them through continue_train. The obs spans are the JAX trainer's:
`train.load` (the ingest), `train.round` (one L-BFGS solve; its phases
`lbfgs.first_eval` and `lbfgs.iterations` and the `lbfgs.iteration` spans
inside) and `train.evaluate` (the metrics), with `mem.train.load.*` and
`mem.train.train.*` gauges and the `train.phase.*` mirror of time_stats.

With `mesh` (parallel/mesh.py) w is replicated and the rows are sharded:
each rank keeps its contiguous shard of the global rows (`--devices`: one
ingest of every row) or its own ingest (`--coordinator`), padded with
weight-0 rows to the rows every rank holds. Every loss, gradient, metric
and curvature sum is the rank's own sum psummed over the ranks, so the
line search, the HOAG step, the round choice and the preemption check
(agreed by a pmax) see the same numbers on every rank and every rank
issues the same collectives. The warm start is process 0's read; only
rank 0 dumps.
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
from .models import FFMModel, FMModel, LinearModel, MulticlassLinearModel, \
    load_field_dict
from .optimize import LBFGSConfig, inv_hessian_vp, minimize_lbfgs
from .optimize.blocked import make_rows, make_sum, make_value_and_grad
from .parallel import collectives as coll
from .obs import gauge as obs_gauge, health, inc as obs_inc, span as obs_span
from .parallel.mesh import process_count
from .resilience import trainer_guard

log = logging.getLogger("ytklearn_tpu_torch.train")

#: the families HoagTrainer trains
CONVEX_NAMES = ("linear", "multiclass_linear", "fm", "ffm")


@dataclass
class TrainResult:
    w: np.ndarray
    loss: float  # regularized weighted-sum train loss
    avg_loss: float
    pure_loss: float
    test_loss: Optional[float]
    n_iter: int
    status: str
    train_metrics: Dict[str, float] = field(default_factory=dict)
    test_metrics: Dict[str, float] = field(default_factory=dict)
    best_l1: Optional[float] = None
    best_l2: Optional[float] = None
    history: List[Dict] = field(default_factory=list)


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class HoagTrainer:
    """Trainer of the convex families on `device` (cuda by default; it
    raises without a GPU unless the caller passes "cpu"), or on this
    rank's device of `mesh`."""

    def __init__(self, params: CommonParams, model_name: str = "linear",
                 fs=None, transform_hook: Optional[Callable] = None,
                 device=None, mesh=None):
        if model_name not in CONVEX_NAMES:
            raise ValueError(f"unknown model {model_name!r}")
        self.params = params
        self.model_name = model_name
        self.fs = fs or LocalFileSystem()
        self.transform_hook = transform_hook
        self.mesh = mesh
        self.device = resolve_device(mesh.device if mesh is not None
                                     else device)
        self._field_map: Optional[Dict[str, int]] = None
        self.time_stats: Dict[str, object] = {}

    def _ingest(self) -> IngestResult:
        """The family's ingest (reference: DataFlowFactory.createDataFlow:
        37-72): only the label width and FFM's field map differ."""
        p = self.params
        kwargs = {}
        if self.model_name == "multiclass_linear":
            kwargs["n_labels"] = int(p.k)
        elif self.model_name == "ffm":
            kwargs["field_map"] = self._fields()
        return DataIngest(p, fs=self.fs, transform_hook=self.transform_hook,
                          **kwargs).load()

    def _fields(self) -> Dict[str, int]:
        if self._field_map is None:
            if not self.params.model.field_dict_path:
                raise ValueError("ffm requires model.field_dict_path")
            self._field_map = load_field_dict(
                self.fs, self.params.model.field_dict_path)
        return self._field_map

    def _make_model(self, ingest: IngestResult):
        dim, p, dev = ingest.train.dim, self.params, self.device
        if self.model_name == "linear":
            return LinearModel(p, dim, device=dev)
        if self.model_name == "multiclass_linear":
            return MulticlassLinearModel(p, dim, device=dev)
        if self.model_name == "fm":
            return FMModel(p, dim, device=dev)
        # the field dict the ingest used, so n_fields matches ds.field
        return FFMModel(p, dim, n_fields=len(self._fields()), device=dev)

    def _device_batch(self, model, ds):
        """The model's batch on the device: with a mesh, this rank's rows
        padded with weight-0 rows (SparseDataset.shard)."""
        return model.device_batch(ds if self.mesh is None
                                  else ds.shard(self.mesh))

    def _preempt_now(self) -> bool:
        hit = self._guard is not None and self._guard.triggered
        return hit if self.mesh is None else coll.any_rank(hit, self.mesh)

    _guard = None  # PreemptionGuard while train() runs

    def train(self, ingest: Optional[IngestResult] = None) -> TrainResult:
        with trainer_guard(self):
            return self._train(ingest)

    def _train(self, ingest: Optional[IngestResult]) -> TrainResult:
        p = self.params
        t0 = time.time()
        ts = self.time_stats = {}
        health.install_trace_counters()
        if ingest is None:
            with obs_span("train.load", model=self.model_name):
                ingest = self._ingest()
        ts["load"] = time.time() - t0
        health.record_memory("train.load")
        ts["parser"] = ingest.parser
        log.info("load flow done in %.1fs (%s parser): %d train rows, dim %d",
                 ts["load"], ingest.parser, ingest.train.n_real,
                 ingest.train.dim)
        model = self._make_model(ingest)
        mesh = self.mesh
        train_b = self._device_batch(model, ingest.train)
        test_b = (self._device_batch(model, ingest.test) if ingest.test
                  else None)
        g_weight = float(np.sum(ingest.train.weight))
        g_weight_test = (float(np.sum(ingest.test.weight)) if ingest.test
                         else 0.0)
        if process_count() > 1:
            # the global weights (CoreData.globalSync's weight allreduce)
            g_weight = float(sum(coll.host_allgather_objects(g_weight)))
            g_weight_test = float(sum(coll.host_allgather_objects(
                g_weight_test)))

        # continue_train / just_evaluate warm start: process 0 reads, the
        # others take its weights (only rank 0 dumps)
        w0 = None
        if p.model.continue_train or p.loss.just_evaluate:
            w0 = coll.load_on_rank0(
                lambda: model.load_model(self.fs, ingest.feature_map))
            if w0 is not None:
                log.info("continue_train: loaded existing model")
        if w0 is None:
            w0 = model.init_weights()

        eval_set = (EvalSet(p.loss.evaluate_metric,
                            K=max(model.n_labels, 2))
                    if p.loss.evaluate_metric else None)
        # blocked evaluation: row chunks keep the per-row intermediates
        # (FM/FFM latent gathers) from scaling peak memory with n
        width = int(train_b[0].shape[1]) if train_b[0].ndim > 1 else 1
        shards = mesh.world if mesh is not None else 1
        row_chunk = model.suggest_row_chunk(
            int(train_b[0].shape[0]) * shards, width, n_shards=shards)
        if row_chunk is not None:
            log.info("blocked evaluation: row chunk %d", row_chunk)
        loss_sum = make_sum(model.pure_loss, row_chunk, mesh=mesh)
        predicts = make_rows(model.predicts, row_chunk, mesh=mesh)

        def precision(w, l2_vec):
            if not hasattr(model, "precision"):
                return None
            with torch.no_grad():
                if mesh is None:
                    return _host(model.precision(w, *train_b, l2_vec=l2_vec,
                                                 g_weight=g_weight))
                # each rank's curvature sum, psummed; rank 0 adds the l2
                # term once
                reg = l2_vec if mesh.rank == 0 else torch.zeros_like(l2_vec)
                return _host(coll.psum(model.precision(
                    w, *train_b, l2_vec=reg, g_weight=g_weight), mesh))

        def evaluate(w, sink: Dict) -> None:
            if eval_set is None:
                return
            with obs_span("train.evaluate"):
                sink["train_metrics"] = eval_set.evaluate(
                    predicts(w, *train_b), train_b[-2], train_b[-1],
                    mesh=mesh)
                if test_b is not None:
                    sink["test_metrics"] = eval_set.evaluate(
                        predicts(w, *test_b), test_b[-2], test_b[-1],
                        mesh=mesh)

        def test_avg(w) -> float:
            return float(loss_sum(w, *test_b)) / max(g_weight_test, 1e-12)

        # grid rounds, HOAG rounds or one round
        hoag_mode = p.hyper.switch_on and p.hyper.mode == "hoag"
        if p.hyper.switch_on and p.hyper.mode == "grid":
            l1_grid = p.hyper.grid_l1 or [p.loss.l1[0]]
            l2_grid = p.hyper.grid_l2 or [p.loss.l2[0]]
            rounds = [(a, b) for a in l1_grid for b in l2_grid]
        elif hoag_mode:
            if test_b is None:
                raise ValueError(
                    "hyper.mode=hoag needs test data (data.test.data_path): "
                    "the hypergradient is the test-loss gradient")
            n_blocks = len(model.regular_blocks())
            hoag_l1 = np.broadcast_to(np.atleast_1d(np.asarray(
                p.hyper.hoag_l1, float)), (n_blocks,)).copy()
            hoag_l2 = np.broadcast_to(np.atleast_1d(np.asarray(
                p.hyper.hoag_l2, float)), (n_blocks,)).copy()
            if p.hyper.hoag_outer_iter <= 0:
                raise ValueError("hyper.hoag.outer_iter must be > 0, got "
                                 f"{p.hyper.hoag_outer_iter}")
            if not np.any(hoag_l2 > 0.0):
                raise ValueError(
                    "hyper.mode=hoag needs at least one positive "
                    "hyper.hoag.l2 entry (the hypergradient steps log(l2); "
                    "l2=0 blocks are held fixed)")
            rounds = [(hoag_l1, hoag_l2)] * p.hyper.hoag_outer_iter
            hoag_steps = np.full((n_blocks,), p.hyper.hoag_init_step)
            hoag_grad_hist: List[np.ndarray] = []
            hoag_delta_hist: List[float] = []
            hoag_t_old = 0.0
            test_vg = make_value_and_grad(model.pure_loss, row_chunk,
                                          mesh=mesh)
        else:
            if p.hyper.switch_on:
                log.warning("unknown hyper.mode=%r (grid|hoag); running a "
                            "single round at l1=%g l2=%g", p.hyper.mode,
                            p.loss.l1[0], p.loss.l2[0])
            rounds = [(p.loss.l1[0], p.loss.l2[0])]

        cfg = LBFGSConfig.from_params(p.line_search)
        best = None  # (test loss, result, l1, l2)
        history: List[Dict] = []
        # restart: every round starts from the initial w (a warm start
        # included); else a round carries the previous round's solution
        # (reference: HoagOptimizer.java:318,469)
        carry_w = w0
        for round_idx in range(len(rounds)):
            l1, l2 = (hoag_l1, hoag_l2) if hoag_mode else rounds[round_idx]
            l1_vec, l2_vec = model.reg_vectors(l1, l2)
            start_w = w0 if p.hyper.restart else carry_w
            # the convex loop's sentinel on the TEST loss, which the L-BFGS
            # sentinels (on the train loss) cannot see
            guard = health.ProgressGuard("train.convex_test", window=12)

            def callback(it, state, _l1=l1, _l2=l2, _l2v=l2_vec,
                         _guard=guard):
                rec = {"iter": it, "l1": _l1, "l2": _l2,
                       "loss": state.loss,
                       "avg_loss": state.loss / g_weight,
                       "pure_loss": state.pure_loss}
                if test_b is not None:
                    rec["test_loss"] = test_avg(state.w)
                if health.enabled() and "test_loss" in rec:
                    health.check_loss("train.convex_test", rec["test_loss"],
                                      iter=it)
                    _guard.update(rec["test_loss"], iter=it)
                if it % 5 == 0 or it <= 1:
                    evaluate(state.w, rec)
                history.append(rec)
                log.info("[iter=%d] %.1fs train avg loss=%.6f%s", it,
                         time.time() - t0, rec["avg_loss"],
                         f" test avg loss={rec['test_loss']:.6f}"
                         if "test_loss" in rec else "")
                if self._preempt_now():
                    # the iteration boundary is the convex safe point: the
                    # current weights are the checkpoint the relaunch warm-
                    # starts from; checked before the periodic dump, so
                    # the grace window never pays for two dumps
                    self._dump(model, state.w, ingest,
                               precision(state.w, _l2v))
                    self._guard.preempt(p.model.data_path,
                                        family=self.model_name,
                                        iteration=it)
                # periodic checkpoint (reference dump_freq block :647-660)
                if (p.model.dump_freq > 0 and it > 0
                        and it % p.model.dump_freq == 0):
                    self._dump(model, state.w, ingest,
                               precision(state.w, _l2v))
                return bool(p.loss.just_evaluate)

            obs_inc("train.rounds")
            with obs_span("train.round", round=round_idx):
                res = minimize_lbfgs(
                    model.pure_loss,
                    torch.as_tensor(np.asarray(start_w, np.float32)).to(
                        self.device),
                    cfg, batch=train_b, l1_vec=l1_vec, l2_vec=l2_vec,
                    g_weight=g_weight, callback=callback,
                    row_chunk=row_chunk, mesh=mesh)
            carry_w = _host(res.w)
            # round selection: the test loss, else the pure train loss (the
            # regularized one would always prefer the smallest penalty);
            # HOAG keeps the last round
            tl = (float(loss_sum(res.w, *test_b)) if test_b is not None
                  else res.pure_loss)
            if best is None or hoag_mode or tl < best[0]:
                best = (tl, res, l1, l2)
            if len(rounds) > 1:
                log.info("[hyper l1=%s l2=%s] train loss %.6f test loss %s",
                         np.asarray(l1), np.asarray(l2), res.loss / g_weight,
                         tl / max(g_weight_test, 1e-12)
                         if test_b is not None else "n/a")
            if not hoag_mode:
                continue
            # HOAG's hypergradient step on log l2 (reference:
            # HoagOptimizer.hyperHoagOptimization:813-902)
            tl_avg = tl / max(g_weight_test, 1e-12)
            gtest = test_vg(res.w, *test_b)[1] / g_weight_test
            q = _host(inv_hessian_vp(res.state, gtest, cfg.m))
            w_np = carry_w
            grad_log_l2 = np.zeros_like(hoag_l2)
            for r, (s, e) in enumerate(model.regular_blocks()):
                if hoag_l2[r] > 0.0:
                    grad_log_l2[r] = (-hoag_l2[r] * g_weight
                                      * float(np.dot(w_np[s:e], q[s:e])))
            hoag_delta_hist.append(tl_avg - hoag_t_old)
            hoag_t_old = tl_avg
            hoag_grad_hist.append(grad_log_l2)
            # a hypergradient sign flip shrinks the step (:845-857)
            if len(hoag_grad_hist) >= 2:
                flip = hoag_grad_hist[-2] * grad_log_l2 < 0.0
                hoag_steps = np.where(
                    flip & (hoag_l2 > 0.0),
                    hoag_steps * p.hyper.hoag_step_decr_factor, hoag_steps)
            # stop when the last three |delta test loss| average stalls
            # (:860-876)
            if len(hoag_delta_hist) >= 3:
                sumdelta = float(np.mean(np.abs(hoag_delta_hist[-3:])))
                if sumdelta < p.hyper.hoag_test_loss_reduce_limit:
                    log.info("[hoag] last 3 avg test loss delta %.3g < %g, "
                             "exit! final l2: %s", sumdelta,
                             p.hyper.hoag_test_loss_reduce_limit, hoag_l2)
                    break
            # a signed step on log l2 (:885-895)
            upd = hoag_l2 > 0.0
            logl2 = np.where(upd, np.log(np.where(upd, hoag_l2, 1.0)), 0.0)
            logl2 = logl2 + np.where(-grad_log_l2 >= 0.0, hoag_steps,
                                     -hoag_steps)
            hoag_l2 = np.where(upd, np.exp(logl2), hoag_l2)
            log.info("[hoag round %d] test avg loss %.6f hypergrad %s new "
                     "l2 %s", round_idx, tl_avg, grad_log_l2, hoag_l2)

        tl, res, bl1, bl2 = best
        _, l2_vec = model.reg_vectors(bl1, bl2)
        self._dump(model, res.w, ingest, precision(res.w, l2_vec))
        out = TrainResult(
            w=_host(res.w), loss=res.loss, avg_loss=res.loss / g_weight,
            pure_loss=res.pure_loss,
            test_loss=(tl / max(g_weight_test, 1e-12)
                       if test_b is not None else None),
            n_iter=res.n_iter, status=res.status, best_l1=bl1, best_l2=bl2,
            history=history)
        sink: Dict = {}
        evaluate(res.w, sink)
        out.train_metrics = sink.get("train_metrics", {})
        out.test_metrics = sink.get("test_metrics", {})
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        ts["train"] = time.time() - t0 - ts["load"]
        health.record_memory("train.train")
        if res.n_iter > 0 and ts["train"] > 0:
            ts["iters_per_sec"] = res.n_iter / ts["train"]
        # phase stats mirrored into the obs registry (one source of truth
        # for bench/report surfaces; time_stats stays the in-process view)
        for k, v in ts.items():
            if isinstance(v, (int, float)):
                obs_gauge(f"train.phase.{k}", v)
        obs_inc("train.iterations_total", res.n_iter)
        log.info("training done: %s after %d iters, avg loss %.6f, metrics "
                 "%s; load %.1fs, train %.1fs", res.status, res.n_iter,
                 out.avg_loss, out.train_metrics, ts["load"], ts["train"])
        return out

    def _dump(self, model, w, ingest: IngestResult,
              precision: Optional[np.ndarray]) -> None:
        """Rank 0's dump (the reference's HoagOptimizer.java:647-660); the
        precision, a collective, is computed on every rank before."""
        if self.mesh is None or self.mesh.rank == 0:
            model.dump_model(self.fs, _host(w), precision,
                             ingest.feature_map)
