"""CompiledScorer — lower a loaded predictor into batch scoring on a device.

Requests are padded up to the smallest rung of a batch-shape ladder
(default 1/8/64/512, knob YTK_SERVE_LADDER); a batch larger than the top
rung goes in top-rung chunks. The lowering per family (the JAX package's
serve/scorer.py), model maps to dense tensors, request dicts to rows:

  linear            score = X @ w (the bias a column at x = 1)
  multiclass_linear scores = [X @ W, 0]
  fm                X w + 1/2 sum_k [(X V)^2 - X^2 V^2]; the bias a column
                    at x = 1 whatever the first-order flag
  ffm               the field-aware pairs through a (B, F, F, k) field-block
                    einsum, less each feature's self-interaction: the host's
                    sum over p < q in closed form
  gbmlr/gbsdt/...   every tree's gates (and experts) in one product, the
                    softmax or heap-sigmoid gating, the trees folded into z
                    in order; random_forest divides by T
  gbdt              three rungs, below

The einsum families take YTK_SERVE_PRECISION: "f64" computes in
torch.float64; "bf16" is the JAX package's preferred_element_type=f32
contract, operands rounded to bf16 and their products summed in f32 (f32
matmuls with TF32 off, so bf16 x bf16 products are exact and only the f32
sums round), the result carried on in f64. GBDT and GBST score in f64
whatever it asks, as in the JAX package, and rung_info() reports the
precision that runs.

Three GBDT rungs:

  stacked   the node arrays of every tree stacked (T, N) and walked with
            torch gathers, `depth` steps over (B, T) frontiers; the sum is
            a sequential tree-ascending f64 fold, so scores are
            bit-identical to GBDTPredictor.batch_scores
  fused     (YTK_SERVE_FUSED=1) the perfect-heap layout walked by the
            heap-walk CUDA kernel K6 (serve/kernels.py), bit-identical too
  binned    (YTK_SERVE_BINNED=1, the reference's _try_binned_gbdt) each
            chunk binned once on the host against the model's bin table
            (the `.bins.json` sidecar the trainer wrote, when it pairs with
            the model text's digest: mode "edges"; else the ensemble's own
            split values: mode "thresholds"), then the binned walk, CUDA
            kernel K7, on packed heap nodes. Thresholds mode is bit-identical
            to batch_scores; edges mode routes as the training bins did (a
            row exactly on a split midpoint goes right, where the float
            walk sends it left) and is bit-identical to the reference's
            binned rung

An ensemble the heap layout cannot take (deeper than 10, more than 4095
features, no split features, K > 1) or, for the binned rung, no bin table
fitting uint16 serves on the stacked rung, and rung_info() names the
downgrade (`fused_to_stacked`, `binned_to_stacked`) and its reason. The
fused and binned rungs are GBDT walks: the other families serve stacked
and count no downgrade. A kernel that fails to build or launch raises.
Warmup scores every rung once on the device. Featurization is the shared
TransformPipeline: identity assembly with a NaN fill for GBDT; bias drop,
hashing, vocab assembly and the transform replay for the rest.

Warmup launches every rung's kernel once, so each kernel instantiation the
ladder needs is built before traffic (a "compile" in the port: a library
build or load, or the first launch of a kernel instantiation, obs/
health.py); the RetraceSentinel armed after it fires `health.retrace` on
any build a steady-state batch causes. While the profiling plane is on
(YTK_PROF), each rung's settled execute time and rows are kept for
`/metrics?prof=1` (prof_snapshot), and every build lands in the build
ledger under `serve.rung.<rung>`.
"""

from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import knobs
from ..device import resolve_device
from ..obs import health as obs_health
from ..obs import inc as obs_inc, span as obs_span
from ..obs import profiler
from ..obs import trace as obs_trace
from ..gbdt.binning import bin_edges_path, load_bin_edges, model_text_digest
from ..predict.continuous import (
    FFMPredictor,
    FMPredictor,
    LinearPredictor,
    MulticlassLinearPredictor,
)
from ..predict.trees import GBDTPredictor, GBSTPredictor
from ..transform.pipeline import TransformPipeline
from . import kernels

log = logging.getLogger(__name__)

DEFAULT_LADDER = (1, 8, 64, 512)

#: builds attributed to scorer warmups (process-wide, GIL-guarded). The
#: retrace sentinel watches a process-global build counter; without this
#: credit, warming a replacement scorer (hot reload) or a second model
#: would falsely fire health.retrace on every already-armed scorer. While
#: a warmup is in progress its builds have landed in the global counter
#: but not yet in the credit, so armed scorers skip checks for the
#: duration and re-baseline on their next batch (_warmups_in_progress).
_warmup_compile_credit = 0.0
_warmups_in_progress = 0


class _LadderRetraceSentinel(obs_health.RetraceSentinel):
    """RetraceSentinel that discounts builds other scorers' warmups did."""

    @staticmethod
    def _compiles() -> float:
        return obs_health.RetraceSentinel._compiles() - _warmup_compile_credit


@contextlib.contextmanager
def compile_credit():
    """Attribute every build inside the block to a known-good cause so
    armed scorers don't count them as steady-state serving retraces. Used
    by scorer warmups, and by the continual retrain driver when a
    candidate trains in-process next to live serving: training builds are
    expected, a /predict-path build still is not."""
    global _warmup_compile_credit, _warmups_in_progress
    before = obs_health.RetraceSentinel._compiles()
    _warmups_in_progress += 1
    try:
        yield
    finally:
        # credit BEFORE dropping the in-progress flag, so once the flag
        # clears the subtraction is already settled
        _warmup_compile_credit += (
            obs_health.RetraceSentinel._compiles() - before
        )
        _warmups_in_progress -= 1


class LoweringRefused(TypeError):
    """The scorer has no lowering for the predictor's family: the one
    refusal a caller may answer with the host row walk (the continual
    gate does, and counts it)."""


def parse_ladder(spec: Optional[str] = None) -> Tuple[int, ...]:
    """YTK_SERVE_LADDER="1,8,64,512" -> sorted unique rung tuple."""
    if spec is None:
        spec = knobs.get_str("YTK_SERVE_LADDER") or ""
    if not spec:
        return DEFAULT_LADDER
    rungs = sorted({int(v) for v in str(spec).split(",") if v.strip()})
    if not rungs or rungs[0] < 1:
        raise ValueError(f"bad serve ladder {spec!r}: rungs must be >= 1")
    return tuple(rungs)


def resolve_mode() -> str:
    """Requested GBDT scoring rung from the knobs: binned wins over fused,
    default is the stacked rung."""
    if knobs.get_bool("YTK_SERVE_BINNED"):
        return "binned"
    if knobs.get_bool("YTK_SERVE_FUSED"):
        return "fused"
    return "stacked"


def _bf16(a: torch.Tensor) -> torch.Tensor:
    """`a` rounded to bf16 and carried as f32: an operand of the bf16
    rung's f32 products."""
    return a.to(torch.bfloat16).float()


class CompiledScorer:
    """Batch scorer for one loaded model on one device; thread-safe after
    construction (scoring reads only immutable tensors)."""

    def __init__(
        self,
        predictor,
        ladder: Optional[Sequence[int]] = None,
        warmup: bool = True,
        mode: Optional[str] = None,
        precision: Optional[str] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.predictor = predictor
        self.ladder = tuple(sorted(set(ladder))) if ladder else parse_ladder()
        self.n_outputs = predictor.n_outputs
        self.requested_mode = mode if mode is not None else resolve_mode()
        if self.requested_mode not in ("stacked", "fused", "binned"):
            raise ValueError(f"unknown serve mode {self.requested_mode!r}")
        self.precision = (
            precision
            if precision is not None
            else (knobs.get_str("YTK_SERVE_PRECISION") or "f64")
        )
        if self.precision not in ("f64", "bf16"):
            raise ValueError(f"unknown serve precision {self.precision!r}")
        self.mode = "stacked"  # effective; a kernel lowering may upgrade it
        self.downgrade = ""  # e.g. binned_to_stacked, with its reason:
        self.reason = ""  # why a requested kernel rung serves stacked
        self.bin_mode: Optional[str] = None  # binned rung: edges|thresholds
        self.bin_dtype: Optional[str] = None
        self._fill = 0.0  # an absent feature's value; NaN for gbdt
        self._bias_col: Optional[int] = None
        self._lower()
        self.dim = len(self.vocab) + (self._bias_col is not None)
        if isinstance(predictor, GBDTPredictor):
            self._pipeline = TransformPipeline.for_identity(
                self.vocab, self.dim, fill=self._fill
            )
        else:
            pp = predictor.params
            self._pipeline = TransformPipeline(
                vocab=self.vocab, dim=self.dim, bias_col=self._bias_col,
                fill=self._fill, bias_name=pp.model.bias_feature_name,
                feature_hash=predictor.feature_hash,
                nodes=predictor.transform_nodes,
                transform_on=pp.feature.transform.switch_on,
            )
        # a build after warmup is a bug (the ladder exists to prevent
        # one); the sentinel makes one fire health.retrace loudly
        obs_health.install_trace_counters()
        self._sentinel = _LadderRetraceSentinel("serve.scorer")
        self._warm = False
        self._rearm_pending = False
        # ytkprof per-rung attribution: settled execute seconds + row
        # counts per ladder rung (written only when the plane is on; read
        # by /metrics?prof=1 via prof_snapshot)
        self._prof_lock = threading.Lock()
        self._rung_stats: Dict[int, dict] = {}
        if warmup:
            self.warmup()

    # -- public API -------------------------------------------------------

    def warmup(self) -> None:
        """Score every ladder rung once on the device: builds and loads the
        kernel and settles allocations at load time, not on a request;
        then arm the retrace sentinel. The builds this causes are credited,
        so scorers already armed (hot reload warms the replacement while
        the old one still serves) don't count them as retraces."""
        with compile_credit():
            with obs_span("serve.warmup", rungs=len(self.ladder)):
                for rung in self.ladder:
                    X = np.full((rung, self.dim), self._fill, np.float64)
                    # ledger label (no-op unless ytkprof is on): the
                    # rung's builds land named with their batch signature
                    with profiler.LEDGER.program(
                        "serve.rung.%d" % rung,
                        sig_fn=lambda x=X: profiler.abstract_signature(x),
                    ):
                        self._exec(X)
                    obs_inc("serve.scorer.warmup_rungs")
        self._sentinel.arm()
        self._warm = True

    @property
    def backend(self) -> str:
        if self.mode == "binned":
            return f"binned-{self._binned_where}"
        if self.mode == "fused":
            where = "cuda" if self.device.type == "cuda" else "plain"
            return f"fused-{where}"
        return "stacked-torch"

    def rung_info(self) -> Dict[str, object]:
        """The effective scoring rung."""
        info = {
            "requested": self.requested_mode,
            "mode": self.mode,
            "backend": self.backend,
            "precision": self.precision,
            "device": str(self.device),
            "downgraded": self.mode != self.requested_mode,
        }
        if self.reason:
            info["downgrade"] = self.downgrade
            info["reason"] = self.reason
        if self.bin_mode is not None:
            info["bin_mode"] = self.bin_mode
            info["bin_dtype"] = self.bin_dtype
        return info

    def featurize(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        """Request dicts -> dense (B, dim) float64: raw values with NaN for
        absent features (gbdt), else what each row's `prep_row` gives, 0
        for absent features and 1 in the bias column. The hash and
        transform replay of the non-GBDT families get their own
        `serve.transform` trace hop inside `serve.assemble`."""
        pipe = self._pipeline
        if pipe.identity:
            return pipe.featurize(rows)
        with obs_trace.batch_hop("serve.transform", rows=len(rows)):
            return pipe.featurize(rows)

    def score_batch(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        """Raw scores, shape (B,) or (B, K) — the batch_scores contract."""
        return self._run(rows)[0]

    def predict_batch(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        """Activated predictions (loss.predict applied on the device)."""
        return self._run(rows)[1]

    def score_and_predict(
        self, rows: Sequence[Dict[str, float]]
    ) -> Tuple[np.ndarray, np.ndarray]:
        return self._run(rows)

    def _note_rung(self, rung: int, rows: int, exec_s: float) -> None:
        with self._prof_lock:
            st = self._rung_stats.get(rung)
            if st is None:
                st = self._rung_stats[rung] = {
                    "calls": 0, "rows": 0, "exec_s": 0.0,
                }
            st["calls"] += 1
            st["rows"] += rows
            st["exec_s"] += exec_s

    def prof_snapshot(self) -> dict:
        """Per-rung settled execute-time attribution (ytkprof; the
        `/metrics?prof=1` export): each ladder rung's device-settled
        seconds, calls, real rows and per-row cost. Empty rungs dict when
        the plane was never on."""
        with self._prof_lock:
            rungs = {
                str(r): {
                    "calls": v["calls"],
                    "rows": v["rows"],
                    "exec_s": round(v["exec_s"], 6),
                    "ms_per_row": (
                        round(1000.0 * v["exec_s"] / v["rows"], 6)
                        if v["rows"] else None
                    ),
                }
                for r, v in sorted(self._rung_stats.items())
            }
        return {
            "mode": self.mode,
            "backend": self.backend,
            "ladder": list(self.ladder),
            "rungs": rungs,
        }

    # -- execution --------------------------------------------------------

    def _rung_for(self, n: int) -> int:
        for r in self.ladder:
            if r >= n:
                return r
        return self.ladder[-1]

    def score_tensor(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The effective rung on featurized rows already on the scorer's
        device: X (B, dim) f64 -> (scores, predictions) tensors, enqueued
        on the current stream and not synchronised (the binned rung first
        bins the rows on the host)."""
        if self.mode == "binned":
            return self._binned(X.cpu().numpy())
        return self._kernel(X)

    def _exec(self, chunk: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """One padded rung on the device; the `.cpu()` copies synchronise."""
        if self.mode == "binned":
            s, p = self._binned(chunk)
        else:
            s, p = self.score_tensor(torch.from_numpy(chunk).to(self.device))
        return s.cpu().numpy(), p.cpu().numpy()

    def _run(self, rows) -> Tuple[np.ndarray, np.ndarray]:
        # batch assembly hop: the cached no-op unless the micro-batch
        # carries a sampled request trace (obs/trace.py)
        with obs_trace.batch_hop("serve.assemble", rows=len(rows)):
            X = self.featurize(rows)
        B = X.shape[0]
        prof_on = profiler.enabled()  # one check per batch, not per chunk
        max_rung = self.ladder[-1]
        out_s: List[np.ndarray] = []
        out_p: List[np.ndarray] = []
        for start in range(0, B, max_rung):
            chunk = X[start : start + max_rung]
            rung = self._rung_for(chunk.shape[0])
            pad = rung - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.full((pad, self.dim), self._fill, np.float64)]
                )
            with obs_span("serve.score", rung=rung, rows=rung - pad):
                # ladder-rung execution hop, tagged with the effective rung
                with obs_trace.batch_hop(
                    "serve.execute", rung=rung, mode=self.mode,
                    backend=self.backend,
                ):
                    if prof_on:
                        # settled per-rung attribution: _exec copies the
                        # result to the host, so this wall interval IS the
                        # rung's kernel + copy time; a build inside lands
                        # named in the ledger with the chunk signature
                        t_exec = time.perf_counter()
                        with profiler.LEDGER.program(
                            "serve.rung.%d" % rung,
                            sig_fn=lambda c=chunk: (
                                profiler.abstract_signature(c)
                            ),
                        ):
                            s, p = self._exec(chunk)
                        self._note_rung(
                            rung, rung - pad, time.perf_counter() - t_exec
                        )
                    else:
                        s, p = self._exec(chunk)
            obs_inc("serve.scorer.batches")
            obs_inc("serve.scorer.rows", rung - pad)
            obs_inc("serve.scorer.pad_rows", pad)
            out_s.append(s[: rung - pad])
            out_p.append(p[: rung - pad])
        if self._warm:
            if _warmups_in_progress:
                # another scorer is mid-warmup: its builds are in the
                # global counter but not yet credited — don't judge, and
                # take a fresh baseline once the dust settles
                self._rearm_pending = True
            elif self._rearm_pending:
                self._sentinel.arm()
                self._rearm_pending = False
            else:
                self._sentinel.check(rows=B)
        if not out_s:
            shape = (0,) if self.n_outputs == 1 else (0, self.n_outputs)
            return np.empty(shape, np.float64), np.empty(shape, np.float64)
        return np.concatenate(out_s), np.concatenate(out_p)

    # -- lowering ---------------------------------------------------------

    def _lower(self) -> None:
        pred = self.predictor
        if isinstance(pred, GBDTPredictor):
            self._lower_gbdt()
            return
        # fused and binned are GBDT walks: a fleet-wide YTK_SERVE_BINNED=1
        # is no downgrade for the other families
        self.requested_mode = "stacked"
        if isinstance(pred, GBSTPredictor):
            self._lower_gbst()
            return
        lower = {
            LinearPredictor: self._lower_linear,
            MulticlassLinearPredictor: self._lower_multiclass,
            FMPredictor: self._lower_fm,
            FFMPredictor: self._lower_ffm,
        }.get(type(pred))
        if lower is None:
            raise LoweringRefused(f"no lowering for {type(pred).__name__}")
        if (self.precision == "bf16" and self.device.type == "cuda"
                and torch.backends.cuda.matmul.allow_tf32):
            raise RuntimeError(
                "the bf16 rung sums exact bf16 products in f32: turn TF32 "
                "off (torch.backends.cuda.matmul.allow_tf32 = False)")
        lower()

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _continuous_vocab(self, names) -> None:
        """The vocab of the non-GBDT families, and the bias column when the
        model has a bias row."""
        pred = self.predictor
        bias_name = pred.params.model.bias_feature_name
        self.vocab = {n: i for i, n in enumerate(sorted(names))}
        if pred.params.model.need_bias and bias_name in pred.model_map:
            self._bias_col = len(self.vocab)

    def _dense(self, width: int, row_of) -> np.ndarray:
        """(D, width) float64: `row_of(name)` at each vocab column, and at
        the bias column for the bias's row."""
        pred = self.predictor
        D = len(self.vocab) + (self._bias_col is not None)
        A = np.zeros((D, width), np.float64)
        for n, j in self.vocab.items():
            A[j] = row_of(n)
        if self._bias_col is not None:
            A[self._bias_col] = row_of(pred.params.model.bias_feature_name)
        return A

    def _latent_row(self, name: str, width: int) -> np.ndarray:
        """An FM/FFM model row as [first order, `width` latent weights]:
        the first order 0 when the model has none, but the bias's (it adds
        its weight at x = 1 whatever the flag, FMOnlinePredictor)."""
        pred = self.predictor
        r = pred.model_map[name]
        keep = (pred.need_first_order
                or name == pred.params.model.bias_feature_name)
        return np.concatenate([[r[0] if keep else 0.0], r[1:1 + width]])

    def _names(self):
        bias_name = self.predictor.params.model.bias_feature_name
        return [n for n in self.predictor.model_map if n != bias_name]

    def _lower_linear(self) -> None:
        pred = self.predictor
        self._continuous_vocab(self._names())
        w = self._dense(1, lambda n: pred.model_map[n][0])[:, 0]
        act = pred.loss.predict
        if self.precision == "bf16":
            w16 = _bf16(self._tensor(w))

            def kernel(X):
                s = (_bf16(X) @ w16).double()
                return s, act(s)
        else:
            w64 = self._tensor(w)

            def kernel(X):
                s = X @ w64
                return s, act(s)

        self._kernel = kernel

    def _lower_multiclass(self) -> None:
        pred = self.predictor
        self._continuous_vocab(self._names())
        W = self._dense(pred.K - 1, lambda n: pred.model_map[n])
        act = pred.loss.predict
        W = self._tensor(W)
        if self.precision == "bf16":
            W, cast = _bf16(W), _bf16
        else:
            cast = lambda X: X  # noqa: E731

        def kernel(X):
            s = (cast(X) @ W).double()
            # the implicit K-th class at 0
            s = torch.cat([s, torch.zeros_like(s[:, :1])], dim=-1)
            return s, act(s)

        self._kernel = kernel

    def _lower_fm(self) -> None:
        pred = self.predictor
        self._continuous_vocab(self._names())
        k = pred.sok
        A = self._dense(1 + k, lambda n: self._latent_row(n, k))
        w, V = A[:, 0], A[:, 1:]
        act = pred.loss.predict
        if self.precision == "bf16":
            w16, V16 = _bf16(self._tensor(w)), _bf16(self._tensor(V))
            V216 = _bf16(self._tensor(V * V))

            def kernel(X):
                X16 = X.to(torch.bfloat16)
                S = X16.float() @ V16
                S2 = (X16 * X16).float() @ V216  # the square is a bf16 value
                wx = X16.float() @ w16
                s = (wx + 0.5 * torch.sum(S * S - S2, dim=-1)).double()
                return s, act(s)
        else:
            w64, V64, VV = (self._tensor(a) for a in (w, V, V * V))

            def kernel(X):
                S = X @ V64
                S2 = (X * X) @ VV
                s = X @ w64 + 0.5 * torch.sum(S * S - S2, dim=-1)
                return s, act(s)

        self._kernel = kernel

    def _lower_ffm(self) -> None:
        pred = self.predictor
        # features of an unknown field drop at serve time too
        self._continuous_vocab(n for n in self._names()
                               if pred._field_of(n) >= 0)
        k, F = pred.sok, pred.n_fields
        A = self._dense(1 + F * k, lambda n: self._latent_row(n, F * k))
        D = A.shape[0]
        w, V = A[:, 0], A[:, 1:].reshape(D, F, k)
        field_idx = np.zeros(D, np.int64)
        for n, j in self.vocab.items():
            field_idx[j] = pred._field_of(n)
        # the bias rides as (field 0, x = 1), as in the ingest
        M = np.zeros((D, F), np.float64)
        M[np.arange(D), field_idx] = 1.0
        # each feature's self-interaction |V_d[f_d]|^2, taken off once so
        # the closed form is the host's sum over p < q
        Vs = V[np.arange(D), field_idx]
        sn = np.einsum("dk,dk->d", Vs, Vs)
        # T[b, a, f, k] = sum_d X[b, d] M[d, a] V[d, f, k]: one product
        # against the (D, F*F*k) field blocks (M is one-hot, so M V is V
        # placed in its field's block, exactly, at either precision)
        MV = (M[:, :, None, None] * V[:, None, :, :]).reshape(D, F * F * k)
        act = pred.loss.predict
        if self.precision == "bf16":
            w16, MV16, sn16 = (_bf16(self._tensor(a)) for a in (w, MV, sn))

            def kernel(X):
                B = X.shape[0]
                X16 = X.to(torch.bfloat16)
                wx = X16.float() @ w16
                T = (X16.float() @ MV16).reshape(B, F, F, k)
                Q = torch.einsum("bafk,bfak->b", T, T)
                diag = (X16 * X16).float() @ sn16  # the square: bf16
                s = (wx + 0.5 * (Q - diag)).double()
                return s, act(s)
        else:
            w64, MV64, sn64 = (self._tensor(a) for a in (w, MV, sn))

            def kernel(X):
                B = X.shape[0]
                T = (X @ MV64).reshape(B, F, F, k)
                Q = torch.einsum("bafk,bfak->b", T, T)
                s = X @ w64 + 0.5 * (Q - (X * X) @ sn64)
                return s, act(s)

        self._kernel = kernel

    def _lower_gbst(self) -> None:
        """Every tree's gates (and experts) in one f64 product, the gating
        batched over trees, then the trees folded into z in order (the
        reference's fori_loop); f64 whatever the precision knob."""
        pred = self.predictor
        self.precision = "f64"
        K, T, S = pred.K, pred.n_trees, pred.stride
        bias_name = pred.params.model.bias_feature_name
        has_bias = pred.params.model.need_bias
        names = {n for tmap in pred.tree_maps for n in tmap}
        if has_bias:
            names.discard(bias_name)
        self.vocab = {n: i for i, n in enumerate(sorted(names))}
        self._bias_col = len(self.vocab) if has_bias else None
        D = len(self.vocab) + has_bias
        W = np.zeros((D, T, S), np.float64)
        for ti, tmap in enumerate(pred.tree_maps):
            for n, r in tmap.items():
                if has_bias and n == bias_name:
                    W[self._bias_col, ti] = r
                elif n in self.vocab:
                    W[self.vocab[n], ti] = r
        Wt = self._tensor(W.reshape(D, -1))
        leaves = self._tensor(np.stack(pred.leaves) if pred.leaves
                              else np.zeros((0, K)))
        hier, scalar = pred.hier, pred.scalar_leaves
        lr, base, is_rf = pred.lr, pred.base_score, pred.is_rf
        act = pred.loss.predict
        from ..models.gbst import heap_leaf_probs

        def kernel(X):
            B = X.shape[0]
            G = (X @ Wt).reshape(B, T, S)
            gate_in = G[..., :K - 1]
            experts = leaves[None] if scalar else G[..., K - 1:]
            if hier:
                pi = heap_leaf_probs(torch.sigmoid(gate_in))
            else:
                pi = torch.softmax(torch.cat(
                    [gate_in, torch.zeros_like(gate_in[..., :1])], dim=-1),
                    dim=-1)
            fx = torch.sum(pi * experts, dim=-1)  # (B, T)
            z = torch.full((B,), base, dtype=torch.float64, device=X.device)
            for t in range(T):
                z = z + lr * fx[:, t]
            if is_rf:
                z = z / max(T, 1)
            return z, act(z)

        self._kernel = kernel

    def _lower_gbdt(self) -> None:
        pred = self.predictor
        self.precision = "f64"
        self._fill = math.nan  # an absent feature routes to the default
        model = pred.model
        K = pred.K
        T = pred.use_rounds * K
        trees = model.trees[:T]
        # leaf-only trees contribute no names; the vocab may be empty
        names = sorted(
            {nm for t in trees for i, nm in enumerate(t.feat_name) if not t.is_leaf(i)}
        )
        self.vocab = {n: i for i, n in enumerate(names)}

        N = max((t.n_nodes() for t in trees), default=1)
        feat = np.full((max(T, 1), N), -1, np.int64)
        split = np.zeros((max(T, 1), N), np.float64)
        left = np.zeros((max(T, 1), N), np.int64)
        right = np.zeros((max(T, 1), N), np.int64)
        dleft = np.ones((max(T, 1), N), np.int64)
        leaf = np.zeros((max(T, 1), N), np.float64)
        for ti, t in enumerate(trees):
            n = t.n_nodes()
            for nid in range(n):
                if not t.is_leaf(nid):
                    feat[ti, nid] = self.vocab[t.feat_name[nid]]
            split[ti, :n] = t.split
            left[ti, :n] = t.left
            right[ti, :n] = t.right
            dleft[ti, :n] = np.asarray(t.default_left, np.int64)
            leaf[ti, :n] = t.leaf_value
        dev = self.device
        feat, split, left, right, dleft, leaf = (
            torch.from_numpy(a).to(dev)
            for a in (feat, split, left, right, dleft, leaf)
        )
        depth = max((t.max_depth() for t in trees), default=0)
        is_rf = pred.learn_type == "random_forest"
        rounds = max(pred.use_rounds, 1)
        base = float(model.base_prediction)
        act = pred.loss.predict

        def tail(s):
            if is_rf:
                s = s / rounds
            s = s + base
            return s, act(s)

        def stacked(X):
            B = X.shape[0]
            rows = torch.arange(B, device=dev)[:, None]  # (B, 1)
            tids = torch.arange(max(T, 1), device=dev)[None, :]  # (1, T)
            # walk every tree at once: `depth` steps over (B, T) frontiers
            node = torch.zeros((B, max(T, 1)), dtype=torch.long, device=dev)
            for _ in range(depth):
                f = feat[tids, node]
                v = X[rows, f.clamp(min=0)]
                go_left = torch.where(
                    torch.isnan(v), dleft[tids, node] > 0,
                    v <= split[tids, node],
                )
                nxt = torch.where(go_left, left[tids, node], right[tids, node])
                node = torch.where(f < 0, node, nxt)
            contrib = leaf[tids, node]  # (B, T)
            # tree-ascending sequential fold in f64: bit-identical to the
            # host predictor's walk; a torch.sum would reassociate the adds
            s = torch.zeros((B, K) if K > 1 else (B,), dtype=torch.float64,
                            device=dev)
            for t in range(T):
                if K == 1:
                    s = s + contrib[:, t]
                else:
                    s[:, t % K] += contrib[:, t]
            return tail(s)

        self._kernel = stacked
        if self.requested_mode == "stacked":
            return
        if K != 1:
            self._refuse("multiclass ensemble (K > 1)")
            return
        heap, why = kernels.build_heap(trees, self.vocab)
        if heap is None:
            self._refuse(why)
            return
        if self.requested_mode == "binned":
            self._lower_binned(trees, heap, tail)
            return
        ht = kernels.heap_from_numpy(
            heap.feat, heap.split, heap.dleft, heap.leaf, heap.depth,
            heap.n_trees, dev,
        )

        def fused(X):
            s = kernels.heap_walk(X, ht.nodes, ht.leaf, ht.depth,
                                  max_feat=ht.max_feat)
            return tail(s)

        self._kernel = fused
        self.mode = "fused"

    def _lower_binned(self, trees, heap, tail) -> None:
        """The binned rung on K7 (the reference's _try_binned_gbdt): the
        sidecar's edges when they pair with the served model text, else
        thresholds from the ensemble; rows binned once per chunk on the
        host."""
        pred = self.predictor
        edges = None
        data_path = pred.params.model.data_path
        if data_path:
            try:
                with pred.fs.open(data_path) as f:
                    digest = model_text_digest(f.read())
            except OSError:
                digest = None  # the sidecar's range checks still apply
            edges = load_bin_edges(pred.fs, bin_edges_path(data_path),
                                   model_digest=digest)
        table, why = kernels.build_bin_table(trees, self.vocab, edges)
        if table is None:
            self._refuse(why)
            return
        packed = kernels.pack_heap_nodes(heap, table)
        dev = self.device
        packed_t = torch.from_numpy(packed).to(dev)
        leaf_t = torch.from_numpy(np.ascontiguousarray(heap.leaf)).to(dev)
        max_feat = int(heap.feat.max())
        depth, sentinel = heap.depth, table.sentinel

        def binned(chunk: np.ndarray):
            bins = torch.from_numpy(kernels.bin_rows(chunk, table)).to(dev)
            return tail(kernels.binned_walk(bins, packed_t, leaf_t, depth,
                                            sentinel, max_feat=max_feat))

        self._binned = binned
        self._binned_where = "cuda" if dev.type == "cuda" else "plain"
        if dev.type == "cpu":
            # the reference's CPU ladder: the native walk, else the plain
            # one under YTK_NO_NATIVE or with no toolchain. On CUDA the
            # rung launches K7 or raises.
            if kernels.native_serve_available():
                threads = kernels.resolve_kernel_threads()
                leaf_np = np.ascontiguousarray(heap.leaf)

                def binned_native(chunk: np.ndarray):
                    bins = kernels.bin_rows(chunk, table)
                    s = kernels.native_binned_scores(
                        bins, packed, leaf_np, depth, sentinel, threads)
                    return tail(torch.from_numpy(s))

                self._binned = binned_native
                self._binned_where = "native"
            elif not knobs.get_bool("YTK_NO_NATIVE"):
                # the reference's binned_native_to_xla: still the binned
                # rung, on the slower plain walk, and counted
                obs_inc("serve.downgrade.total")
                obs_inc("serve.downgrade.binned_native_to_plain")
                log.warning("serve rung downgrade binned_native_to_plain: "
                            "native serve library unavailable (toolchain?)")
        self.mode = "binned"
        self.bin_mode = table.mode
        self.bin_dtype = str(np.dtype(table.dtype))
        self._bin_table = table  # introspection and tests

    def _refuse(self, reason: str) -> None:
        """The ensemble's shape rules the requested kernel rung out: serve
        stacked and name the downgrade and its reason (rung_info())."""
        self.downgrade = f"{self.requested_mode}_to_stacked"
        self.reason = reason
        log.warning("serve rung downgrade %s: %s", self.downgrade, reason)
