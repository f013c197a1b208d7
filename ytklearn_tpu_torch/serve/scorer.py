"""CompiledScorer — lower a loaded GBDT predictor into batch scoring on a device.

Requests are padded up to the smallest rung of a batch-shape ladder
(default 1/8/64/512, knob YTK_SERVE_LADDER); a batch larger than the top
rung goes in top-rung chunks. Three GBDT rungs:

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
downgrade (`fused_to_stacked`, `binned_to_stacked`) and its reason. A
kernel that fails to build or launch raises. Warmup scores every rung
once on the device.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import knobs
from ..device import resolve_device
from ..gbdt.binning import bin_edges_path, load_bin_edges, model_text_digest
from ..predict.trees import GBDTPredictor
from ..transform.pipeline import TransformPipeline
from . import kernels

log = logging.getLogger(__name__)

DEFAULT_LADDER = (1, 8, 64, 512)


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


class CompiledScorer:
    """Batch scorer for one loaded GBDT model on one device; thread-safe
    after construction (scoring reads only immutable tensors)."""

    def __init__(
        self,
        predictor: GBDTPredictor,
        ladder: Optional[Sequence[int]] = None,
        warmup: bool = True,
        mode: Optional[str] = None,
        precision: Optional[str] = None,
        device=None,
    ):
        if not isinstance(predictor, GBDTPredictor):
            raise TypeError(
                f"no lowering for {type(predictor).__name__}: only GBDT is "
                "ported (ROADMAP.md)"
            )
        self.device = resolve_device(device)
        self.predictor = predictor
        self.ladder = tuple(sorted(set(ladder))) if ladder else parse_ladder()
        self.n_outputs = predictor.n_outputs
        self.requested_mode = mode if mode is not None else resolve_mode()
        if self.requested_mode not in ("stacked", "fused", "binned"):
            raise ValueError(f"unknown serve mode {self.requested_mode!r}")
        # YTK_SERVE_PRECISION picks the rung of the einsum scorers
        # (linear/FM/FFM, not ported); GBDT scores in f64 whatever it asks,
        # as in the JAX package, and rung_info() reports what runs
        requested = (
            precision
            if precision is not None
            else (knobs.get_str("YTK_SERVE_PRECISION") or "f64")
        )
        if requested not in ("f64", "bf16"):
            raise ValueError(f"unknown serve precision {requested!r}")
        self.precision = "f64"
        self.mode = "stacked"  # effective; a kernel lowering may upgrade it
        self.downgrade = ""  # e.g. binned_to_stacked, with its reason:
        self.reason = ""  # why a requested kernel rung serves stacked
        self.bin_mode: Optional[str] = None  # binned rung: edges|thresholds
        self.bin_dtype: Optional[str] = None
        self._lower_gbdt()
        self.dim = len(self.vocab)
        self._fill = math.nan  # absent feature routes to the default child
        self._pipeline = TransformPipeline.for_identity(
            self.vocab, self.dim, fill=self._fill
        )
        if warmup:
            self.warmup()

    # -- public API -------------------------------------------------------

    def warmup(self) -> None:
        """Score every ladder rung once on the device: builds the kernel
        and settles allocations at load time, not on a request."""
        for rung in self.ladder:
            self._exec(np.full((rung, self.dim), self._fill, np.float64))

    @property
    def backend(self) -> str:
        if self.mode in ("fused", "binned"):
            where = "cuda" if self.device.type == "cuda" else "plain"
            return f"{self.mode}-{where}"
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
        """Request dicts -> dense (B, dim) float64, NaN for absent features."""
        return self._pipeline.featurize(rows)

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
        X = self.featurize(rows)
        B = X.shape[0]
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
            s, p = self._exec(chunk)
            out_s.append(s[: rung - pad])
            out_p.append(p[: rung - pad])
        if not out_s:
            shape = (0,) if self.n_outputs == 1 else (0, self.n_outputs)
            return np.empty(shape, np.float64), np.empty(shape, np.float64)
        return np.concatenate(out_s), np.concatenate(out_p)

    # -- lowering ---------------------------------------------------------

    def _lower_gbdt(self) -> None:
        pred = self.predictor
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
