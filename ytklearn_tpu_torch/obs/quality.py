"""Model-quality observability plane: data sketches, drift, calibration
(the JAX package's ``obs/quality.py``).

The rest of obs makes the serving *machinery* observable (traces,
history); this module watches whether the *models are still
right* (McMahan et al., "Ad Click Prediction: a View from the Trenches" —
the production-ML layer that catches what offline metrics
can't). Three pieces:

  train-time sidecar   the trainer dumps `<model>.sketch.json` next to
                       the model: per-feature weighted-GK quantile
                       summaries of the training matrix (the SAME
                       mergeable summary `gbdt/quantile_sketch.py` feeds
                       binning with — XGBoost's weighted quantile sketch),
                       per-feature presence rates, and the
                       held-out score distribution. It rides the
                       serving fingerprint
                       (registry._sidecar_paths), exactly like the
                       `.bins.json` sidecar.
  serve-side monitor   each replica's predict path feeds a bounded
                       streaming sketch per (model name, version):
                       incoming feature values, score/class-probability
                       distribution, and missing-rate counters — sampled
                       by a deterministic counter-hashed ROW sampler
                       (`YTK_QUALITY_SAMPLE`, same splitmix64 family as
                       the chaos layer and the trace head sampler, so a
                       drill reproduces exactly). The hot path only
                       stages sampled rows into a bounded buffer; a
                       periodic evaluator thread (`YTK_QUALITY_EVAL_S`)
                       drains it into the sketches and computes PSI + KS
                       distances against the training sidecar plus
                       calibration drift (mean predicted vs the sidecar's
                       score distribution), feeding the `health.drift` /
                       `health.calibration` sentinels (obs/health.py) and
                       the `/metrics?quality=1` export.
  fleet merge          the fleet front (serve/fleet/front.py) scrapes
                       every replica's `/metrics?quality=1` (with
                       sketches) and `merge_quality_payloads` merges the
                       serve-side GK summaries via `merge_summaries` into
                       one fleet-level drift view: PSI/KS over the union
                       distribution, not averaged.

Missing-sidecar behavior is loud but non-fatal: a model without
`<model>.sketch.json` (legacy dump, non-GBDT family) serves normally with
a named `quality.no_baseline` counter; nothing crashes and nothing is
silently skipped.

Semantics note: the serve-side value sketches record values AS SENT by
clients; features a client omits count toward the missing rate, not the
value distribution. The training-side summaries are built from the
ingest matrix (post missing-fill), so on sparse one-hot features the
missing-rate delta — exported per feature, never gated — is the honest
signal while PSI watches the dense numeric ones.

Knobs: YTK_QUALITY_SAMPLE (0 disables the plane), YTK_QUALITY_SEED,
YTK_QUALITY_B (sketch size), YTK_QUALITY_EVAL_S; sentinel thresholds
ride YTK_HEALTH_DRIFT_* / YTK_HEALTH_CALIBRATION_TOL (obs/health.py).
"""

from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import core, health
from .recorder import thread_guard
from ..config import knobs
from ..gbdt.quantile_sketch import (
    Summary,
    WeightedQuantileSketch,
    merge_summaries,
    prune_summary,
)

log = logging.getLogger("ytklearn_tpu_torch.obs.quality")

QUALITY_SCHEMA = "ytk-quality-sketch"

#: rows staged per model between evaluator ticks; overflow is counted
#: (`quality.buffer_dropped`), never silently widened — the buffer bounds
#: the request-path memory the plane can ever hold
BUFFER_ROWS = 8192

#: the training-side sketch subsamples the matrix to this many rows
#: (deterministic stride) — drift baselines need stable quantiles, not
#: exact quantiles of 78M rows
TRAIN_SKETCH_ROWS = 1 << 18

#: probability clamp for PSI (a zero observed bin must read as "very
#: drifted", not log(0))
PSI_EPS = 1e-6

#: PSI quantile-bin count (the industry-standard decile convention)
PSI_BINS = 10

_M64 = (1 << 64) - 1
_GOLD = 0x9E3779B97F4A7C15


def quality_sidecar_path(data_path: str) -> str:
    return data_path + ".sketch.json"


# ---------------------------------------------------------------------------
# Deterministic counter-hashed row sampler (the chaos/trace draw family)
# ---------------------------------------------------------------------------


def _mix64(x: int) -> int:
    """splitmix64 finalizer — scalar reference; `sample_mask` is the
    vectorized twin and tests pin them equal."""
    x = (x + _GOLD) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def row_keep(seed: int, n: int, rate: float) -> bool:
    """The deterministic per-ROW sampling decision for row counter `n`
    (1-based) under `seed` — public like chaos.site_draw / trace.head_keep
    so tests and drills precompute the kept set exactly."""
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return _mix64((seed * _GOLD + n) & _M64) < int(rate * float(1 << 64))


def sample_mask(seed: int, start: int, n: int, rate: float) -> np.ndarray:
    """Vectorized `row_keep` for row counters start+1 .. start+n — one
    numpy pass per request instead of n python hashes. Bit-identical to
    the scalar reference (test-pinned)."""
    if rate >= 1.0:
        return np.ones(n, bool)
    if rate <= 0.0 or n <= 0:
        return np.zeros(n, bool)
    threshold = np.uint64(int(rate * float(1 << 64)) & _M64)
    base = (seed * _GOLD) & _M64
    with np.errstate(over="ignore"):
        x = np.uint64(base) + np.arange(
            start + 1, start + n + 1, dtype=np.uint64
        )
        x = x + np.uint64(_GOLD)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    return x < threshold


# ---------------------------------------------------------------------------
# Distribution distances on GK summaries
# ---------------------------------------------------------------------------


def summary_to_json(s: Summary) -> dict:
    return {
        "value": [float(v) for v in s.value],
        "rmin": [float(v) for v in s.rmin],
        "rmax": [float(v) for v in s.rmax],
        "w": [float(v) for v in s.w],
        "total": float(s.total),
    }


def summary_from_json(d: dict) -> Summary:
    return Summary(
        value=np.asarray(d["value"], np.float64),
        rmin=np.asarray(d["rmin"], np.float64),
        rmax=np.asarray(d["rmax"], np.float64),
        w=np.asarray(d["w"], np.float64),
        total=float(d["total"]),
    )


def summary_cdf(s: Summary, xs) -> np.ndarray:
    """Estimated CDF of the sketched distribution at `xs`: mass of values
    <= x over total, via the rmax rank bound — EXACT for unpruned
    summaries (rmax is the true cumulative there), within the GK rank
    error otherwise."""
    xs = np.asarray(xs, np.float64)
    if s.size == 0 or s.total <= 0:
        return np.zeros(xs.shape)
    idx = np.searchsorted(s.value, xs, side="right") - 1
    cdf = np.where(idx >= 0, s.rmax[np.maximum(idx, 0)] / s.total, 0.0)
    return np.clip(cdf, 0.0, 1.0)


def quantile_edges(s: Summary, bins: int = PSI_BINS) -> np.ndarray:
    """`bins-1` interior quantile edges of the sketched distribution
    (deduped — discrete distributions can collapse bins)."""
    if s.size == 0:
        return np.zeros(0)
    ranks = (np.arange(1, bins) / bins) * s.total
    mid = 0.5 * (s.rmin + s.rmax)
    pos = np.searchsorted(mid, ranks, side="left").clip(0, s.size - 1)
    return np.unique(s.value[pos])


def bin_probs(s: Summary, edges: np.ndarray) -> np.ndarray:
    """Per-bin probability mass of `s` over the (len(edges)+1) intervals
    the edges cut the line into."""
    cdf = summary_cdf(s, edges)
    return np.diff(np.concatenate([[0.0], cdf, [1.0]]))


def psi_from_probs(expected, actual) -> float:
    """Population stability index over matched bin probabilities:
    sum((a - e) * ln(a / e)), probabilities clamped at PSI_EPS then
    renormalized. The hand-pinnable primitive."""
    e = np.clip(np.asarray(expected, np.float64), PSI_EPS, None)
    a = np.clip(np.asarray(actual, np.float64), PSI_EPS, None)
    e = e / e.sum()
    a = a / a.sum()
    return float(np.sum((a - e) * np.log(a / e)))


def psi_summaries(
    baseline: Summary, observed: Summary, bins: int = PSI_BINS
) -> Optional[float]:
    """PSI of `observed` against `baseline`, binned at the BASELINE's
    quantile edges (the training distribution defines the bins; serving
    traffic is judged against them). None when either side is empty."""
    if baseline.size == 0 or observed.size == 0:
        return None
    edges = quantile_edges(baseline, bins)
    if edges.size == 0:
        return None
    return psi_from_probs(bin_probs(baseline, edges), bin_probs(observed, edges))


def ks_summaries(
    a: Summary, b: Summary, max_points: int = 2048
) -> Optional[float]:
    """Kolmogorov–Smirnov distance (max |CDF_a - CDF_b|) evaluated over
    the union of both summaries' support points."""
    if a.size == 0 or b.size == 0:
        return None
    xs = np.unique(np.concatenate([a.value, b.value]))
    if len(xs) > max_points:
        xs = xs[:: (len(xs) // max_points) + 1]
    return float(np.max(np.abs(summary_cdf(a, xs) - summary_cdf(b, xs))))


def score_vector(preds) -> np.ndarray:
    """Predictions -> the 1-D quantity the score distribution tracks:
    the prediction itself for single-output models, the per-row TOP-CLASS
    probability for (B, K) multiclass outputs (a confidence collapse
    after a bad promotion shows up as a left-shift of this). The SAME
    reduction runs train-side (sidecar) and serve-side, so the
    distributions are comparable by construction."""
    p = np.asarray(preds, np.float64)
    if p.ndim <= 1:
        return p.reshape(-1)
    return np.max(p, axis=-1)


# ---------------------------------------------------------------------------
# Train-time sidecar: build / dump / load
# ---------------------------------------------------------------------------


def _stride_sample(n: int, cap: int = TRAIN_SKETCH_ROWS) -> np.ndarray:
    """Deterministic row subsample: every k-th row, capped at `cap`."""
    if n <= cap:
        return np.arange(n)
    return np.arange(0, n, max(1, n // cap))[:cap]


def build_training_sketch(
    X: np.ndarray,
    feature_names: Sequence[str],
    weight: Optional[np.ndarray] = None,
    preds: Optional[np.ndarray] = None,
    b: Optional[int] = None,
) -> dict:
    """The `<model>.sketch.json` payload: per-feature pruned GK summaries
    + presence rates over a deterministic row subsample of the training
    matrix, plus the (held-out, when the trainer has one) score
    distribution. numpy-only — runs once per dump on the host."""
    if b is None:
        b = knobs.get_int("YTK_QUALITY_B")
    n, F = X.shape
    idx = _stride_sample(n)
    w = None if weight is None else np.asarray(weight, np.float64)[idx]
    features: Dict[str, dict] = {}
    for f in range(min(F, len(feature_names))):
        col = np.asarray(X[idx, f], np.float64)
        finite = np.isfinite(col)
        present = float(np.mean(finite)) if len(col) else 0.0
        vals = col[finite]
        wv = w[finite] if w is not None else None
        sk = WeightedQuantileSketch(b=b)
        if len(vals):
            sk.push(vals, wv)
        features[str(feature_names[f])] = {
            "present": round(present, 6),
            "summary": summary_to_json(prune_summary(sk.summary(), b)),
        }
    payload = {
        "schema": QUALITY_SCHEMA,
        "version": 1,
        "rows": int(n),
        "sampled_rows": int(len(idx)),
        "features": features,
    }
    if preds is not None:
        payload["score"] = build_score_block(preds, b=b)
    return payload


def build_score_block(preds, b: Optional[int] = None) -> dict:
    """The sidecar's `score` block: GK summary + mean of the (held-out)
    prediction distribution, reduced through `score_vector` so train and
    serve compare the same quantity."""
    if b is None:
        b = knobs.get_int("YTK_QUALITY_B")
    sv = score_vector(preds)
    sv = sv[np.isfinite(sv)]
    sv = sv[_stride_sample(len(sv))]
    sk = WeightedQuantileSketch(b=b)
    if len(sv):
        sk.push(sv)
    return {
        "n": int(len(sv)),
        "mean": float(np.mean(sv)) if len(sv) else 0.0,
        "summary": summary_to_json(prune_summary(sk.summary(), b)),
    }


def dump_quality_sidecar(
    fs, path: str, payload: dict, model_digest: Optional[str] = None
) -> None:
    """Atomic sidecar dump (same discipline as `.bins.json`: written
    BEFORE the model file, `model_digest` = sha256 of the model text
    about to land so a consumer can verify the pairing)."""
    import json

    if model_digest is not None:
        payload = {**payload, "model_digest": model_digest}
    with fs.atomic_open(path) as f:
        json.dump(payload, f)


def load_quality_baseline(
    fs, path: str, model_digest: Optional[str] = None
) -> Optional[dict]:
    """Parsed baseline: {"features": {name: {"summary": Summary,
    "present": float}}, "score": Summary | None, "score_mean": float,
    "rows": int} — or None (missing / unreadable / digest mismatch), in
    which case the caller serves normally and counts
    `quality.no_baseline` (loud but non-fatal by contract)."""
    import json

    if not fs.exists(path):
        return None
    try:
        with fs.open(path) as f:
            payload = json.load(f)
        if payload.get("schema") != QUALITY_SCHEMA:
            raise ValueError(f"not a quality sidecar: {path}")
        want = payload.get("model_digest")
        if model_digest is not None and want is not None \
                and want != model_digest:
            log.warning(
                "quality sidecar %s was dumped for a different model "
                "(digest mismatch); treating the model as baseline-less",
                path,
            )
            return None
        features = {
            str(name): {
                "summary": summary_from_json(info["summary"]),
                "present": float(info.get("present", 1.0)),
            }
            for name, info in (payload.get("features") or {}).items()
        }
        score = payload.get("score") or {}
        return {
            "features": features,
            "score": (
                summary_from_json(score["summary"])
                if "summary" in score else None
            ),
            "score_mean": float(score.get("mean", 0.0)),
            "rows": int(payload.get("rows", 0)),
        }
    except (OSError, ValueError, KeyError, TypeError) as e:
        log.warning(
            "quality sidecar %s unreadable (%s: %s); treating the model "
            "as baseline-less", path, type(e).__name__, e,
        )
        return None


# ---------------------------------------------------------------------------
# Serve-side monitor
# ---------------------------------------------------------------------------


class _ModelState:
    """Streaming quality state for one served (model name, version)."""

    __slots__ = (
        "key", "model", "version", "fingerprint", "lock", "baseline",
        "no_baseline", "rows_seen", "rows_sampled", "buf", "buf_dropped",
        "sketches", "missing", "score_sketch", "score_sum", "score_n",
        "last_eval", "drift", "calibration", "b",
    )

    def __init__(self, key: str, model: str, version: int,
                 fingerprint: str, baseline: Optional[dict], b: int):
        self.key = key
        self.model = model
        self.version = version
        self.fingerprint = fingerprint
        self.lock = threading.Lock()
        self.baseline = baseline
        self.no_baseline = baseline is None
        self.rows_seen = 0
        self.rows_sampled = 0
        self.buf: List[Tuple[dict, float]] = []
        self.buf_dropped = 0
        self.b = b
        # per-feature streaming sketches, bounded by the BASELINE feature
        # set (cardinality is the sidecar's, never the client's)
        self.sketches: Dict[str, WeightedQuantileSketch] = {}
        self.missing: Dict[str, int] = {}
        self.score_sketch = WeightedQuantileSketch(b=b)
        self.score_sum = 0.0
        self.score_n = 0
        self.last_eval: Optional[dict] = None
        # sentinels are fed ONLY from evaluator ticks (feed_sentinels),
        # so their windows count evaluator intervals, not scrapes
        self.drift = health.DriftSentinel("serve.quality")
        self.calibration = health.CalibrationSentinel("serve.quality")


class QualityMonitor:
    """Per-process model-quality monitor: observe() stages sampled rows
    (the request hot path — one vectorized hash + a bounded list append),
    evaluate() does all sketch pushes and distance math (the evaluator
    thread / metrics scrape path)."""

    def __init__(
        self,
        sample: Optional[float] = None,
        seed: Optional[int] = None,
        b: Optional[int] = None,
    ):
        self.rate = float(
            sample if sample is not None
            else (knobs.get_float("YTK_QUALITY_SAMPLE") or 0.0)
        )
        self.seed = int(
            seed if seed is not None else (knobs.get_int("YTK_QUALITY_SEED") or 0)
        )
        self.b = int(b if b is not None else knobs.get_int("YTK_QUALITY_B"))
        self._lock = threading.Lock()
        self._counter = 0  # row counter feeding the deterministic sampler
        self._threshold = int(min(max(self.rate, 0.0), 1.0) * float(1 << 64))
        self._states: Dict[str, _ModelState] = {}

    # -- configuration -----------------------------------------------------

    def configure(self, sample=None, seed=None, b=None, reset=False) -> None:
        with self._lock:
            if sample is not None:
                self.rate = float(sample)
                self._threshold = int(
                    min(max(self.rate, 0.0), 1.0) * float(1 << 64)
                )
            if seed is not None:
                self.seed = int(seed)
            if b is not None:
                self.b = int(b)
            if reset:
                self._counter = 0
                self._states = {}

    def enabled(self) -> bool:
        return self.rate > 0.0

    # -- the request hot path ----------------------------------------------

    def _make_state(self, entry) -> _ModelState:
        """Build (and baseline-load) a state for a served entry — called
        OUTSIDE every lock: the sidecar read is IO and must never sit on
        the request path's lock."""
        baseline = None
        data_path = None
        try:
            data_path = getattr(entry.predictor.params.model, "data_path", None)
            if data_path:
                baseline = load_quality_baseline(
                    entry.predictor.fs, quality_sidecar_path(data_path)
                )
        except Exception as e:  # noqa: BLE001 — baseline-less beats a 500
            log.warning(
                "quality baseline load failed for %r (%s: %s); serving "
                "baseline-less", entry.name, type(e).__name__, e,
            )
        st = _ModelState(
            f"{entry.name}@v{entry.version}", entry.name, entry.version,
            getattr(entry, "fingerprint", ""), baseline, self.b,
        )
        if st.no_baseline:
            core.inc("quality.no_baseline")
            core.event(
                "quality.no_baseline", model=entry.name,
                version=entry.version, path=str(data_path),
            )
            log.warning(
                "model %r v%d has no quality sidecar (%s): serving "
                "normally, drift/calibration unmonitored",
                entry.name, entry.version,
                quality_sidecar_path(data_path) if data_path else "no path",
            )
        return st

    def state_for(self, entry) -> _ModelState:
        key = f"{entry.name}@v{entry.version}"
        with self._lock:
            st = self._states.get(key)
        if st is None:
            built = self._make_state(entry)  # IO outside the lock
            with self._lock:
                st = self._states.setdefault(key, built)
                if st is built:
                    # version turnover (hot reload / rollback): retire the
                    # other versions of this model name, or a long-running
                    # server under continual retraining accumulates one
                    # full state (baseline + sketches + buffer) per
                    # retired version forever and re-evaluates them all
                    # every tick. An in-flight observe holding a retired
                    # state still completes; its staged rows just never
                    # evaluate — monitoring, not accounting.
                    for old_key in [
                        k for k, s in self._states.items()
                        if s.model == entry.name and k != key
                    ]:
                        del self._states[old_key]
        return st

    def observe(self, entry, rows: Sequence[dict], preds) -> int:
        """Feed one scored request (rows + model outputs). Returns the
        number of rows the deterministic sampler kept (staged for the
        next evaluate())."""
        if self.rate <= 0.0 or not rows:
            return 0
        n = len(rows)
        with self._lock:
            start = self._counter
            self._counter += n
        st = self.state_for(entry)
        # small requests (the serve hot path is dominated by 1-row HTTP
        # requests) take a pure-int scalar draw — the numpy temporaries
        # of sample_mask cost more than the whole request's bookkeeping
        # at B=1; both paths are the same splitmix64 draws (test-pinned)
        if n <= 16:
            thr = self._threshold
            base = (self.seed * _GOLD) & _M64
            kept_idx = [
                i for i in range(n)
                if _mix64((base + start + 1 + i) & _M64) < thr
            ]
        else:
            kept_idx = np.nonzero(
                sample_mask(self.seed, start, n, self.rate)
            )[0]
        kept = len(kept_idx)
        core.inc("quality.rows_seen", n)
        if st.no_baseline:
            with st.lock:
                st.rows_seen += n
                st.rows_sampled += kept  # counted, not sketched
            return kept
        if not kept:
            with st.lock:
                st.rows_seen += n
            return 0
        sv = score_vector(preds)
        staged = [
            (rows[i], float(sv[i]) if i < len(sv) else math.nan)
            for i in kept_idx
        ]
        with st.lock:
            st.rows_seen += n
            space = BUFFER_ROWS - len(st.buf)
            if space < len(staged):
                st.buf_dropped += len(staged) - max(space, 0)
                core.inc("quality.buffer_dropped",
                         len(staged) - max(space, 0))
                staged = staged[: max(space, 0)]
            st.buf.extend(staged)
            st.rows_sampled += len(staged)
        core.inc("quality.rows_sampled", len(staged))
        return len(staged)

    # -- evaluation ---------------------------------------------------------

    def _ingest(self, st: _ModelState, buf: List[Tuple[dict, float]]) -> None:
        """Drain staged rows into the streaming sketches (called under
        st.lock; pure numpy — no IO, no locks below this one)."""
        if not buf:
            return
        feats = st.baseline["features"]
        per_feature: Dict[str, List[float]] = {}
        scores: List[float] = []
        for fmap, sv in buf:
            for name in feats:
                v = fmap.get(name)
                if v is None or not isinstance(v, (int, float)) \
                        or not math.isfinite(v):
                    st.missing[name] = st.missing.get(name, 0) + 1
                else:
                    per_feature.setdefault(name, []).append(float(v))
            if math.isfinite(sv):
                scores.append(sv)
        for name, vals in per_feature.items():
            sk = st.sketches.get(name)
            if sk is None:
                sk = st.sketches[name] = WeightedQuantileSketch(b=st.b)
            sk.push(np.asarray(vals, np.float64))
        if scores:
            arr = np.asarray(scores, np.float64)
            st.score_sketch.push(arr)
            st.score_sum += float(np.sum(arr))
            st.score_n += len(arr)

    def _compute(self, st: _ModelState) -> dict:
        """Per-feature PSI/KS + score drift + calibration (under st.lock)."""
        feats_out: Dict[str, dict] = {}
        psi_max = ks_max = 0.0
        worst: List[Tuple[float, str]] = []
        base = st.baseline
        for name, info in base["features"].items():
            sk = st.sketches.get(name)
            # ONE summary() per feature per tick: it merges the whole GK
            # level cascade, and this runs under st.lock next to the
            # request path's staging
            serve_sum = sk.summary() if sk is not None else None
            rows = int(serve_sum.total) if serve_sum is not None else 0
            rec: Dict[str, object] = {
                "rows": rows,
                "missing": st.missing.get(name, 0),
                "missing_rate": round(
                    st.missing.get(name, 0) / max(st.rows_sampled, 1), 4
                ),
                "baseline_present": info["present"],
            }
            if serve_sum is not None and rows > 0:
                p = psi_summaries(info["summary"], serve_sum)
                k = ks_summaries(info["summary"], serve_sum)
                if p is not None:
                    rec["psi"] = round(p, 4)
                    psi_max = max(psi_max, p)
                    worst.append((p, name))
                if k is not None:
                    rec["ks"] = round(k, 4)
                    ks_max = max(ks_max, k)
            feats_out[name] = rec
        score_psi = None
        cal_delta = None
        mean_pred = None
        if st.score_n > 0:
            mean_pred = st.score_sum / st.score_n
            if base["score"] is not None:
                score_psi = psi_summaries(base["score"], st.score_sketch.summary())
                cal_delta = abs(mean_pred - base["score_mean"])
        worst.sort(reverse=True)
        return {
            "rows_seen": st.rows_seen,
            "rows_sampled": st.rows_sampled,
            "buffer_dropped": st.buf_dropped,
            "psi_max": round(psi_max, 4),
            "ks_max": round(ks_max, 4),
            "worst_features": [name for _p, name in worst[:3]],
            "features": feats_out,
            "score": {
                "psi": round(score_psi, 4) if score_psi is not None else None,
                "mean_pred": (
                    round(mean_pred, 6) if mean_pred is not None else None
                ),
                "baseline_mean": round(base["score_mean"], 6),
                "calibration_delta": (
                    round(cal_delta, 6) if cal_delta is not None else None
                ),
            },
        }

    def evaluate(self, feed_sentinels: bool = True) -> dict:
        """Drain every model's staged rows, recompute drift metrics, and
        (from the evaluator thread only) feed the sentinels. Returns the
        per-model metrics. Cheap when nothing was sampled."""
        with self._lock:
            states = list(self._states.values())
        out: Dict[str, dict] = {}
        psi_all = ks_all = cal_all = 0.0
        for st in states:
            if st.no_baseline:
                with st.lock:
                    out[st.key] = {
                        "model": st.model, "version": st.version,
                        "no_baseline": True, "rows_seen": st.rows_seen,
                        "rows_sampled": st.rows_sampled,
                    }
                continue
            with st.lock:
                buf, st.buf = st.buf, []
                self._ingest(st, buf)
                metrics = self._compute(st)
                st.last_eval = metrics
                rows_sampled = st.rows_sampled
            metrics = {
                "model": st.model, "version": st.version,
                "fingerprint": st.fingerprint, "no_baseline": False,
                **metrics,
            }
            out[st.key] = metrics
            psi_all = max(psi_all, metrics["psi_max"])
            ks_all = max(ks_all, metrics["ks_max"])
            cal = metrics["score"]["calibration_delta"]
            if cal is not None:
                cal_all = max(cal_all, cal)
            if feed_sentinels:
                # sentinel observe OUTSIDE st.lock: a strict-mode fire
                # writes a flight dump, and IO under a request-path lock
                # would stall the request path
                st.drift.observe(
                    metrics["psi_max"], metrics["ks_max"], rows_sampled,
                    model=st.model, version=st.version,
                    worst_features=",".join(metrics["worst_features"]),
                )
                if cal is not None:
                    st.calibration.observe(
                        cal, rows_sampled, model=st.model,
                        version=st.version,
                        mean_pred=metrics["score"]["mean_pred"],
                        baseline_mean=metrics["score"]["baseline_mean"],
                    )
        if states:
            core.gauge("quality.psi_max", psi_all)
            core.gauge("quality.ks_max", ks_all)
            core.gauge("quality.calibration_delta", cal_all)
        core.inc("quality.evals")
        return out

    # -- export -------------------------------------------------------------

    def snapshot(
        self, include_sketches: bool = False, refresh: bool = True
    ) -> dict:
        """The `/metrics?quality=1` document. `include_sketches`
        additionally serializes the per-feature serve-side GK summaries
        AND the baseline summaries — what a fleet front merges and judges
        against."""
        models = (
            self.evaluate(feed_sentinels=False) if refresh
            else {
                st.key: {"model": st.model, "version": st.version,
                         "no_baseline": st.no_baseline,
                         **(st.last_eval or {})}
                for st in list(self._states.values())
            }
        )
        if include_sketches:
            with self._lock:
                states = list(self._states.values())
            for st in states:
                m = models.get(st.key)
                if m is None or st.no_baseline:
                    continue
                with st.lock:
                    m["sketches"] = {
                        name: summary_to_json(prune_summary(sk.summary(), st.b))
                        for name, sk in st.sketches.items()
                    }
                    m["baseline"] = {
                        name: summary_to_json(info["summary"])
                        for name, info in st.baseline["features"].items()
                    }
                    m["baseline_score"] = (
                        summary_to_json(st.baseline["score"])
                        if st.baseline["score"] is not None else None
                    )
                    m["baseline_score_mean"] = st.baseline["score_mean"]
                    m["score_sketch"] = summary_to_json(
                        prune_summary(st.score_sketch.summary(), st.b)
                    )
                    m["score_sum"] = st.score_sum
                    m["score_n"] = st.score_n
        return {
            "sample": self.rate,
            "seed": self.seed,
            "sketch_b": self.b,
            "models": models,
        }


# ---------------------------------------------------------------------------
# Fleet merge: per-replica serve-side summaries -> one fleet drift view
# ---------------------------------------------------------------------------


def merge_quality_payloads(per_replica: Dict[str, dict]) -> dict:
    """Merge replica `/metrics?quality=1` payloads (with sketches) into
    the fleet-level view: per (model, version), every replica's
    serve-side GK summary merges via `merge_summaries` — associative and
    commutative, so replica order cannot change the answer (test-pinned)
    — and fleet PSI/KS are computed over the MERGED distribution against
    the shared baseline. Returns {"fleet": {model_key: {...}},
    "replicas": {rid: {model_key: compact}}}."""
    fleet: Dict[str, dict] = {}
    compact: Dict[str, dict] = {}
    merged_sketch: Dict[str, Dict[str, Summary]] = {}
    merged_score: Dict[str, Summary] = {}
    baselines: Dict[str, dict] = {}
    for rid in sorted(per_replica):
        payload = per_replica[rid] or {}
        rep_compact: Dict[str, dict] = {}
        for key, m in (payload.get("models") or {}).items():
            rep_compact[key] = {
                "psi_max": m.get("psi_max"),
                "ks_max": m.get("ks_max"),
                "rows_sampled": m.get("rows_sampled"),
                "no_baseline": m.get("no_baseline", False),
            }
            # ONE dict shape for both branches: replicas can legitimately
            # disagree on no_baseline for the same key (one spawned before
            # the sidecar landed, one after) — a shape split here was a
            # KeyError that took /metrics?quality=1 down fleet-wide
            f = fleet.setdefault(key, {
                "model": m.get("model"), "version": m.get("version"),
                "no_baseline": True, "rows_seen": 0, "rows_sampled": 0,
                "replicas": 0, "score_sum": 0.0, "score_n": 0,
            })
            f["rows_seen"] += int(m.get("rows_seen") or 0)
            f["rows_sampled"] += int(m.get("rows_sampled") or 0)
            if m.get("no_baseline"):
                continue
            # any replica WITH a baseline makes the fleet view a real one
            f["no_baseline"] = False
            f["replicas"] += 1
            f["score_sum"] += float(m.get("score_sum") or 0.0)
            f["score_n"] += int(m.get("score_n") or 0)
            if key not in baselines and m.get("baseline"):
                baselines[key] = m
            sketches = merged_sketch.setdefault(key, {})
            for name, sj in (m.get("sketches") or {}).items():
                s = summary_from_json(sj)
                prev = sketches.get(name)
                sketches[name] = s if prev is None else merge_summaries(prev, s)
            if m.get("score_sketch"):
                s = summary_from_json(m["score_sketch"])
                prev = merged_score.get(key)
                merged_score[key] = (
                    s if prev is None else merge_summaries(prev, s)
                )
        compact[rid] = rep_compact
    for key, f in fleet.items():
        if f.get("no_baseline"):
            # every replica served this key baseline-less: drop the
            # accumulator fields that only mean something with a baseline
            f.pop("replicas", None)
            f.pop("score_sum", None)
            f.pop("score_n", None)
            continue
        base_m = baselines.get(key)
        if base_m is None:
            continue
        feats_out: Dict[str, dict] = {}
        psi_max = ks_max = 0.0
        worst: List[Tuple[float, str]] = []
        for name, bj in (base_m.get("baseline") or {}).items():
            base_s = summary_from_json(bj)
            serve_s = merged_sketch.get(key, {}).get(name)
            if serve_s is None or serve_s.total <= 0:
                continue
            p = psi_summaries(base_s, serve_s)
            k = ks_summaries(base_s, serve_s)
            rec = {"rows": int(serve_s.total)}
            if p is not None:
                rec["psi"] = round(p, 4)
                psi_max = max(psi_max, p)
                worst.append((p, name))
            if k is not None:
                rec["ks"] = round(k, 4)
                ks_max = max(ks_max, k)
            feats_out[name] = rec
        worst.sort(reverse=True)
        f["features"] = feats_out
        f["psi_max"] = round(psi_max, 4)
        f["ks_max"] = round(ks_max, 4)
        f["worst_features"] = [name for _p, name in worst[:3]]
        score_s = merged_score.get(key)
        base_score = base_m.get("baseline_score")
        score_rec: Dict[str, object] = {
            "baseline_mean": base_m.get("baseline_score_mean"),
        }
        if f["score_n"] > 0:
            mean_pred = f["score_sum"] / f["score_n"]
            score_rec["mean_pred"] = round(mean_pred, 6)
            if base_m.get("baseline_score_mean") is not None:
                score_rec["calibration_delta"] = round(
                    abs(mean_pred - float(base_m["baseline_score_mean"])), 6
                )
        if score_s is not None and base_score:
            p = psi_summaries(summary_from_json(base_score), score_s)
            if p is not None:
                score_rec["psi"] = round(p, 4)
        f["score"] = score_rec
        f.pop("score_sum", None)
        f.pop("score_n", None)
    return {"fleet": fleet, "replicas": compact}


# ---------------------------------------------------------------------------
# Module-level default monitor + evaluator thread
# ---------------------------------------------------------------------------

_default: Optional[QualityMonitor] = None
_default_lock = threading.Lock()


def default_monitor() -> QualityMonitor:
    global _default
    with _default_lock:
        if _default is None:
            _default = QualityMonitor()
        return _default


def configure_quality(sample=None, seed=None, b=None, reset=False) -> None:
    """Runtime override of the YTK_QUALITY_* env knobs (tests/drills)."""
    default_monitor().configure(sample=sample, seed=seed, b=b, reset=reset)


def quality_enabled() -> bool:
    return default_monitor().enabled()


#: the singleton evaluator thread + stop event (the obs history-sampler
#: discipline: daemon thread, start is idempotent, stop joins)
_evaluator: Optional[threading.Thread] = None
_evaluator_stop: Optional[threading.Event] = None
_evaluator_lock = threading.Lock()


@thread_guard
def _evaluator_loop(stop: threading.Event, interval_s: float) -> None:
    while not stop.wait(interval_s):
        try:
            default_monitor().evaluate(feed_sentinels=True)
        except health.HealthError:
            raise  # strict escalation is the operator's explicit ask
        except Exception:  # noqa: BLE001 — the evaluator must survive
            log.exception("quality evaluator tick crashed")


def start_quality_evaluator(interval_s: Optional[float] = None) -> bool:
    """Arm the periodic drift/calibration evaluator. Idempotent — the
    serving layer calls this at every start(); False when the plane is
    off (YTK_QUALITY_SAMPLE=0)."""
    global _evaluator, _evaluator_stop
    if not default_monitor().enabled():
        return False
    every = (
        interval_s if interval_s is not None
        else knobs.get_float("YTK_QUALITY_EVAL_S")
    ) or 5.0
    with _evaluator_lock:
        if _evaluator is not None and _evaluator.is_alive():
            return True
        stop = threading.Event()
        t = threading.Thread(
            target=_evaluator_loop, args=(stop, float(every)),
            name="ytk-quality-eval", daemon=True,
        )
        _evaluator, _evaluator_stop = t, stop
        t.start()
    return True


def stop_quality_evaluator() -> None:
    """Stop the evaluator thread (joined) — test isolation; production
    processes just exit (the thread is a daemon)."""
    global _evaluator, _evaluator_stop
    with _evaluator_lock:
        t, stop = _evaluator, _evaluator_stop
        _evaluator, _evaluator_stop = None, None
    if stop is not None:
        stop.set()
    if t is not None:
        t.join(timeout=10.0)


def evaluator_running() -> bool:
    with _evaluator_lock:
        return _evaluator is not None and _evaluator.is_alive()
