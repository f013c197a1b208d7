"""Registry of the ``YTK_*`` environment knobs the port reads.

Same names, types and defaults as the JAX package's registry
(``ytklearn_tpu/config/knobs.py``), cut to the knobs the GBDT serving path,
the GBDT device-engine trainer, the convex families' blocked evaluation,
the text ingest, the host binning, the resilience layer, the obs planes
and the serving app read. Every
read goes through the typed accessors below, which re-read
``os.environ`` on each call, so a test or an operator may set a knob at run
time.

The micro-batcher's policy (``--max-batch``, ``--max-wait-ms``,
``--max-queue``) comes from CLI flags in both packages; neither declares an
environment knob for it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["Knob", "KNOBS", "get_str", "get_int", "get_float", "get_bool"]


@dataclass(frozen=True)
class Knob:
    name: str
    type: str  # "str" | "int" | "float" | "bool"
    default: object  # parsed value returned when the env var is unset
    doc: str


KNOBS: Dict[str, Knob] = {}


def _knob(name: str, type_: str, default, doc: str) -> None:
    if name in KNOBS:
        raise ValueError(f"duplicate knob declaration: {name}")
    KNOBS[name] = Knob(name, type_, default, doc)


_knob("YTK_SERVE_LADDER", "str", None,
      "serving batch-shape ladder, e.g. `1,8,64,512`")
_knob("YTK_SERVE_FUSED", "bool", False,
      "serve GBDT through the fused heap-walk CUDA kernel (bit-identical "
      "to the stacked rung)")
_knob("YTK_SERVE_BINNED", "bool", False,
      "serve GBDT on the binned rung: rows binned once per batch, the "
      "binned heap-walk CUDA kernel (wins over `YTK_SERVE_FUSED`)")
_knob("YTK_SERVE_PRECISION", "str", "f64",
      "serving precision rung for the einsum scorers (`f64` | `bf16`); "
      "GBDT and GBST score in f64 whatever it asks")
_knob("YTK_TRANSFORM_CACHE", "int", 1_000_000,
      "bound on the serve-time feature-hash resolution cache (raw name -> "
      "scoring column and murmur sign, per loaded model); past it new "
      "names compute uncached")

# -- convex families (same defaults as ytklearn_tpu/config/knobs.py:86-90) --
_knob("YTK_ROW_CHUNK", "int", None,
      "fixed row chunk of the blocked convex loss/grad/score evaluation")
_knob("YTK_CHUNK_BUDGET_MB", "int", 1024,
      "score-intermediate memory budget that sizes the automatic row chunk")

# -- gbdt engine (same defaults as ytklearn_tpu/config/knobs.py:93-125) ----
_knob("YTK_PARTITION", "bool", True,
      "leaf-partitioned GBDT histogram phases (`0` turns them off)")
_knob("YTK_NO_PARTITION", "bool", False,
      "hard-disable leaf-partitioned histograms (wins over `YTK_PARTITION`)")
_knob("YTK_LADDER", "str", None,
      "comma-separated budget-ladder divisors for partitioned histogram "
      "passes (default: `64,256` on cuda, `8,32` on the CPU)")
_knob("YTK_FUSED", "bool", True,
      "fused gather+histogram kernel for partitioned passes (`0` gathers "
      "the rows first and runs the full-scan kernel on them)")
_knob("YTK_FUSED_MAX_ROWS", "int", 1 << 18,
      "max gathered rows per fused-kernel call")
_knob("YTK_GOSS_A", "float", 1.0,
      "GOSS top-gradient-magnitude keep fraction per tree; a value < 1 "
      "enables gradient-based one-side sampling")
_knob("YTK_GOSS_B", "float", 0.1,
      "GOSS sample rate on the non-top remainder (sampled rows carry the "
      "1/b gradient amplification); active only when `YTK_GOSS_A` < 1")
_knob("YTK_EFB", "bool", True,
      "exclusive feature bundling at binning time: merge mutually exclusive "
      "sparse columns into offset-binned bundles (no-op when none exist)")
_knob("YTK_EFB_CONFLICT", "int", 0,
      "max conflicting rows tolerated per EFB bundle (0 = strictly "
      "exclusive, lossless)")

# -- ingest and host binning (same defaults as ytklearn_tpu/config/knobs.py:
# 79-83; the port reads YTK_NO_NATIVE at every dispatch, not once) --------
_knob("YTK_NO_NATIVE", "bool", False,
      "disable the native C++ text parser (the Python parser runs) and "
      "the native serve library (host binning and the CPU binned rung "
      "take their numpy and plain-torch versions)")
_knob("YTK_SKETCH_ROWS", "int", 1 << 25,
      "rows above which host quantile binning streams through the weighted "
      "quantile sketch instead of the full-sort path")

# -- resilience (same defaults as ytklearn_tpu/config/knobs.py:243-256) -----
_knob("YTK_CHAOS", "str", None,
      "deterministic fault injection spec `site:kind:rate:seed[,...]` "
      "(kinds: oserror|error|sigterm|kill); counter-based draws make "
      "every injected fault reproducible")
_knob("YTK_RETRY_MAX", "int", 4,
      "attempt budget per `resilience.retry` site (1 = no retries)")
_knob("YTK_RETRY_BASE_S", "float", 0.05,
      "first-retry backoff in seconds (doubles per attempt, "
      "deterministically jittered into [0.5, 1.0)x)")
_knob("YTK_RETRY_MAX_S", "float", 2.0,
      "backoff ceiling in seconds for the retry exponential")
_knob("YTK_PREEMPT", "bool", True,
      "preemption guard in trainers: SIGTERM/SIGINT deferred to the next "
      "round/iteration boundary, emergency checkpoint, exit 128+signum "
      "(`--resume auto` re-enters training); `0` keeps raw signal "
      "semantics")
_knob("YTK_RETRAIN_LOCK_TTL_S", "float", 900.0,
      "retrain lockfile heartbeat staleness (seconds) after which a new "
      "retrain auto-reclaims the lock; same-host dead owners are "
      "reclaimed immediately")

# -- continual training (same defaults as ytklearn_tpu/config/knobs.py:
# 266-285) -------------------------------------------------------------------
_knob("YTK_GATE_COMPILED", "bool", True,
      "route the continual gate's held-out eval through CompiledScorer "
      "(the serving rungs on the device); `0` keeps the host row walk")
_knob("YTK_CONTINUAL_BAND", "float", 0.0,
      "relative held-out-loss tolerance for retrain promotion: a candidate "
      "passes the metric gate when loss <= incumbent * (1 + band); 0 = "
      "must be no worse (config `continual.band` overrides per run)")
_knob("YTK_CONTINUAL_KEEP", "int", 2,
      "archived incumbent versions kept next to the model path for "
      "`retrain --rollback`")
_knob("YTK_CONTINUAL_STRICT", "bool", False,
      "escalate a rejected retrain candidate to a non-zero exit "
      "(unattended freshness pipelines; default records the rejection "
      "and keeps the incumbent)")
_knob("YTK_CONTINUAL_DRIFT_URL", "str", None,
      "serving base URL (e.g. `http://127.0.0.1:8080`) the retrain "
      "driver fetches `/metrics?quality=1` from: the serve-side drift "
      "snapshot is recorded as an ADVISORY gate input (never pass/fail) "
      "in the gate report and result JSON")

# -- obs planes and serving (same defaults as ytklearn_tpu/config/knobs.py) --
_knob("YTK_OBS", "str", None,
      "`1` enables obs collection without export; `0` force-disables "
      "(wins over the trace-path knobs)")
_knob("YTK_OBS_JAX", "bool", False,
      "the JAX package's XLA trace annotations; the port has no "
      "counterpart and refuses the knob when it is set")
_knob("YTK_TRACE", "str", None,
      "enable obs + write a Chrome-trace/Perfetto JSON to this path at exit")
_knob("YTK_TRACE_JSONL", "str", None,
      "enable obs + write the JSONL event stream to this path at exit")
_knob("YTK_TRACE_SAMPLE", "float", 0.01,
      "serve-side request-tracing head-sample rate: the fraction of "
      "/predict requests whose per-hop spans are recorded and kept as "
      "exemplars (deterministic counter-hashed draws; `0` disables the "
      "tracing plane, `1` = always-on — see "
      "[observability.md](observability.md))")
_knob("YTK_TRACE_SEED", "int", 0,
      "seed for the deterministic trace head sampler (same seed + same "
      "request order = same kept set)")
_knob("YTK_TRACE_EXEMPLARS", "int", 256,
      "per-process exemplar-ring capacity (kept request traces), exported "
      "at `/admin/traces`; shed/504/SLO-violating requests are always "
      "retained, head-sampled ones ride the ring too")
_knob("YTK_OBS_HISTORY_N", "int", 256,
      "per-metric time-series ring length for the metrics history plane "
      "(`/metrics?history=1`); `0` disables history sampling")
_knob("YTK_OBS_HISTORY_S", "float", 1.0,
      "metrics-history sampling interval in seconds (the obs heartbeat "
      "sampler thread snapshots every counter/gauge this often)")
_knob("YTK_PROF", "str", None,
      "profiling plane (ytkprof); not ported yet (ROADMAP.md 1.12): the "
      "serving app refuses to start when it is set to anything but `0`")
_knob("YTK_QUALITY_SAMPLE", "float", 0.05,
      "model-quality plane row-sample rate: the fraction of served rows "
      "whose feature values and scores feed the per-model drift sketches "
      "(deterministic counter-hashed draws; `0` disables the plane, `1` "
      "= every row — see [observability.md](observability.md) "
      "\"Model-quality plane\")")
_knob("YTK_QUALITY_SEED", "int", 0,
      "seed for the deterministic quality row sampler (same seed + same "
      "row order = same sampled set)")
_knob("YTK_QUALITY_B", "int", 64,
      "entry budget per weighted-GK quality sketch (training sidecar and "
      "serve-side streaming sketches; bounds both memory and the "
      "/metrics?quality=1 export size)")
_knob("YTK_QUALITY_EVAL_S", "float", 5.0,
      "quality-evaluator tick interval in seconds: each tick drains the "
      "sampled-row buffers into the sketches, recomputes PSI/KS and "
      "calibration drift, and feeds the drift sentinels")
_knob("YTK_MODEL_METRICS_MAX", "int", 32,
      "named per-model metric-family budget for the mesh-obs accounting "
      "plane (`serve.model.<name>.*` counters, latency rings, burn "
      "sentinels); names past the budget — and 404 name floods — land "
      "in the shared `__overflow__` bucket, so label cardinality is "
      "bounded by construction — see "
      "[observability.md](observability.md) \"Per-model accounting\"")
_knob("YTK_HEALTH", "bool", True,
      "run-health sentinels (NaN/divergence/ingest-rate, SLO burn, drift, "
      "calibration); `0` reduces every check to one attribute load")
_knob("YTK_HEALTH_STRICT", "bool", False,
      "escalate sentinel hits to HealthError naming the flight dump "
      "(unattended production runs)")
_knob("YTK_HEALTH_INGEST_TOL", "float", 0.01,
      "ingest error-rate threshold (fraction) for the parse sentinel")
_knob("YTK_SLO_BURN_WINDOW", "int", 256,
      "requests per SLO burn-rate window: the `health.slo_burn` sentinel "
      "judges the violation rate once per full window")
_knob("YTK_SLO_BURN_BUDGET", "float", 0.1,
      "SLO error budget as a windowed violation-rate fraction: when more "
      "than this fraction of a window's requests exceed the SLO (or are "
      "shed/504'd), `health.slo_burn` fires (strict mode escalates)")
_knob("YTK_HEALTH_DRIFT_PSI", "float", 0.25,
      "per-feature population-stability-index threshold for the serving "
      "drift sentinel: consecutive quality-evaluator ticks with any "
      "feature's PSI above it fire `health.drift` (0.1/0.25 are the "
      "conventional watch/act levels)")
_knob("YTK_HEALTH_DRIFT_KS", "float", 0.35,
      "per-feature Kolmogorov-Smirnov distance threshold for the serving "
      "drift sentinel (fires `health.drift` alongside the PSI test)")
_knob("YTK_HEALTH_DRIFT_WINDOWS", "int", 2,
      "consecutive over-threshold quality-evaluator ticks required before "
      "`health.drift` / `health.calibration` fire (one noisy tick cannot "
      "page anyone); the streak re-arms after each fire")
_knob("YTK_HEALTH_DRIFT_MIN_ROWS", "int", 200,
      "minimum sampled rows before the drift/calibration sentinels judge "
      "a model (a two-request warmup is not a distribution)")
_knob("YTK_HEALTH_CALIBRATION_TOL", "float", 0.1,
      "calibration-drift tolerance: absolute |mean predicted score - "
      "training-sidecar mean| (on the prediction scale) above which "
      "`health.calibration` fires")
_knob("YTK_FLIGHT", "bool", True,
      "flight-recorder auto-install in trainers and the serving fleet's "
      "front; `0` opts out")
_knob("YTK_FLIGHT_N", "int", 4096,
      "flight-recorder event-ring capacity")
_knob("YTK_FLIGHT_DIR", "str", "flight_dumps",
      "flight-dump directory (default: `flight_dumps/`, which is "
      "gitignored — a crash dump must never end up committed)")
_knob("YTK_SERVE_WATCH_S", "float", 5.0,
      "serving hot-reload fingerprint poll interval in seconds "
      "(`0` disables the watcher)")
_knob("YTK_SERVE_REPLICAS", "int", 0,
      "serving fleet size: replica worker processes behind the front "
      "(`0` = single-process serving, `-1` = one per device, or per core "
      "on CPU; CLI `--replicas` overrides — see [serving.md](serving.md))")
_knob("YTK_SERVE_SLO_MS", "float", 100.0,
      "serving p99 latency SLO in ms — the target the AIMD batch-size "
      "controller searches under (`0` disables the controller and "
      "restores the fixed `--max-batch`/`--max-wait-ms` knobs)")
_knob("YTK_SERVE_SLO_MODELS", "str", None,
      "per-model SLO overrides for the mesh-obs burn sentinels, "
      "`name:ms,name2:ms` (e.g. `ctr:25,ranker:100`); listed models get "
      "their own `health.slo_burn` budget at that SLO, unlisted models "
      "inherit the app-wide `--slo-ms` default — see "
      "[observability.md](observability.md) \"Per-model accounting\"")
_knob("YTK_SERVE_CACHE_ROWS", "int", 0,
      "bounded LRU prediction-cache capacity in rows, keyed on (model "
      "fingerprint, feature-row hash); hits bypass the batcher queue and "
      "are bit-identical to the scored path (`0` disables)")
_knob("YTK_SERVE_AIMD_INC", "int", 8,
      "AIMD additive-increase step in rows per clean adjustment window "
      "(the raw target then snaps DOWN to a compiled ladder rung)")
_knob("YTK_SERVE_AIMD_BACKOFF", "float", 0.5,
      "AIMD multiplicative backoff factor applied to the raw batch "
      "target on a p99-SLO violation (must be in (0, 1))")
_knob("YTK_SERVE_AIMD_WINDOW", "int", 16,
      "batches per AIMD adjustment window: the controller judges the "
      "window's worst observed request latency against the SLO once per "
      "window, so one straggler cannot collapse the batch size")
_knob("YTK_SERVE_REPLICAS_MIN", "int", 0,
      "fleet autoscaler floor: minimum replica slots the autoscaler may "
      "reap down to (`0` = follow `--replicas`; CLI `--replicas-min` "
      "overrides — see [serving.md](serving.md) autoscaling)")
_knob("YTK_SERVE_REPLICAS_MAX", "int", 0,
      "fleet autoscaler ceiling: maximum replica slots the autoscaler "
      "may grow to (`0` = follow `--replicas`, which disarms "
      "autoscaling; CLI `--replicas-max` overrides)")
_knob("YTK_SERVE_KERNEL_THREADS", "int", 0,
      "row-parallel threads for the native serve library's binning and "
      "CPU binned scoring (0 = min(8, cores); batches under 64 rows stay "
      "single-threaded)")
_knob("YTK_SERVE_SCALE_INTERVAL_S", "float", 1.0,
      "autoscaler decision-tick interval in seconds (each tick samples "
      "the windowed load signals and advances the hysteresis streaks)")
_knob("YTK_SERVE_SCALE_UP_BACKLOG", "float", 256.0,
      "scale-up backlog threshold in queued+in-flight rows PER READY "
      "REPLICA: a tick above it (or any shed / p99-over-SLO / slo-burn "
      "fire) counts as overloaded")
_knob("YTK_SERVE_SCALE_DOWN_BACKLOG", "float", 16.0,
      "scale-down backlog threshold in rows per ready replica: a tick "
      "below it with zero sheds and p99 comfortably inside the SLO "
      "counts as idle (the gap up to the scale-up threshold is the "
      "hysteresis band)")
_knob("YTK_SERVE_SCALE_UP_WINDOWS", "int", 3,
      "consecutive overloaded ticks required before the autoscaler "
      "grows the fleet (one bursty tick cannot spawn a replica)")
_knob("YTK_SERVE_SCALE_DOWN_WINDOWS", "int", 10,
      "consecutive idle ticks required before the autoscaler reaps a "
      "replica (drain-based: fenced, completed/rerouted, then SIGTERM)")
_knob("YTK_SERVE_SCALE_UP_COOLDOWN_S", "float", 5.0,
      "seconds after a scale-up before the next scale-up may fire (new "
      "capacity must land and be judged before growing again)")
_knob("YTK_SERVE_SCALE_DOWN_COOLDOWN_S", "float", 30.0,
      "seconds after ANY scale decision before a scale-down may fire "
      "(capacity a spike just paid for is never reaped immediately)")

_FALSY = ("0", "false", "no", "off")


def _declared(name: str) -> Knob:
    try:
        return KNOBS[name]
    except KeyError:
        raise KeyError(
            f"undeclared knob {name!r}: declare it in "
            "ytklearn_tpu_torch/config/knobs.py"
        ) from None


def get_raw(name: str) -> Optional[str]:
    """The raw env string, or None when unset."""
    _declared(name)
    return os.environ.get(name)


def get_str(name: str) -> Optional[str]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return raw if raw not in (None, "") else knob.default


def get_int(name: str) -> Optional[int]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return int(raw) if raw not in (None, "") else knob.default


def get_float(name: str) -> Optional[float]:
    knob = _declared(name)
    raw = os.environ.get(name)
    return float(raw) if raw not in (None, "") else knob.default


def get_bool(name: str) -> bool:
    """Unset or empty -> declared default; `0`/`false`/`no`/`off` (any
    case) -> False; anything else -> True."""
    knob = _declared(name)
    raw = os.environ.get(name)
    if raw is None or raw.strip() == "":
        return bool(knob.default)
    return raw.strip().lower() not in _FALSY
