"""ytklearn_tpu_torch.obs — the tracing/metrics subsystem (the JAX
package's ``obs/``, cut to what the serving path and the resilience layer
read).

  span(name, settle=None, **attrs)   nested wall-clock span (ctx manager);
                                     `settle` synchronises a tensor's CUDA
                                     device before the end timestamp
  inc(name, value=1.0)               counter add
  record_collective(verb, nbytes, axis)  one collective call in the census
  collective_census() / reset_collective_census()  the census per verb
  gauge(name, value)                 gauge set
  event(name, **attrs)               instant trace marker
  heartbeat(name, every_s=30)        rate-limited structured progress logger
  enabled() / configure(...)         state; YTK_TRACE / YTK_OBS env knobs
  snapshot() / reset()               registry access
  flush()                            write configured exports now
  export_chrome_trace / export_jsonl / load_jsonl

  health            sentinels (NaN, divergence, ingest rate, empty tree,
                    SLO burn, drift, calibration), `mem.*` telemetry;
                    YTK_HEALTH / YTK_HEALTH_STRICT
  recorder          flight recorder: bounded event ring + postmortem
                    flight_<ts>.json dump on abnormal exit; YTK_FLIGHT_*
  trace             per-hop request tracing: deterministic head sampler,
                    X-Ytk-Trace propagation, tail-retained exemplar ring
                    (/admin/traces); YTK_TRACE_SAMPLE / _SEED / _EXEMPLARS
  start_history_sampler              per-metric (ts, value) rings for
                                     /metrics?history=1; YTK_OBS_HISTORY_*
  model_metrics     per-model counters, latency rings and burn sentinels
  quality           `<model>.sketch.json` baselines and the serve-side
                    drift/calibration monitor; YTK_QUALITY_*
  profiler          ytkprof: phase accounting with settled wall time and
                    per-phase torch.profiler captures (device time per
                    span, a top-k kernel table naming the port's kernels),
                    the build ledger (library builds and loads, first
                    kernel instantiations -> named retrace culprits), a
                    memory-watermark sampler with phase-attributed peaks;
                    YTK_PROF / YTK_PROF_* knobs
"""

from .core import (  # noqa: F401
    NOOP_SPAN,
    REGISTRY,
    Registry,
    Span,
    collective_census,
    configure,
    enabled,
    event,
    flush,
    gauge,
    inc,
    record_collective,
    reset,
    reset_collective_census,
    set_identity,
    settle,
    snapshot,
    span,
)
from .export import (  # noqa: F401
    chrome_trace_events,
    exemplar_trace_events,
    export_chrome_trace,
    export_jsonl,
    load_jsonl,
)
from .heartbeat import (  # noqa: F401
    Heartbeat,
    heartbeat,
    start_history_sampler,
    stop_history_sampler,
)
from . import health, profiler, recorder, trace  # noqa: F401
from .health import HealthError, SLOBurnSentinel  # noqa: F401
from .trace import TRACE_HEADER, configure_tracing  # noqa: F401

