"""ytklearn_tpu_torch.obs — the tracing/metrics subsystem (the JAX
package's ``obs/``, cut to what the serving path and the resilience layer
read).

  span(name, settle=None, **attrs)   nested wall-clock span (ctx manager);
                                     `settle` synchronises a tensor's CUDA
                                     device before the end timestamp
  inc(name, value=1.0)               counter add
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

Not ported yet (ROADMAP.md 1.12): the profiling plane (YTK_PROF), the
jax.monitoring compile watchers, and the trainers' spans and sentinels.
"""

from .core import (  # noqa: F401
    NOOP_SPAN,
    REGISTRY,
    Registry,
    Span,
    configure,
    enabled,
    event,
    flush,
    gauge,
    inc,
    reset,
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
from . import health, recorder, trace  # noqa: F401
from .health import HealthError, SLOBurnSentinel  # noqa: F401
from .trace import TRACE_HEADER, configure_tracing  # noqa: F401


def refuse_profiler() -> None:
    """YTK_PROF arms the JAX package's profiling plane, which the port does
    not have yet: a serving app refuses to start under it."""
    from ..config import knobs

    raw = knobs.get_str("YTK_PROF")
    if raw not in (None, "", "0"):
        raise NotImplementedError(
            "YTK_PROF (the profiling plane) is not ported yet "
            "(ROADMAP.md 1.12, the obs planes)")
