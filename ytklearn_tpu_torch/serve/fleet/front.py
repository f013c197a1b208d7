"""The latency helpers of the serving fleet's front (the JAX package's
``serve/fleet/front.py:173-211``): the one percentile computation the
server's latency ring and the per-model plane share, and the windowing of
(wall_ts, ms) ring samples. The front process itself (replica fan-out,
coalescing, fleet /metrics) is not ported yet (ROADMAP.md 1.6)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def latency_percentiles(vals: List[float]) -> Dict[str, float]:
    """THE latency-percentile computation — server._LatencyWindow and the
    per-model plane delegate here, so their payloads can't diverge."""
    if not vals:
        return {"count": 0}
    arr = np.asarray(vals)
    return {
        "count": len(vals),
        "p50_ms": round(float(np.percentile(arr, 50)), 3),
        "p99_ms": round(float(np.percentile(arr, 99)), 3),
        "p999_ms": round(float(np.percentile(arr, 99.9)), 3),
        "max_ms": round(float(arr.max()), 3),
    }


#: samples older than this drop out of a ring union: an IDLE replica's
#: ring holds its last samples forever, and without windowing those stale
#: latencies dilute the union's p99 with minutes-old traffic
RING_UNION_WINDOW_S = 60.0


def window_ring_ms(
    raw: List, now: float, window_s: float = RING_UNION_WINDOW_S
) -> List[float]:
    """`?raw=1` ring samples -> the ms values recent enough for a ring
    union. Samples are (wall_ts, ms) pairs; bare ms floats pass through —
    no timestamp to window on beats dropping the signal."""
    out: List[float] = []
    for v in raw:
        if isinstance(v, (list, tuple)) and len(v) == 2:
            if now - float(v[0]) <= window_s:
                out.append(float(v[1]))
        elif isinstance(v, (int, float)):
            out.append(float(v))
    return out
