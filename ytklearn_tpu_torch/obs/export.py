"""Exporters: JSONL event stream + Chrome-trace/Perfetto JSON (the JAX
package's ``obs/export.py``).

Chrome trace format (the JSON Object Format of the Trace Event spec —
what chrome://tracing and https://ui.perfetto.dev both load): spans are
complete "X" events with µs timestamps relative to the process clock
origin, counters become one "C" sample at the trace end, and "M" metadata
events name the process/threads.

JSONL: line 1 is a meta record carrying the schema version and the wall
origin; every following line is one event / counter / gauge record.
`load_jsonl` is the inverse (schema round-trip tested).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from .core import REGISTRY, WALL_T0, Registry

JSONL_SCHEMA_VERSION = 1


def _tid_map(events: List[dict]) -> Dict[int, int]:
    """Compress python thread idents into small stable tids (0 = first)."""
    out: Dict[int, int] = {}
    for ev in events:
        t = ev.get("tid", 0)
        if t not in out:
            out[t] = len(out)
    return out


def chrome_trace_events(registry: Registry = REGISTRY) -> List[dict]:
    with registry._lock:
        events = list(registry.events)
        counters = dict(registry.counters)
    pid = os.getpid()
    tids = _tid_map(events)
    out: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "tid": 0,
            "args": {"name": "ytklearn-tpu-torch"},
        }
    ]
    end_ts = 0.0
    for ev in events:
        ts_us = ev["ts"] * 1e6
        rec = {
            "name": ev["name"],
            "cat": ev["name"].split(".", 1)[0],
            "ph": ev["ph"],
            "ts": round(ts_us, 3),
            "pid": pid,
            "tid": tids.get(ev.get("tid", 0), 0),
        }
        if ev["ph"] == "X":
            rec["dur"] = round(ev.get("dur", 0.0) * 1e6, 3)
            end_ts = max(end_ts, ts_us + rec["dur"])
        else:
            if ev["ph"] == "i":
                rec["s"] = "t"  # thread-scoped instant
            end_ts = max(end_ts, ts_us)
        if ev.get("args"):
            rec["args"] = ev["args"]
        out.append(rec)
    for name, value in sorted(counters.items()):
        out.append(
            {
                "name": name,
                "cat": "counter",
                "ph": "C",
                "ts": round(end_ts, 3),
                "pid": pid,
                "tid": 0,
                "args": {"value": value},
            }
        )
    return out


def export_chrome_trace(path: str, registry: Registry = REGISTRY) -> str:
    """Write a Perfetto-loadable Chrome trace JSON; returns the path."""
    doc = {
        "traceEvents": chrome_trace_events(registry),
        "displayTimeUnit": "ms",
        "otherData": {"producer": "ytklearn_tpu_torch.obs", "wall_t0": WALL_T0},
    }
    from ..io.fs import LocalFileSystem  # lazy: fs pulls the retry seam, which imports obs

    with LocalFileSystem().atomic_open(path, "w") as f:
        json.dump(doc, f)
    return path


def exemplar_trace_events(
    payloads: List[dict], align_wall_t0: Optional[float] = None
) -> List[dict]:
    """Merge per-process /admin/traces payloads (obs/trace.py
    `exemplars_payload()`) into one clock-aligned Chrome-trace event list.

    Each payload carries its process's `wall_t0` (the obs clock origin on
    the wall clock); hop offsets become wall times and are re-anchored to
    the EARLIEST origin across payloads, so front and replica spans of
    one trace id line up on a single Perfetto timeline. Each process gets
    its own pid lane; every exemplar contributes one enclosing span plus
    its hops, all tagged with the trace id."""
    if align_wall_t0 is None:
        align_wall_t0 = min(
            (p.get("wall_t0") or 0.0 for p in payloads), default=0.0
        )
    out: List[dict] = []
    for p in payloads:
        pid = p.get("pid") or 0
        ident = p.get("identity") or {}
        label = ("replica %s" % ident["replica_id"]
                 if "replica_id" in ident else "front/solo")
        out.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": f"ytk-serve {label} (pid {pid})"},
        })
        base_us = ((p.get("wall_t0") or 0.0) - align_wall_t0) * 1e6
        for rec in p.get("exemplars") or []:
            ts_us = base_us + rec.get("ts", 0.0) * 1e6
            dur_us = rec.get("latency_ms", 0.0) * 1e3
            args = {"trace_id": rec.get("trace_id"),
                    "kept": rec.get("kept"),
                    "status": rec.get("status")}
            out.append({
                "name": f"trace.request[{rec.get('kept')}]",
                "cat": "trace", "ph": "X", "pid": pid, "tid": 0,
                "ts": round(ts_us, 3), "dur": round(dur_us, 3),
                "args": args,
            })
            for hop in rec.get("hops") or []:
                h_args = dict(hop.get("args") or {})
                h_args["trace_id"] = rec.get("trace_id")
                out.append({
                    "name": hop["name"], "cat": "trace.hop", "ph": "X",
                    "pid": pid, "tid": 1,
                    "ts": round(base_us + hop.get("ts", 0.0) * 1e6, 3),
                    "dur": round(hop.get("dur_ms", 0.0) * 1e3, 3),
                    "args": h_args,
                })
    return out


def export_jsonl(path: str, registry: Registry = REGISTRY) -> str:
    """Write the JSONL event stream; returns the path."""
    with registry._lock:
        events = list(registry.events)
        counters = dict(registry.counters)
        gauges = dict(registry.gauges)
    from ..io.fs import LocalFileSystem  # lazy: fs pulls the retry seam, which imports obs

    with LocalFileSystem().atomic_open(path, "w") as f:
        f.write(
            json.dumps(
                {
                    "type": "meta",
                    "schema_version": JSONL_SCHEMA_VERSION,
                    "wall_t0": WALL_T0,
                    "pid": os.getpid(),
                }
            )
            + "\n"
        )
        for ev in events:
            rec = {"type": "span" if ev["ph"] == "X" else "event"}
            rec.update(ev)
            f.write(json.dumps(rec) + "\n")
        for name, value in sorted(counters.items()):
            f.write(
                json.dumps({"type": "counter", "name": name, "value": value}) + "\n"
            )
        for name, value in sorted(gauges.items()):
            f.write(
                json.dumps({"type": "gauge", "name": name, "value": value}) + "\n"
            )
    return path


def load_jsonl(path: str) -> dict:
    """Parse a JSONL export back into {meta, events, counters, gauges}."""
    meta: dict = {}
    events: List[dict] = []
    counters: Dict[str, float] = {}
    gauges: Dict[str, float] = {}
    from ..io.fs import LocalFileSystem  # lazy: fs pulls the retry seam, which imports obs

    with LocalFileSystem().open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            t = rec.pop("type", None)
            if t == "meta":
                meta = rec
            elif t in ("span", "event"):
                events.append(rec)
            elif t == "counter":
                counters[rec["name"]] = rec["value"]
            elif t == "gauge":
                gauges[rec["name"]] = rec["value"]
    return {"meta": meta, "events": events, "counters": counters, "gauges": gauges}
