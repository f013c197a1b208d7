"""Render a run-health report from any obs artifact (the JAX package's
scripts/obs_report.py over the port's obs; the same text for the same
artifact).

Accepts every evidence shape the stack produces and prints one
human-readable postmortem: phases (top-level span wall time), health
sentinel hits, downgrades, memory watermarks, build/retrace telemetry,
and the collective census.

    python -m ytklearn_tpu_torch.scripts.obs_report flight_<ts>_<pid>_1.json
    python -m ytklearn_tpu_torch.scripts.obs_report /tmp/trace.json   # YTK_TRACE
    python -m ytklearn_tpu_torch.scripts.obs_report /tmp/events.jsonl # YTK_TRACE_JSONL
    python -m ytklearn_tpu_torch.scripts.obs_report BENCH_r05.json    # bench artifact
    python -m ytklearn_tpu_torch.scripts.obs_report prof.json         # prof_drill record
    python -m ytklearn_tpu_torch.scripts.obs_report traces.json       # /admin/traces
    python -m ytklearn_tpu_torch.scripts.obs_report traces.json --perfetto merged.json
    python -m ytklearn_tpu_torch.scripts.obs_report metrics.json      # /metrics?history=1

Input kind is sniffed, not flagged:
  flight dump   JSON object with a "flight" block (obs/recorder.py)
  chrome trace  JSON object with "traceEvents" only (obs/export.py)
  JSONL stream  first line is the {"type": "meta"} record
  bench JSON    has "metric"/"value" (optionally under the CI driver
                wrapper's "parsed")
  fleet metrics a FleetFront /metrics snapshot ("fleet" + "replicas"
                keys) — rendered as a per-replica fleet table
  serve metrics a replica/solo /metrics snapshot — history sparklines
                when saved with ?history=1
  trace rings   an /admin/traces snapshot (schema "ytk_traces", solo or
                fleet-aggregated) — rendered as a per-stage latency
                WATERFALL naming where the p99 lives, plus the p99
                exemplar's hop decomposition; `--perfetto OUT.json`
                additionally writes every ring merged into one
                clock-aligned Chrome trace (each process's wall_t0
                anchors its hop offsets — the spawn-banner handshake)
  mesh drill    a scripts/mesh_drill.py artifact (schema "ytkmesh_drill")
                — the per-model fleet table, top talkers, and the
                burn-isolation + conservation verdicts; any /metrics
                snapshot saved with ?models=1 (and flight dumps from
                serving processes) gets the same per-model section
  lint report   `ytklint --format json` / `check_lint.sh --json` output
                (schema "ytklint") — findings per rule plus the live
                reasoned-suppression inventory, so CI annotations and
                postmortems share one artifact

Fleet postmortems: any artifact whose counters/events carry
serve.worker.* / serve.front.* evidence gets a "serving fleet" section,
and events stamped with a replica identity (obs.set_identity) name the
replica inline. Flight dumps from traced serving processes carry their
exemplar ring (`flight.traces`) and get the waterfall section too.
"""

from __future__ import annotations

import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def _load(path: str) -> Tuple[str, dict]:
    """-> (kind, {"events": [raw obs events], "counters": {}, "gauges": {},
    "flight": {} | None, "bench": {} | None})"""
    with open(path) as f:
        first_line = f.readline()
        f.seek(0)
        try:
            head = json.loads(first_line)
        except json.JSONDecodeError:
            head = None  # pretty-printed JSON spans lines: full-load below
        if isinstance(head, dict) and head.get("type") == "meta":
            from ytklearn_tpu_torch.obs import load_jsonl

            back = load_jsonl(path)
            return "jsonl", {
                "events": back["events"],
                "counters": back["counters"],
                "gauges": back["gauges"],
                "flight": None,
                "bench": None,
            }
        # single-line artifacts (everything json.dump writes) already
        # parsed fully via the first line — don't parse the bytes twice
        doc = head if isinstance(head, dict) else json.load(f)
    if doc.get("schema") == "ytk_traces":
        return "traces", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "traces": doc,
        }
    if doc.get("schema") == "trace_drill":
        return "trace-drill", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "drill": doc,
        }
    if doc.get("schema") == "drift_drill":
        return "drift-drill", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "drift_drill": doc,
        }
    if doc.get("schema") == "ytkprof":
        # a raw profiler.report() saved to a file
        return "ytkprof", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "prof": doc,
        }
    if doc.get("schema") == "ytkprof_drill":
        return "ytkprof-drill", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "prof_drill": doc,
        }
    if doc.get("schema") == "ytkmesh_drill":
        return "mesh-drill", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "mesh_drill": doc,
        }
    if "flight" in doc:
        fl = doc["flight"]
        snap = fl.get("snapshot") or {}
        return "flight", {
            "events": fl.get("ring") or [],
            "counters": snap.get("counters") or {},
            "gauges": snap.get("gauges") or {},
            "flight": fl,
            "bench": None,
            "model_metrics": fl.get("model_metrics"),
        }
    if "traceEvents" in doc:
        events, counters = [], {}
        for ev in doc["traceEvents"]:
            if ev.get("ph") == "C":
                counters[ev["name"]] = ev.get("args", {}).get("value", 0.0)
            elif ev.get("ph") in ("X", "i"):
                # chrome ts/dur are µs; raw obs events are seconds
                events.append(
                    {
                        "name": ev["name"],
                        "ph": ev["ph"],
                        "ts": ev.get("ts", 0.0) / 1e6,
                        "dur": ev.get("dur", 0.0) / 1e6,
                        "depth": 0,
                        "args": ev.get("args", {}),
                    }
                )
        return "chrome-trace", {
            "events": events,
            "counters": counters,
            "gauges": {},
            "flight": None,
            "bench": None,
        }
    if doc.get("schema") == "ytklint":
        return "lint-report", {
            "events": [],
            "counters": {},
            "gauges": {},
            "flight": None,
            "bench": None,
            "lint": doc,
        }
    if "fleet" in doc and "replicas" in doc and "metric" not in doc:
        # a FleetFront /metrics snapshot saved to a file
        return "fleet-metrics", {
            "events": [],
            "counters": doc.get("counters") or {},
            "gauges": doc.get("gauges") or {},
            "flight": None,
            "bench": None,
            "fleet_metrics": doc,
            "history": doc.get("history"),
            "quality": doc.get("quality"),
            "prof": doc.get("prof"),
            "model_metrics": doc.get("model_metrics"),
        }
    if "latency" in doc and "counters" in doc and "metric" not in doc:
        # a replica/solo ServeApp /metrics snapshot (?history=1 carries
        # the per-metric time-series rings, ?quality=1 the drift block)
        return "serve-metrics", {
            "events": [],
            "counters": doc.get("counters") or {},
            "gauges": doc.get("gauges") or {},
            "flight": None,
            "bench": None,
            "history": doc.get("history"),
            "quality": doc.get("quality"),
            "prof": doc.get("prof"),
            "model_metrics": doc.get("model_metrics"),
        }
    rec = doc.get("parsed") if ("parsed" in doc and "cmd" in doc) else doc
    rec = rec or {}
    if "metric" in rec or "obs" in rec:
        obs_block = rec.get("obs") or {}
        return "bench", {
            "events": [],
            "counters": obs_block.get("counters") or {},
            "gauges": obs_block.get("gauges") or {},
            "flight": None,
            "bench": rec,
        }
    raise SystemExit(f"unrecognized artifact shape: {path}")


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}"
        n /= 1024
    return f"{n:.1f} TiB"


def _section(title: str) -> None:
    print(f"\n-- {title} " + "-" * max(0, 58 - len(title)))


def _phase_table(events: List[dict]) -> List[Tuple[str, float, int]]:
    """Aggregate complete spans by name at the outermost recorded depth."""
    spans = [e for e in events if e.get("ph") == "X"]
    if not spans:
        return []
    top = min(e.get("depth", 0) for e in spans)
    agg: Dict[str, List[float]] = defaultdict(list)
    for e in spans:
        if e.get("depth", 0) == top:
            agg[e["name"]].append(e.get("dur", 0.0))
    return sorted(
        ((n, sum(ds), len(ds)) for n, ds in agg.items()),
        key=lambda r: -r[1],
    )


def _prefixed(d: Dict[str, float], prefix: str) -> Dict[str, float]:
    return {k: v for k, v in d.items() if k.startswith(prefix)}


# ---------------------------------------------------------------------------
# Request-trace waterfall (/admin/traces snapshots, flight.traces rings)
# ---------------------------------------------------------------------------


def _pct(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    s = sorted(vals)
    return s[min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))]


def _trace_payloads(doc: dict) -> List[dict]:
    """Flatten a ytk_traces document (solo or fleet-aggregated) into the
    per-process payloads; index 0 is the client-facing process (front or
    solo server)."""
    if "exemplars" in doc:
        return [doc]
    out = []
    if isinstance(doc.get("front"), dict):
        out.append(doc["front"])
    for _rid, p in sorted((doc.get("replicas") or {}).items()):
        if isinstance(p, dict) and "exemplars" in p:
            out.append(p)
    return out


def render_traces(doc: dict) -> None:
    """Per-stage latency waterfall over every exemplar hop, naming where
    the p99 lives, plus the p99 exemplar's own hop decomposition (front
    and replica sides aligned via each process's wall_t0)."""
    payloads = _trace_payloads(doc)
    n_ex = sum(len(p.get("exemplars") or []) for p in payloads)
    _section("request-trace waterfall (exemplar rings)")
    if not n_ex:
        print("  no exemplars recorded (sampling off or no traffic)")
        return
    kept: Dict[str, int] = defaultdict(int)
    per_stage: Dict[str, List[float]] = defaultdict(list)
    for p in payloads:
        for rec in p.get("exemplars") or []:
            kept[str(rec.get("kept", "?"))] += 1
            for hop in rec.get("hops") or []:
                per_stage[hop["name"]].append(float(hop.get("dur_ms", 0.0)))
    print(f"  processes: {len(payloads)}  exemplars: {n_ex}  kept: "
          + " ".join(f"{k}={v}" for k, v in sorted(kept.items())))
    front = payloads[0]
    client = [r for r in front.get("exemplars") or []
              if r.get("latency_ms") is not None]
    lats = [float(r["latency_ms"]) for r in client]
    if lats:
        print(f"  client-visible exemplar latency: p50={_pct(lats, 50):.3f} "
              f"p99={_pct(lats, 99):.3f} max={max(lats):.3f} ms "
              f"(n={len(lats)})")
    if per_stage:
        print(f"  {'stage':<22s} {'count':>6s} {'mean ms':>9s} "
              f"{'p50 ms':>9s} {'p99 ms':>9s} {'total ms':>10s}")
        rows = sorted(per_stage.items(), key=lambda kv: -_pct(kv[1], 99))
        for name, durs in rows:
            print(f"  {name:<22s} {len(durs):>6d} "
                  f"{sum(durs) / len(durs):>9.3f} {_pct(durs, 50):>9.3f} "
                  f"{_pct(durs, 99):>9.3f} {sum(durs):>10.2f}")
        print(f"  p99 lives in: {rows[0][0]} "
              f"(stage p99 {_pct(rows[0][1], 99):.3f} ms)")
    if not client:
        return
    # the p99 exemplar, decomposed — front-side hops plus any replica
    # record carrying the same trace id, clock-aligned via wall_t0
    target = sorted(client, key=lambda r: float(r["latency_ms"]))[
        min(len(client) - 1, int(round(0.99 * (len(client) - 1))))
    ]
    tid = target.get("trace_id")
    t_wall0 = (front.get("wall_t0") or 0.0) + float(target.get("ts", 0.0))
    print(f"\n  p99 exemplar {tid} kept={target.get('kept')} "
          f"status={target.get('status')} "
          f"latency={target.get('latency_ms')} ms rows={target.get('rows')}")
    hop_sum = 0.0
    for hop in sorted(target.get("hops") or [], key=lambda h: h.get("ts", 0)):
        off = (front.get("wall_t0") or 0.0) + hop.get("ts", 0.0) - t_wall0
        hop_sum += float(hop.get("dur_ms", 0.0))
        print(f"    +{off * 1e3:8.3f} ms {hop['name']:<20s} "
              f"{hop.get('dur_ms', 0.0):9.3f} ms  {hop.get('args', '')}")
    for p in payloads[1:]:
        for rec in p.get("exemplars") or []:
            ids = [rec.get("trace_id")] + list(rec.get("trace_ids") or [])
            if tid not in ids:
                continue
            who = (rec.get("replica_id") if "replica_id" in rec
                   else (p.get("identity") or {}).get("replica_id"))
            print(f"    └ replica {who} (pid {p.get('pid')}):")
            for hop in sorted(rec.get("hops") or [],
                              key=lambda h: h.get("ts", 0)):
                off = ((p.get("wall_t0") or 0.0) + hop.get("ts", 0.0)
                       - t_wall0)
                print(f"      +{off * 1e3:8.3f} ms {hop['name']:<18s} "
                      f"{hop.get('dur_ms', 0.0):9.3f} ms  "
                      f"{hop.get('args', '')}")
    if target.get("latency_ms"):
        share = 100.0 * hop_sum / float(target["latency_ms"])
        print(f"  front-side hop sum {hop_sum:.3f} ms = {share:.1f}% of the "
              "client-visible latency")


def write_perfetto(doc: dict, out_path: str) -> str:
    """Merge every ring of a ytk_traces document into one clock-aligned
    Chrome-trace/Perfetto JSON (obs.export.exemplar_trace_events)."""
    from ytklearn_tpu_torch.obs import exemplar_trace_events

    events = exemplar_trace_events(_trace_payloads(doc))
    with open(out_path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"producer": "obs_report traces merge"}}, f)
    print(f"  merged Perfetto trace written to {out_path} "
          f"({len(events)} events)")
    return out_path


# ---------------------------------------------------------------------------
# Metrics-history sparklines (/metrics?history=1 snapshots)
# ---------------------------------------------------------------------------

_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(vals: List[float]) -> str:
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    if hi - lo < 1e-12:
        return _SPARK[0] * min(len(vals), 60)
    return "".join(
        _SPARK[int((v - lo) / (hi - lo) * (len(_SPARK) - 1))]
        for v in vals[-60:]
    )


def render_history(hist: Optional[dict]) -> None:
    series = (hist or {}).get("series") or {}
    if not series:
        return
    _section("metrics history (sparklines, oldest -> newest)")
    shown = 0
    for name, pts in sorted(series.items()):
        vals = [float(v) for _, v in pts]
        if len(vals) < 2:
            continue
        if max(vals) == min(vals) and not name.startswith("health."):
            continue  # flat non-health series are noise in a postmortem
        deltas = [b - a for a, b in zip(vals, vals[1:])]
        if len(vals) >= 3 and all(d >= 0 for d in deltas) and any(deltas):
            # monotone counter: the per-sample delta IS the rate shape
            line, tag = _sparkline(deltas), "Δ"
        else:
            line, tag = _sparkline(vals), " "
        print(f"  {name:<40s} {tag} {line} last={vals[-1]:g}")
        shown += 1
        if shown >= 40:
            print("  ... (more series elided)")
            break


# ---------------------------------------------------------------------------
# Model-quality drift section (/metrics?quality=1 blocks)
# ---------------------------------------------------------------------------


def _quality_models(q: dict) -> Dict[str, dict]:
    """Both shapes: a replica payload ({"models": ...}) and the fleet
    front's merged payload ({"fleet": ...})."""
    return dict(q.get("models") or q.get("fleet") or {})


def _score_deciles(sj: Optional[dict]) -> Optional[List[float]]:
    if not sj:
        return None
    from ytklearn_tpu_torch.obs.quality import summary_from_json

    s = summary_from_json(sj)
    if s.size == 0:
        return None
    return [round(float(v), 4) for v in s.query_values(10)]


def render_quality(q: Optional[dict]) -> None:
    """Drift/calibration section: per-feature PSI table (worst first),
    score-distribution comparison, and the missing-rate evidence — the
    `/metrics?quality=1` block rendered for a postmortem."""
    if not q:
        return
    models = _quality_models(q)
    if not models:
        return
    _section("model quality (drift & calibration)")
    if "sample" in q:
        print(f"  sample rate: {q.get('sample')}  seed: {q.get('seed')}")
    for key, m in sorted(models.items()):
        if m.get("no_baseline"):
            print(f"  {key}: NO BASELINE (quality.no_baseline) — "
                  f"rows seen {m.get('rows_seen')}")
            continue
        print(f"  {key}: psi_max={m.get('psi_max')} "
              f"ks_max={m.get('ks_max')} "
              f"rows sampled {m.get('rows_sampled')}"
              + (f" across {m['replicas']} replica(s)"
                 if m.get("replicas") else ""))
        worst = m.get("worst_features") or []
        if worst:
            print(f"  drifting most: {', '.join(worst)}")
        feats = m.get("features") or {}
        if feats:
            print(f"  {'feature':<20s} {'psi':>8s} {'ks':>8s} "
                  f"{'rows':>7s} {'missing':>8s}")
            rows = sorted(
                feats.items(), key=lambda kv: -(kv[1].get("psi") or 0.0)
            )
            for name, info in rows[:20]:
                print(f"  {name:<20s} {str(info.get('psi', '-')):>8s} "
                      f"{str(info.get('ks', '-')):>8s} "
                      f"{str(info.get('rows', '-')):>7s} "
                      f"{str(info.get('missing_rate', '-')):>8s}")
            if len(rows) > 20:
                print(f"  ... {len(rows) - 20} more feature(s)")
        score = m.get("score") or {}
        if score:
            print(f"  score: mean_pred={score.get('mean_pred')} vs "
                  f"baseline {score.get('baseline_mean')} "
                  f"(delta {score.get('calibration_delta')}, "
                  f"psi {score.get('psi')})")
        base_d = _score_deciles(m.get("baseline_score"))
        serve_d = _score_deciles(m.get("score_sketch"))
        if base_d and serve_d:
            print(f"  score deciles  base: {base_d}")
            print(f"               serve: {serve_d}")
    reps = q.get("replicas")
    if isinstance(reps, dict) and reps:
        for rid, per in sorted(reps.items()):
            for key, c in sorted(per.items()):
                print(f"  replica {rid} {key}: psi_max={c.get('psi_max')} "
                      f"rows={c.get('rows_sampled')}")


def render_prof(rep: dict) -> None:
    """Render a `ytkprof` report dict (obs/profiler.report()): the phase
    wall-time accountant, compile ledger, device kernel table, and
    phase-attributed memory watermarks."""
    phases = rep.get("phases") or {}
    if phases:
        _section("profiled phases (wall time)")
        for name, p in phases.items():
            pad = "  " * p.get("depth", 0)
            print(f"  {pad + name:<32s} {p.get('wall_s', 0):9.3f} s  "
                  f"x{p.get('count', 0)}")
        if rep.get("wall_s") is not None:
            print(f"  wall {rep['wall_s']:.3f}s  phase coverage "
                  f"{100.0 * (rep.get('phase_coverage') or 0):.1f}%")
    comp = rep.get("compile") or {}
    if comp.get("compiles"):
        _section("compile ledger")
        print(f"  compiles: {comp['compiles']}  total: "
              f"{comp.get('total_ms', 0):.1f} ms")
        for name, v in (comp.get("by_program") or {}).items():
            print(f"  {name:<32s} {v.get('compiles', 0):>3d} compile(s) "
                  f"{v.get('ms', 0):>9.1f} ms")
        # retraces carry the caught signature diff — the named culprit
        for e in comp.get("entries") or []:
            if e.get("changed"):
                print(f"  retrace {e.get('program')} ({e.get('ms', 0):.1f} "
                      f"ms): {'; '.join(e['changed'])}")
    kern = rep.get("kernels") or {}
    if kern.get("top_kernels"):
        _section("device time (trace captures)")
        print(f"  captures: {kern.get('parsed', 0)}/{kern.get('captures', 0)}"
              f" parsed  device total: {kern.get('device_total_ms', 0):.1f}"
              " ms")
        for name, ms in sorted(
            (kern.get("span_device_ms") or {}).items(), key=lambda kv: -kv[1]
        ):
            print(f"  span {name:<27s} {ms:>9.2f} ms")
        print(f"  {'top kernel':<32s} {'ms':>9s} {'calls':>7s} {'share':>7s}")
        for k in kern["top_kernels"]:
            print(f"  {k.get('name', '?')[:32]:<32s} {k.get('ms', 0):>9.2f} "
                  f"{k.get('count', 0):>7d} "
                  f"{100.0 * (k.get('share') or 0):>6.1f}%")
    peaks = (rep.get("mem") or {}).get("phase_peaks") or {}
    if peaks:
        _section("memory peaks by phase")
        for ph, v in peaks.items():
            bits = [
                f"{label} {_fmt_bytes(v[key])}"
                for key, label in (("device_peak_bytes", "device"),
                                   ("host_rss_peak_bytes", "rss"))
                if key in v
            ]
            print(f"  {ph:<32s} {'  '.join(bits)}")


def render_serve_prof(prof: dict) -> None:
    """Render the `prof` block of a /metrics?prof=1 snapshot: per-rung
    kernel-time attribution for each served model, plus the process's
    compile ledger."""
    _section("serve profiling (?prof=1)")
    print(f"  profiler enabled: {prof.get('enabled')}")
    for mname, snap in sorted((prof.get("models") or {}).items()):
        print(f"  model {mname}: mode={snap.get('mode')} "
              f"backend={snap.get('backend')} ladder={snap.get('ladder')}")
        rungs = snap.get("rungs") or {}
        if rungs:
            print(f"    {'rung':>6s} {'calls':>7s} {'rows':>9s} "
                  f"{'exec s':>9s} {'ms/row':>8s}")
            for rung, rs in sorted(rungs.items(),
                                   key=lambda kv: int(kv[0])):
                print(f"    {rung:>6s} {rs.get('calls', 0):>7d} "
                      f"{rs.get('rows', 0):>9d} {rs.get('exec_s', 0):>9.3f} "
                      f"{rs.get('ms_per_row', 0):>8.4f}")
    comp = prof.get("compile") or {}
    if comp.get("compiles"):
        print(f"  compiles: {comp['compiles']}  total: "
              f"{comp.get('total_ms', 0):.1f} ms")
        for name, v in (comp.get("by_program") or {}).items():
            print(f"    {name:<30s} {v.get('compiles', 0):>3d} compile(s) "
                  f"{v.get('ms', 0):>9.1f} ms")


def render_model_metrics(block: Optional[dict]) -> None:
    """Render a mesh-obs per-model block — either a replica/solo
    `model_metrics` snapshot (`/metrics?models=1`, flight dumps) or the
    fleet front's merged table (same key, with `replicas` sub-blocks and
    a `top_talkers` ranking)."""
    if not block or not block.get("models"):
        return
    _section("per-model accounting (mesh-obs)")
    if block.get("max_models") is not None:
        print(f"  family budget: {block['max_models']} "
              "(excess collapses into __overflow__)")
    hdr = (f"  {'model':<16s} {'reqs':>8s} {'rows':>9s} {'shed':>6s} "
           f"{'504':>5s} {'hit%':>6s} {'p50 ms':>8s} {'p99 ms':>8s} "
           f"{'fired':>6s}")
    print(hdr)
    for name, mb in sorted(block["models"].items()):
        c = mb.get("counters") or {}
        lat = mb.get("latency") or {}
        hit, miss = c.get("cache.hit", 0.0), c.get("cache.miss", 0.0)
        hit_pct = f"{100.0 * hit / (hit + miss):.1f}" if hit + miss else "-"
        slo = mb.get("slo") or {}
        print(
            f"  {name[:16]:<16s} {c.get('requests', 0):>8.0f} "
            f"{c.get('request_rows', 0):>9.0f} {c.get('shed', 0):>6.0f} "
            f"{c.get('deadline_expired', 0):>5.0f} {hit_pct:>6s} "
            f"{str(lat.get('p50_ms', '-')):>8s} "
            f"{str(lat.get('p99_ms', '-')):>8s} "
            f"{str(slo.get('windows_fired', '-')):>6s}"
        )
        for rid, rep in sorted((mb.get("replicas") or {}).items()):
            rl = rep.get("latency") or {}
            rs = rep.get("slo") or {}
            print(f"    replica {rid}: p50={rl.get('p50_ms')} "
                  f"p99={rl.get('p99_ms')} ms (n={rl.get('count')}) "
                  f"fired={rs.get('windows_fired', '-')}")
        nf = c.get("not_found")
        if nf:
            print(f"    not_found: {nf:g} (unknown-name requests)")
    talkers = block.get("top_talkers") or []
    if talkers:
        print("  top talkers (by served rows):")
        for t in talkers[:8]:
            print(f"    {t.get('model', '?')[:24]:<24s} "
                  f"{t.get('request_rows', 0):>9.0f} rows  "
                  f"{100.0 * (t.get('share') or 0):>5.1f}%")


def report(path: str, perfetto: Optional[str] = None) -> None:
    kind, data = _load(path)
    counters, gauges, events = data["counters"], data["gauges"], data["events"]
    print(f"== run-health report: {os.path.basename(path)} ({kind}) ==")

    tr = data.get("traces")
    if tr:
        render_traces(tr)
        if perfetto:
            write_perfetto(tr, perfetto)
        return  # a trace snapshot carries no other runtime sections

    drill = data.get("drill")
    if drill:
        _section("trace drill (scripts/trace_drill.py)")
        print(f"  ok: {drill.get('ok')}  model: {drill.get('data_source')} "
              f"x{drill.get('trees')} trees, {drill.get('replicas')} "
              "replicas")
        s1 = (drill.get("steps") or {}).get("traced_fleet") or {}
        if s1:
            print(f"  traced fleet: {s1.get('requests')} requests, "
                  f"p99 {s1.get('p99_exemplar_ms')} ms, hop sum "
                  f"{s1.get('p99_hop_sum_ms')} ms "
                  f"({100 * (s1.get('p99_hop_share') or 0):.1f}%)")
        s2 = (drill.get("steps") or {}).get("overhead") or {}
        if s2:
            print(f"  tracing overhead: off {s2.get('off_req_per_sec')} / "
                  f"sampled {s2.get('sampled_req_per_sec')} / always "
                  f"{s2.get('always_req_per_sec')} req/s")
        s3 = (drill.get("steps") or {}).get("slo_burn") or {}
        if s3:
            print(f"  slo burn: fired {s3.get('slo_burn_fired'):g}x, "
                  f"in dump: {s3.get('event_in_dump')}, tail exemplars: "
                  f"{s3.get('tail_exemplars_in_dump')}")
        for msg in drill.get("failures") or []:
            print(f"  FAIL: {msg}")
        if perfetto:
            print("note: --perfetto ignored — a trace_drill artifact is "
                  "a summary; merge the drill's saved "
                  "trace_drill_traces.json snapshot instead",
                  file=sys.stderr)
        return

    dd = data.get("drift_drill")
    if dd:
        _section("drift drill (scripts/drift_drill.py)")
        print(f"  ok: {dd.get('ok')}  {dd.get('replicas')} replicas, "
              f"{dd.get('rounds')} rounds, PSI threshold "
              f"{dd.get('psi_threshold')}")
        steps = dd.get("steps") or {}
        quiet = (steps.get("in_distribution") or {}).get("replicas") or {}
        for rid, rep in sorted(quiet.items()):
            print(f"  in-dist replica {rid}: psi_max={rep.get('psi_max')} "
                  f"drift_fired={rep.get('drift_fired'):g}")
        shifted = steps.get("shifted") or {}
        print(f"  planted shift: {shifted.get('shift')}")
        for rid, rep in sorted((shifted.get("replicas") or {}).items()):
            print(f"  shifted replica {rid}: psi_max={rep.get('psi_max')} "
                  f"worst={rep.get('worst_features')} "
                  f"drift_fired={rep.get('drift_fired'):g} "
                  f"retraces={rep.get('retraces'):g}")
        fmerge = steps.get("fleet_merge") or {}
        if fmerge:
            print(f"  fleet merge: front psi_max="
                  f"{fmerge.get('front_psi_max')} agrees="
                  f"{fmerge.get('agrees')}")
        flight = steps.get("flight") or {}
        if flight:
            print(f"  flight evidence: drift_fired="
                  f"{flight.get('drift_fired'):g} in_dump="
                  f"{flight.get('event_in_dump')}")
        overhead = steps.get("overhead") or {}
        if overhead:
            print(f"  quality overhead: off {overhead.get('off_req_per_sec')}"
                  f" / sampled {overhead.get('sampled_req_per_sec')} / "
                  f"always {overhead.get('always_req_per_sec')} req/s")
        for msg in dd.get("failures") or []:
            print(f"  FAIL: {msg}")
        return

    pd = data.get("prof_drill")
    if pd:
        _section("profiling drill (scripts/prof_drill.py)")
        shape = (pd.get("train") or {}).get("shape") or {}
        print(f"  ok: {pd.get('ok')}  metric: {pd.get('metric')} = "
              f"{pd.get('value')}")
        print(f"  train: {shape.get('rows')} rows x "
              f"{shape.get('features')} features, {shape.get('trees')} "
              f"trees  wall {pd.get('wall_s')}s")
        print(f"  steady-state retraces: {pd.get('retraces'):g}")
        srv = pd.get("serve") or {}
        if srv:
            print(f"  serve leg: {srv.get('requests')} requests over "
                  f"{len(srv.get('rungs') or {})} rung(s), prof block "
                  f"present: {srv.get('prof_block')}")
        for msg in pd.get("failures") or []:
            print(f"  FAIL: {msg}")
        if pd.get("prof"):
            render_prof(pd["prof"])
        return

    md = data.get("mesh_drill")
    if md:
        _section("mesh drill (scripts/mesh_drill.py)")
        print(f"  ok: {md.get('ok')}  {md.get('replicas')} replicas, "
              f"{len(md.get('models') or {})} models, "
              f"{md.get('requests')} requests")
        iso = md.get("burn_isolation") or {}
        print(f"  burn isolation: abusive {iso.get('abusive')!r} fired "
              f"{iso.get('abusive_fired')} window(s), quiet fired "
              f"{iso.get('quiet_fired')} (ok={iso.get('ok')})")
        cons = md.get("conservation") or {}
        print(f"  conservation: ok={cons.get('ok')} "
              f"(per-model sums == global twins on every replica)")
        ov = md.get("overhead") or {}
        if ov:
            print(f"  ?models=1 payload cost: {ov.get('models_ms')} ms vs "
                  f"{ov.get('plain_ms')} ms plain "
                  f"(x{ov.get('ratio')}, band x{ov.get('band')})")
        render_model_metrics({"models": md.get("models") or {},
                              "top_talkers": md.get("top_talkers")})
        for msg in md.get("failures") or []:
            print(f"  FAIL: {msg}")
        return

    prof_rep = data.get("prof")
    if kind == "ytkprof":
        render_prof(prof_rep or {})
        return

    fl = data["flight"]
    if fl:
        print(f"reason: {fl.get('reason')}   wall_time: {fl.get('wall_time')}")
        if fl.get("exception"):
            print(f"exception: {fl['exception']}")
        rt = fl.get("runtime") or {}
        if rt:
            print(
                f"runtime: python {rt.get('python')} jax {rt.get('jax')} "
                f"backend={rt.get('backend')} devices={rt.get('device_count')} "
                f"pid={rt.get('pid')}"
            )
        fp = fl.get("config_fingerprint") or {}
        if fp:
            print(f"config: {fp.get('type')} sha1={str(fp.get('sha1'))[:12]}")
        print(
            f"ring: {len(events)} events (capacity {fl.get('ring_capacity')})"
        )
        fprof = fl.get("prof")
        if fprof:
            # the flight-dump prof block is a compact ytkprof subset —
            # lift mem_phase_peaks back into report shape and reuse
            render_prof({
                "phases": fprof.get("phases"),
                "compile": fprof.get("compile"),
                "mem": {"phase_peaks": fprof.get("mem_phase_peaks")},
            })

    bench = data["bench"]
    if bench:
        print(
            f"metric: {bench.get('metric')} = {bench.get('value')} "
            f"{bench.get('unit', '')}"
        )
        for k in ("auc", "logloss", "trees", "data_source", "quality_band"):
            if k in bench:
                print(f"  {k}: {bench[k]}")
        if bench.get("schema") == "serve_scale":
            _section("autoscaler ramp (serve_bench --ramp)")
            print(f"  band: [{bench.get('replicas_min')}, "
                  f"{bench.get('replicas_max')}]  peak: "
                  f"{bench.get('peak_replicas')}  end: "
                  f"{bench.get('end_replicas')}  (peak at "
                  f"t={bench.get('t_peak_s')}s)")
            print(f"  requests: {bench.get('requests')}  failures: "
                  f"{bench.get('failures')}  sheds: {bench.get('shed_429')} "
                  f"in window {bench.get('shed_window_s')} "
                  f"(after peak: {bench.get('sheds_after_peak')})")
            print(f"  p99: {bench.get('p99_ms')} ms overall, "
                  f"{bench.get('p99_at_peak_ms')} ms at peak capacity")
            for k, v in sorted((bench.get("scale_counters") or {}).items()):
                print(f"  {k:<28s} {v:g}")
            # the replica-count ring IS the ramp shape
            hist = bench.get("history_replicas") or []
            if hist:
                print("  serve.fleet.replicas  "
                      + _sparkline([float(v) for _t, v in hist])
                      + f" last={hist[-1][1]:g}")
            for ev in (bench.get("scale_events") or [])[:16]:
                args_ = ev.get("args") or {}
                detail = " ".join(
                    f"{k}={args_[k]}"
                    for k in ("replica_id", "backlog_rows", "ready", "slots",
                              "shed", "p99_ms", "streak", "want")
                    if k in args_
                )
                print(f"  event {ev.get('name')} @ {ev.get('ts', 0):.3f}s "
                      f"{detail}")
        if bench.get("schema") == "serve_fleet":
            _section("fleet scaling (sustained req/s at p99)")
            print(f"  {'replicas':>8s} {'req/s':>10s} {'p50 ms':>9s} "
                  f"{'p99 ms':>9s} {'retraces':>9s}")
            for row in bench.get("scaling") or []:
                print(
                    f"  {row.get('replicas', '?'):>8} "
                    f"{row.get('req_per_sec', 0):>10.1f} "
                    f"{row.get('p50_ms', 0):>9.2f} "
                    f"{row.get('p99_ms', 0):>9.2f} "
                    f"{row.get('retraces', 0):>9.0f}"
                )
            hot = bench.get("hot_cache")
            if hot:
                print(
                    f"  hot-cache: {hot.get('req_per_sec', 0):.1f} req/s "
                    f"p99={hot.get('p99_ms', 0):.2f} ms "
                    f"hit_rate={hot.get('hit_rate', 0):.3f}"
                )
            mixed = bench.get("mixed_traffic")
            if mixed:
                print(
                    f"  mixed: requests={mixed.get('requests')} "
                    f"shed={mixed.get('shed_429')} "
                    f"failures={mixed.get('failures')} "
                    f"versions={mixed.get('versions_seen')} "
                    f"reloads={mixed.get('reloads_fleet')}"
                )

    lint = data.get("lint")
    if lint:
        findings = lint.get("findings") or []
        suppressed = lint.get("suppressed") or []
        _section("static analysis (ytklint)")
        print(f"  rules: {len(lint.get('rules') or [])}  "
              f"files: {lint.get('files')}  findings: {len(findings)}  "
              f"reasoned suppressions: {len(suppressed)}")
        per_rule: Dict[str, int] = defaultdict(int)
        for f_ in findings:
            per_rule[f_.get("rule", "?")] += 1
        for rule_name, n in sorted(per_rule.items(), key=lambda kv: -kv[1]):
            print(f"  {rule_name:<28s} {n}")
        for f_ in findings[:20]:
            print(f"  {f_.get('path')}:{f_.get('line')}: "
                  f"[{f_.get('rule')}] {f_.get('message', '')[:90]}")
        if len(findings) > 20:
            print(f"  ... {len(findings) - 20} more finding(s)")
        if suppressed:
            _section("suppression inventory (each verified live by the "
                     "unused-suppression audit)")
            for s in suppressed:
                print(f"  {s.get('path')}:{s.get('line')}: "
                      f"[{s.get('rule')}] reason={s.get('reason', '')[:80]}")
        return  # a lint artifact carries no runtime evidence sections

    fm = data.get("fleet_metrics")
    if fm:
        fl = fm.get("fleet") or {}
        _section("serving fleet")
        print(f"  replicas: {fl.get('replicas')} ready: {fl.get('ready')} "
              f"restarts: {fl.get('restarts')}")
        a = fm.get("autoscale") or {}
        if a.get("enabled"):
            last = a.get("last_decision") or {}
            print(f"  autoscale: band [{a.get('min')}, {a.get('max')}] "
                  f"interval={a.get('interval_s')}s "
                  f"streaks up={a.get('up_streak')}/{a.get('up_windows')} "
                  f"down={a.get('down_streak')}/{a.get('down_windows')} "
                  f"cooldowns up={a.get('up_cooldown_remaining_s')}s "
                  f"down={a.get('down_cooldown_remaining_s')}s")
            if last:
                print(f"  last decision: {last.get('action')} "
                      f"(backlog={last.get('backlog_rows')} "
                      f"shed={last.get('shed')} p99={last.get('p99_ms')}ms "
                      f"ready={last.get('ready')})")
        elif a:
            print(f"  autoscale: off (fixed fleet of {a.get('min')})")
        front_lat = fm.get("latency") or {}
        fleet_lat = fm.get("fleet_latency") or {}
        if front_lat.get("count"):
            print(f"  front latency:  p50={front_lat.get('p50_ms')} "
                  f"p99={front_lat.get('p99_ms')} ms "
                  f"(n={front_lat.get('count')})")
        if fleet_lat.get("count"):
            print(f"  fleet latency (ring union): "
                  f"p50={fleet_lat.get('p50_ms')} "
                  f"p99={fleet_lat.get('p99_ms')} ms "
                  f"(n={fleet_lat.get('count')})")
        print(f"  {'id':>4s} {'pid':>8s} {'state':>9s} {'restarts':>8s} "
              f"{'queued':>7s} {'p99 ms':>8s} {'requests':>9s} "
              f"{'retrace':>8s}")
        for rid, info in sorted(
            fm.get("replicas", {}).items(),
            key=lambda kv: (int(kv[0]) if kv[0].isdigit() else 1 << 30,
                            kv[0]),
        ):
            lat = info.get("latency") or {}
            counters = info.get("counters") or {}
            print(
                f"  {rid:>4s} {str(info.get('pid')):>8s} "
                f"{str(info.get('state')):>9s} "
                f"{info.get('restarts', 0):>8} "
                f"{info.get('queued_rows', 0):>7} "
                f"{str(lat.get('p99_ms', '-')):>8s} "
                f"{counters.get('serve.requests', 0):>9.0f} "
                f"{counters.get('health.retrace', 0):>8.0f}"
            )

    phases = _phase_table(events)
    if phases or _prefixed(gauges, "gbdt.stat."):
        _section("phases")
        for name, total, cnt in phases[:12]:
            print(f"  {name:<28s} {total:10.3f} s  x{cnt}")
        stat = _prefixed(gauges, "gbdt.stat.")
        for k in ("load", "preprocess", "train", "finalize"):
            v = stat.get(f"gbdt.stat.{k}")
            if v is not None:
                print(f"  gbdt.stat.{k:<18s} {v:10.3f} s")

    health_c = _prefixed(counters, "health.")
    health_ev = [e for e in events if e.get("name", "").startswith("health.")]
    _section("health")
    if not health_c and not health_ev:
        print("  clean: no sentinel hits recorded")
    for k, v in sorted(health_c.items()):
        print(f"  {k:<40s} {v:g}")
    for e in health_ev[-10:]:
        print(f"  event {e['name']} @ {e.get('ts', 0):.3f}s {e.get('args', {})}")

    downs = {
        k: v
        for k, v in counters.items()
        if k.startswith(("gbdt.downgrade.", "gbdt.efb.downgrade"))
    }
    if downs:
        _section("downgrades")
        for k, v in sorted(downs.items()):
            print(f"  {k:<40s} {v:g}")

    cont_c = _prefixed(counters, "continual.")
    cont_ev = [
        e for e in events
        if e.get("name") in ("continual.promoted", "continual.rejected",
                             "continual.rollback")
    ]
    if cont_c or cont_ev:
        _section("continual training (promotions / rejections)")
        for k in ("continual.retrains", "continual.promoted",
                  "continual.rejected", "continual.rollbacks"):
            if k in cont_c:
                print(f"  {k:<40s} {cont_c[k]:g}")
        for k, v in sorted(cont_c.items()):
            if k.startswith("continual.ftrl"):
                print(f"  {k:<40s} {v:g}")
        # the promotion/rejection/rollback event trail, newest last: each
        # names the version, losses, and (for rejects) every failed gate
        for e in cont_ev[-10:]:
            args = e.get("args", {})
            detail = " ".join(
                f"{k}={args[k]}"
                for k in ("version", "from_version", "to_version", "model",
                          "candidate_loss", "incumbent_loss", "reasons")
                if k in args
            )
            print(f"  event {e['name']} @ {e.get('ts', 0):.3f}s {detail}")

    fleet_c = {
        k: v for k, v in counters.items()
        if k.startswith(("serve.worker", "serve.front", "serve.fleet",
                         "serve.aimd", "serve.cache"))
    }
    fleet_ev = [
        e for e in events
        if str(e.get("name", "")).startswith(("serve.worker", "serve.front",
                                              "serve.fleet", "serve.aimd"))
    ]
    if fleet_c or fleet_ev:
        _section("serving fleet (replica lifecycle / AIMD / cache)")
        for k, v in sorted(fleet_c.items()):
            print(f"  {k:<40s} {v:g}")
        # the lifecycle trail, newest last — each event names its replica
        for e in fleet_ev[-12:]:
            args = e.get("args", {})
            detail = " ".join(
                f"{k}={args[k]}"
                for k in ("replica_id", "from_replica", "to_replica", "pid",
                          "port", "restarts", "rc", "rows", "from_batch",
                          "to_batch", "worst_ms", "cause", "error")
                if k in args
            )
            print(f"  event {e['name']} @ {e.get('ts', 0):.3f}s {detail}")

    if fl and fl.get("traces"):
        # a traced serving process's flight dump carries its exemplar
        # ring: render the same waterfall a live /admin/traces would get
        flight_rings = {
            "exemplars": fl["traces"],
            "wall_t0": fl.get("wall_t0"),
            "pid": (fl.get("runtime") or {}).get("pid"),
            "identity": (fl.get("runtime") or {}).get("identity") or {},
        }
        render_traces(flight_rings)
        if perfetto:
            write_perfetto(flight_rings, perfetto)
            perfetto = None  # consumed
    if perfetto:
        # every other artifact kind carries no exemplar rings to merge —
        # say so instead of leaving the operator with a missing file
        print("note: --perfetto ignored — this artifact carries no "
              "exemplar rings (use an /admin/traces snapshot or a "
              "traced flight dump)", file=sys.stderr)

    if prof_rep and kind in ("serve-metrics", "fleet-metrics"):
        render_serve_prof(prof_rep)

    render_model_metrics(data.get("model_metrics"))
    render_quality(data.get("quality"))
    render_history(data.get("history"))

    mem = _prefixed(gauges, "mem.")
    if mem:
        _section("memory watermarks")
        for k, v in sorted(mem.items()):
            print(f"  {k:<40s} {_fmt_bytes(v)}")

    comp = {
        k: v
        for k, v in counters.items()
        if k.startswith("compile.")
    }
    if comp:
        _section("compile telemetry")
        for k, v in sorted(comp.items()):
            unit = " s" if k.endswith("_secs") else ""
            print(f"  {k:<40s} {v:g}{unit}")

    coll: Dict[str, Dict[str, float]] = defaultdict(dict)
    for k, v in counters.items():
        if k.startswith("collectives."):
            _, verb, what = k.split(".", 2)
            coll[verb][what] = v
    if coll:
        _section("collective census (trace-time)")
        for verb, d in sorted(coll.items()):
            print(
                f"  {verb:<16s} calls={d.get('calls', 0):g} "
                f"bytes={_fmt_bytes(d.get('bytes', 0.0))}"
            )

    ingest = {
        k: v
        for k, v in counters.items()
        if k.startswith(("ingest.", "lbfgs.", "gbdt.rounds", "gbdt.trees"))
    }
    if ingest:
        _section("progress counters")
        for k, v in sorted(ingest.items()):
            print(f"  {k:<40s} {v:g}")


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    perfetto = None
    if "--perfetto" in argv:
        i = argv.index("--perfetto")
        if i + 1 >= len(argv):
            print("--perfetto needs an output path", file=sys.stderr)
            return 2
        perfetto = argv[i + 1]
        del argv[i:i + 2]
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    if perfetto and len(argv) > 1:
        # each input would overwrite the same merged output silently; a
        # fleet-aggregated /admin/traces snapshot is already ONE file
        print("--perfetto takes exactly one input artifact",
              file=sys.stderr)
        return 2
    for path in argv:
        report(path, perfetto=perfetto)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
