"""Request-tracing drill on `--device`: the trace plane end to end (the
port's counterpart of scripts/trace_drill.py).

Drives a real serving fleet (`cli serve` workers on `--device`) and an
in-process server through three scenarios and writes one JSON record
(schema "trace_drill" v1):

  traced-fleet   a 2-replica fleet under HTTP load with every drill
                 request force-traced (X-Ytk-Trace): the client-side p99
                 request's exemplar must decompose into named hops
                 (front parse/queue/forward/wake/write + replica
                 parse/queue/assemble/execute/wake/write) summing to
                 within 10% of the exemplar's parse -> write latency (the
                 client's wall time also carries localhost socket and HTTP
                 framing outside the handler: p99_client_delta_ms), with
                 the replica hops clock-aligned inside the front.forward
                 window through the banner's wall_t0; the saved
                 /admin/traces snapshot must render as the port's
                 obs_report waterfall and merge into one Perfetto trace
  overhead       serve_bench's tracing-overhead arms (off / 1% sampled /
                 always on) through ServeApp: sampled must stay within
                 the BENCH_REGRESS_TOL band of off
  slo-burn       a sustained SLO violation (the SLO pinned below every
                 request's latency) must fire health.slo_burn, with the
                 event in the flight dump's ring and the dump's exemplars
                 rendering through obs_report

The record adds `device`, `card`, `floors` and `kernel_launches` (this
process's launches of each kernel wrapper) to the reference's; the
snapshot and the Perfetto merge land beside --record (in the temp dir
without one).

Usage:
    python -m ytklearn_tpu_torch.scripts.trace_drill [--record PATH]
        [--seconds 6] [--replicas 2] [--device cpu]

Env: SERVE_BENCH_TREES (default 120 here), BENCH_REGRESS_TOL.
"""

from __future__ import annotations

import argparse
import collections
import http.client
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time

os.environ.setdefault("SERVE_BENCH_TREES", "120")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from ytklearn_tpu_torch.scripts.serve_bench import (  # noqa: E402
    _build_model,
    _lat_stats,
    _write_serve_conf,
    floor,
    measure_tracing_overhead,
    resolve,
    stamp,
)

log = logging.getLogger("trace_drill")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def obs_report(*argv: str) -> subprocess.CompletedProcess:
    """The port's obs_report on an artifact, in a process of its own."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in [env.get("PYTHONPATH")] if p])
    return subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.scripts.obs_report",
         *argv], capture_output=True, text=True, timeout=120, cwd=REPO,
        env=env)


def _get(port, path, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _boot_traced_front(conf_path, replicas, slo_ms, device):
    """A real fleet whose front and workers run the trace plane armed
    (workers inherit the environment; the front is in-process)."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import trace as obs_trace
    from ytklearn_tpu_torch.serve import (BatchPolicy, FleetFront,
                                          serve_worker_argv)

    obs.configure(enabled=True)
    obs_trace.configure_tracing(sample=0.05, exemplars=8192, reset=True)
    flags = ["--watch-interval", "0", "--slo-ms", str(slo_ms),
             "--max-queue", "16384", "--max-batch", "512"]
    front = FleetFront(
        serve_worker_argv(conf_path, "gbdt", flags, device=str(device)),
        replicas,
        policy=BatchPolicy(max_batch=512, max_wait_ms=0.5, max_queue=16384),
        ready_timeout_s=600.0,
        slo_ms=slo_ms,
    )
    return front.start().serve_http()


def traced_fleet_step(args, tmp_dir, frags, record_dir, device) -> dict:
    """Scenario 1: force-traced HTTP load over a real fleet; decompose the
    client p99 request and check the waterfall pipeline."""
    from ytklearn_tpu_torch.obs.recorder import thread_guard

    # the workers inherit an armed trace plane and obs collection: env
    # writes for the spawned children (reads stay in config/knobs.py)
    os.environ["YTK_TRACE_SAMPLE"] = "0.05"
    os.environ["YTK_TRACE_EXEMPLARS"] = "8192"
    os.environ.setdefault("YTK_OBS", "1")
    conf_path = _write_serve_conf(tmp_dir,
                                  int(os.environ["SERVE_BENCH_TREES"]))
    front = _boot_traced_front(conf_path, args.replicas, 250.0, device)
    rows_per_body = 8
    bodies = []
    for i in range(0, max(len(frags) - rows_per_body, 1), rows_per_body):
        bodies.append(
            '{"rows":[' + ",".join(frags[i: i + rows_per_body]) + "]}"
        )
    client_lat = {}  # trace id -> client-measured ms
    lat_lock = threading.Lock()
    errors = []
    stop = [False]

    @thread_guard
    def worker(k):
        conn = http.client.HTTPConnection("127.0.0.1", front.port,
                                          timeout=120.0)
        i = k
        while not stop[0]:
            tid = f"drill-{k}-{i}"
            t0 = time.perf_counter()
            try:
                conn.request(
                    "POST", "/predict", bodies[i % len(bodies)].encode(),
                    {"Content-Type": "application/json",
                     "X-Ytk-Trace": tid},
                )
                r = conn.getresponse()
                r.read()
                ms = (time.perf_counter() - t0) * 1e3
                if r.status == 200:
                    with lat_lock:
                        client_lat[tid] = ms
                else:
                    errors.append(r.status)
            except OSError as e:
                errors.append(f"{type(e).__name__}")
                conn.close()
                conn = http.client.HTTPConnection(
                    "127.0.0.1", front.port, timeout=120.0)
            i += args.threads
        conn.close()

    out = {}
    try:
        threads = [threading.Thread(target=worker, args=(k,), daemon=True)
                   for k in range(args.threads)]
        for t in threads:
            t.start()
        time.sleep(args.seconds)
        stop[0] = True
        for t in threads:
            t.join(timeout=60.0)
        time.sleep(0.3)
        status, traces = _get(front.port, "/admin/traces")
        assert status == 200, f"/admin/traces HTTP {status}"
        snap_path = os.path.join(record_dir, "trace_drill_traces.json")
        with open(snap_path, "w") as f:
            json.dump(traces, f)

        # the client p99 request -> its exemplar, hop-decomposed; the hop
        # sum is held against the exemplar's latency (parse -> write,
        # everything the server can attribute)
        lats = sorted(client_lat.items(), key=lambda kv: kv[1])
        p99_tid, p99_ms = lats[int(0.99 * (len(lats) - 1))]
        front_ex = {
            r["trace_id"]: r for r in traces["front"]["exemplars"]
        }
        rec = front_ex.get(p99_tid)
        assert rec is not None, f"p99 trace {p99_tid} not in the front ring"
        hop_names = [h["name"] for h in rec["hops"]]
        hop_sum = sum(h["dur_ms"] for h in rec["hops"])
        share = hop_sum / rec["latency_ms"]
        # the replica's record of the same id, clock-aligned inside the
        # forward hop's window (banner wall_t0 handshake)
        fwd = next(h for h in rec["hops"] if h["name"] == "front.forward")
        f_w0 = traces["front"]["wall_t0"]
        fwd_start = f_w0 + fwd["ts"]
        fwd_end = fwd_start + fwd["dur_ms"] / 1e3
        nested = None
        for rid, rep in traces["replicas"].items():
            for rrec in rep.get("exemplars") or []:
                ids = [rrec.get("trace_id")] + list(
                    rrec.get("trace_ids") or [])
                if p99_tid in ids:
                    r_w0 = rep.get("wall_t0") or 0.0
                    starts = [r_w0 + h["ts"] for h in rrec["hops"]]
                    nested = {
                        "replica": rid,
                        "hops": [h["name"] for h in rrec["hops"]],
                        "inside_forward": bool(
                            starts
                            and min(starts) >= fwd_start - 0.05
                            and max(starts) <= fwd_end + 0.05
                        ),
                    }
                    break
            if nested:
                break
        p50, p99 = _lat_stats([v for _, v in lats])
        kept = collections.Counter(
            r.get("kept") for r in traces["front"]["exemplars"]
        )
        out = {
            "requests": len(client_lat),
            "errors": len(errors),
            "client_p50_ms": p50,
            "client_p99_ms": p99,
            "p99_trace_id": p99_tid,
            "p99_client_ms": round(p99_ms, 3),
            "p99_exemplar_ms": rec["latency_ms"],
            "p99_client_delta_ms": round(p99_ms - rec["latency_ms"], 3),
            "p99_hops": hop_names,
            "p99_hop_sum_ms": round(hop_sum, 3),
            "p99_hop_share": round(share, 4),
            "replica_side": nested,
            "front_exemplars": len(front_ex),
            "kept": dict(kept),
            "snapshot": os.path.basename(snap_path),
        }
        # the waterfall and the Perfetto merge must render from the
        # snapshot
        merged = os.path.join(record_dir, "trace_drill_merged.json")
        rep = obs_report(snap_path, "--perfetto", merged)
        out["obs_report_rc"] = rep.returncode
        out["waterfall_rendered"] = "p99 lives in" in rep.stdout
        with open(merged) as f:
            out["perfetto_events"] = len(json.load(f)["traceEvents"])
    finally:
        front.stop(drain=True, timeout=60.0)
    return out


def slo_burn_step(tmp_dir, trees, device) -> dict:
    """Scenario 3: a sustained SLO violation in-process: the burn sentinel
    must fire, and the evidence must survive into the flight dump and
    render through obs_report."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import recorder
    from ytklearn_tpu_torch.obs import trace as obs_trace
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    obs.configure(enabled=True)
    # the SLO pinned below any request's latency: every request burns
    # budget; the tail rule keeps them as tail_slo exemplars
    obs_trace.configure_tracing(sample=0.02, slo_ms=0.01, reset=True)
    recorder.install(flight_dir=tmp_dir)
    cfg = {"model": {"data_path": os.path.join(tmp_dir, "gbdt.model")},
           "optimization": {"loss_function": "sigmoid",
                            "round_num": trees}}
    reg = ModelRegistry(watch_interval_s=0, device=device)
    with compile_credit():
        reg.load("default", "gbdt", cfg)
    app = ServeApp(reg, BatchPolicy(max_batch=64, max_wait_ms=0.5),
                   slo_ms=0.01)
    rng = np.random.RandomState(3)
    out = {}
    try:
        for _ in range(600):
            app.predict([{f"c{j}": float(rng.randn())
                          for j in range(5)}], timeout=30.0)
        snap = obs.snapshot()["counters"]
        out["requests"] = 600
        out["slo_burn_fired"] = snap.get("health.slo_burn", 0.0)
        out["slo_burn_site"] = snap.get("health.slo_burn.serve.predict", 0.0)
        ring_names = [e.get("name") for e in (obs.REGISTRY.ring or [])]
        out["event_in_flight_ring"] = "health.slo_burn" in ring_names
        dump_path = recorder.dump(reason="trace_drill.slo_burn")
        out["flight_dump"] = os.path.basename(dump_path)
        with open(dump_path) as f:
            doc = json.load(f)
        fl = doc["flight"]
        out["event_in_dump"] = any(
            e.get("name") == "health.slo_burn" for e in fl.get("ring") or []
        )
        out["tail_exemplars_in_dump"] = sum(
            1 for r in fl.get("traces") or []
            if str(r.get("kept", "")).startswith("tail")
        )
        rep = obs_report(dump_path)
        out["obs_report_rc"] = rep.returncode
        out["slo_burn_in_report"] = "health.slo_burn" in rep.stdout
        out["waterfall_in_report"] = "request-trace waterfall" in rep.stdout
    finally:
        for b in app._batchers.values():
            b.close(drain=True)
        reg.close()
        recorder.uninstall()
        obs_trace.configure_tracing(slo_ms=0.0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--record", default="",
                    help="write the trace_drill record here; the snapshot "
                    "and the Perfetto merge land beside it")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--requests", type=int, default=2048)
    ap.add_argument("--device", default="cuda",
                    help="device of the in-process scorers and every "
                    "replica: cuda (the default; raises without a GPU) or "
                    "cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    from ytklearn_tpu_torch.config import knobs

    dev, card = resolve(args.device)
    if knobs.get_raw("YTK_OBS") != "0":
        from ytklearn_tpu_torch import obs

        obs.configure(enabled=True)

    tol = float(os.environ.get("BENCH_REGRESS_TOL", "0.15"))
    fails = []
    steps = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        pred, _names, gen_rows, source = _build_model(tmp_dir, dev)
        trees = len(pred.model.trees)
        rng = np.random.RandomState(7)
        rows = gen_rows(rng, args.requests)
        frags = [json.dumps(r) for r in rows]
        record_dir = (os.path.dirname(os.path.abspath(args.record))
                      if args.record else tmp_dir)

        log.info("== step 1: traced fleet (%d replicas on %s) ==",
                 args.replicas, dev)
        s1 = traced_fleet_step(args, tmp_dir, frags, record_dir, dev)
        steps["traced_fleet"] = s1
        if s1.get("errors"):
            fails.append(f"traced-fleet had {s1['errors']} request errors")
        if not (0.9 <= (s1.get("p99_hop_share") or 0.0) <= 1.1):
            fails.append(
                f"p99 hop sum {s1.get('p99_hop_sum_ms')} ms is "
                f"{100 * (s1.get('p99_hop_share') or 0):.1f}% of the "
                f"client-visible {s1.get('p99_exemplar_ms')} ms "
                "(must be within 10%)"
            )
        if not (s1.get("replica_side") or {}).get("inside_forward"):
            fails.append("replica-side hops not nested inside front.forward")
        if not s1.get("waterfall_rendered"):
            fails.append("obs_report did not render the waterfall")

        log.info("== step 2: tracing overhead arms ==")
        s2 = measure_tracing_overhead(
            tmp_dir, trees, rows, max(args.seconds / 2, 3.0), log,
            device=dev,
        )
        steps["overhead"] = s2
        floor_met = s2["sampled_req_per_sec"] >= s2["off_req_per_sec"] * (
            1 - tol)
        if not floor_met:
            fails.append(
                f"sampled tracing {s2['sampled_req_per_sec']:.0f} req/s "
                f"below the {tol:.0%} band of off "
                f"({s2['off_req_per_sec']:.0f})"
            )

        log.info("== step 3: SLO burn injection ==")
        s3 = slo_burn_step(tmp_dir, trees, dev)
        steps["slo_burn"] = s3
        if not s3.get("slo_burn_fired"):
            fails.append("health.slo_burn did not fire under sustained "
                         "violation")
        if not s3.get("event_in_dump"):
            fails.append("health.slo_burn event missing from the flight dump")
        if not (s3.get("slo_burn_in_report") and s3.get("obs_report_rc") == 0):
            fails.append("obs_report did not surface the slo_burn evidence")

    out = {
        "schema": "trace_drill",
        "schema_version": 1,
        "data_source": source,
        "trees": trees,
        "replicas": args.replicas,
        "steps": steps,
        "failures": fails,
        "ok": not fails,
    }
    stamp(out, dev, card, [floor(
        "BENCH_REGRESS_TOL tracing", s2.get("sampled_over_off"),
        round(1.0 - tol, 4), floor_met)])
    print(json.dumps(out), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)
    for msg in fails:
        log.error("FAIL: %s", msg)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
