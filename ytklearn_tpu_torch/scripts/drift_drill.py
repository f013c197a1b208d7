"""Model-quality drift drill on `--device`: the quality plane end to end
(the port's counterpart of scripts/drift_drill.py).

Trains a real small GBDT on `--device` (so `<model>.sketch.json` comes from
the trainer's own dump path; bf16 histograms on the card, K1/K3/K5),
serves it on a live 2-replica fleet of `cli serve` workers, and writes one
JSON record (schema "drift_drill" v1):

  in-distribution   traffic drawn from the training distribution: every
                    sentinel stays quiet, each replica's PSI sits below
                    the drift threshold
  planted shift     a covariate-shifted stream (two features moved +4
                    sigma): `health.drift` fires on every replica, the
                    shifted features are named in `/metrics?quality=1`,
                    and the front's merged drift view agrees exactly with
                    a client-side merge of the replicas' GK summaries
  flight evidence   an in-process server under the same shift fires
                    `health.drift` with the event in the flight ring and
                    a dump the port's obs_report renders
  overhead          serve_bench's quality-overhead arms (off / default
                    sample rate / always on): the default rate must stay
                    within the BENCH_REGRESS_TOL band of off
  zero retraces     the quality plane is numpy-only off the device: the
                    replicas' `health.retrace` stays 0 throughout

The record adds `device`, `card`, `floors` and `kernel_launches` to the
reference's.

Usage:
    python -m ytklearn_tpu_torch.scripts.drift_drill [--record PATH]
        [--replicas 2] [--rounds 40] [--device cpu]
"""

from __future__ import annotations

import argparse
import http.client
import json
import logging
import math
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from ytklearn_tpu_torch.scripts.serve_bench import (  # noqa: E402
    floor,
    measure_quality_overhead,
    resolve,
    stamp,
)
from ytklearn_tpu_torch.scripts.trace_drill import obs_report  # noqa: E402

log = logging.getLogger("drift_drill")

N_FEATS = 6
W_TRUE = np.random.RandomState(19).randn(N_FEATS)


def _get(port, path, timeout=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read() or b"{}")
    finally:
        conn.close()


def _write_rows(path, n, seed):
    r = np.random.RandomState(seed)
    with open(path, "w") as f:
        for _ in range(n):
            x = r.randn(N_FEATS)
            s = float(x @ W_TRUE) + 0.8 * x[0] * x[1]
            y = int(r.rand() < 1.0 / (1.0 + math.exp(-s)))
            feats = ",".join(f"c{i}:{x[i]:.5f}" for i in range(N_FEATS))
            f.write(f"1###{y}###{feats}\n")


def train_model(tmp_dir: str, rounds: int, device="cuda") -> str:
    """A real trainer run on `device` -> gbdt.model and its
    .sketch.json/.bins.json sidecars (the train half of the story)."""
    from ytklearn_tpu_torch.config.params import GBDTParams
    from ytklearn_tpu_torch.gbdt.data import GBDTIngest
    from ytklearn_tpu_torch.gbdt.trainer import GBDTTrainer

    _write_rows(os.path.join(tmp_dir, "train.ytk"), 3000, 1)
    _write_rows(os.path.join(tmp_dir, "holdout.ytk"), 1000, 2)
    model_path = os.path.join(tmp_dir, "gbdt.model")
    cfg = {
        "data": {
            "train": {"data_path": os.path.join(tmp_dir, "train.ytk")},
            "test": {"data_path": os.path.join(tmp_dir, "holdout.ytk")},
            "max_feature_dim": N_FEATS,
        },
        "model": {"data_path": model_path},
        "loss": {"loss_function": "sigmoid"},
        "optimization": {"round_num": rounds, "max_depth": 4,
                         "learning_rate": 0.3},
    }
    p = GBDTParams.from_config(cfg)
    train, test = GBDTIngest(p).load()
    GBDTTrainer(p, device=device).train(train=train, test=test)
    side = model_path + ".sketch.json"
    if not os.path.exists(side):
        raise RuntimeError(f"trainer did not dump {side}")
    return model_path


def gen_rows(rng, n, shift=None):
    rows = []
    for _ in range(n):
        x = rng.randn(N_FEATS)
        if shift:
            for j, d in shift.items():
                x[j] += d
        rows.append({f"c{i}": float(x[i]) for i in range(N_FEATS)})
    return rows


def _drive(front, rng, n_rows, shift=None, per_request=8, threads=6):
    """Push n_rows through the front's client path from several
    concurrent clients: sequential requests would all land on one idle
    replica (least-queued balancing needs a backlog to spread), and the
    drill wants both replicas sketching."""
    import threading as _threading

    from ytklearn_tpu_torch.obs.recorder import thread_guard

    batches = [gen_rows(rng, per_request, shift=shift)
               for _ in range(0, n_rows, per_request)]
    done = [0] * threads
    errors = []

    @thread_guard
    def worker(k):
        for i in range(k, len(batches), threads):
            try:
                front.predict(batches[i], timeout=60.0)
                done[k] += len(batches[i])
            except Exception as e:  # noqa: BLE001 (the failure is the finding)
                errors.append(f"{type(e).__name__}: {e}")

    ts = [_threading.Thread(target=worker, args=(k,), daemon=True)
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300.0)
    if errors:
        raise RuntimeError(f"{len(errors)} drill request failures: "
                           f"{errors[:3]}")
    return sum(done)


def _replica_quality(front):
    """{rid: (quality payload, counters)} scraped from each ready replica."""
    out = {}
    for rid, h in sorted(front.handles.items()):
        if h.state != "ready":
            continue
        status, m = _get(h.port, "/metrics?quality=1", timeout=30.0)
        if status == 200:
            out[str(rid)] = (m.get("quality") or {}, m.get("counters") or {})
    return out


def fleet_step(args, tmp_dir, model_path, eval_s, device) -> dict:
    """The live 2-replica story: quiet in-distribution, loud under the
    planted shift, the fleet merge equal to the client-side merge."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import quality as obs_quality
    from ytklearn_tpu_torch.serve import (BatchPolicy, FleetFront,
                                          serve_worker_argv)

    obs.configure(enabled=True)
    conf_path = os.path.join(tmp_dir, "serve.conf")
    with open(conf_path, "w") as f:
        json.dump({
            "model": {"data_path": model_path},
            "optimization": {"loss_function": "sigmoid",
                             "round_num": args.rounds},
        }, f)
    flags = ["--watch-interval", "0", "--max-queue", "16384",
             "--max-batch", "512"]
    front = FleetFront(
        serve_worker_argv(conf_path, "gbdt", flags, device=str(device)),
        args.replicas,
        policy=BatchPolicy(max_batch=512, max_wait_ms=0.5, max_queue=16384),
        ready_timeout_s=600.0,
    ).start().serve_http()  # the fleet /metrics?quality=1 is the evidence
    rng = np.random.RandomState(7)
    out = {}
    try:
        # ---- phase 1: in-distribution (every sentinel quiet) ------------
        n1 = _drive(front, rng, args.rows)
        time.sleep(3 * eval_s)  # >= 2 evaluator ticks on every replica
        quiet = _replica_quality(front)
        out["in_distribution"] = {
            "requests_rows": n1,
            "replicas": {
                rid: {
                    "psi_max": _model_field(q, "psi_max"),
                    "rows_sampled": _model_field(q, "rows_sampled"),
                    "drift_fired": c.get("health.drift", 0.0),
                    "calibration_fired": c.get("health.calibration", 0.0),
                }
                for rid, (q, c) in quiet.items()
            },
        }
        # ---- phase 2: planted covariate shift ---------------------------
        shift = {0: 4.0, 1: 4.0}
        n2 = _drive(front, rng, args.rows, shift=shift)
        # the drift sentinel needs YTK_HEALTH_DRIFT_WINDOWS consecutive
        # over-threshold evaluator ticks: wait for several
        time.sleep(5 * eval_s)
        loud = _replica_quality(front)
        out["shifted"] = {
            "requests_rows": n2,
            "shift": {f"c{j}": d for j, d in shift.items()},
            "replicas": {
                rid: {
                    "psi_max": _model_field(q, "psi_max"),
                    "worst_features": _model_field(q, "worst_features"),
                    "feature_psi": _feature_psi(q),
                    "drift_fired": c.get("health.drift", 0.0),
                    "retraces": c.get("health.retrace", 0.0),
                }
                for rid, (q, c) in loud.items()
            },
        }
        # ---- fleet merge agreement --------------------------------------
        # with traffic stopped and an evaluator tick settled, the sketches
        # are static: the front's merged view and a client-side merge of
        # the same replica payloads must agree exactly
        time.sleep(2 * eval_s)
        settled = _replica_quality(front)
        status, fm = _get(front.port, "/metrics?quality=1", timeout=60.0)
        assert status == 200, f"front /metrics?quality=1 HTTP {status}"
        front_fleet = (fm.get("quality") or {}).get("fleet") or {}
        local_fleet = obs_quality.merge_quality_payloads(
            {rid: q for rid, (q, _c) in settled.items()}
        )["fleet"]
        agree = _fleet_agrees(front_fleet, local_fleet)
        out["fleet_merge"] = {
            "front_psi_max": _fleet_field(front_fleet, "psi_max"),
            "local_psi_max": _fleet_field(local_fleet, "psi_max"),
            "front_worst": _fleet_field(front_fleet, "worst_features"),
            "agrees": agree,
        }
    finally:
        front.stop(drain=True, timeout=60.0)
    return out


def _model_field(quality_payload, field):
    for m in (quality_payload.get("models") or {}).values():
        return m.get(field)
    return None


def _feature_psi(quality_payload):
    for m in (quality_payload.get("models") or {}).values():
        return {
            name: info.get("psi")
            for name, info in (m.get("features") or {}).items()
        }
    return {}


def _fleet_field(fleet, field):
    for m in fleet.values():
        return m.get(field)
    return None


def _fleet_agrees(a, b) -> bool:
    """Front-merged against client-merged fleet views: the same models,
    the same per-feature PSI/KS (both from the same serialized sketches
    through the same merge: exact equality is the mergeability pin)."""
    if set(a) != set(b):
        return False
    for key in a:
        fa = a[key].get("features") or {}
        fb = b[key].get("features") or {}
        if set(fa) != set(fb):
            return False
        for name in fa:
            if fa[name].get("psi") != fb[name].get("psi"):
                return False
            if fa[name].get("ks") != fb[name].get("ks"):
                return False
        if a[key].get("psi_max") != b[key].get("psi_max"):
            return False
    return True


def flight_step(tmp_dir, model_path, rounds, device) -> dict:
    """In-process server under the same shift: the health.drift event
    must land in the flight ring, survive into a dump, and render through
    obs_report."""
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.obs import quality as obs_quality
    from ytklearn_tpu_torch.obs import recorder
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp
    from ytklearn_tpu_torch.serve.scorer import compile_credit

    obs.configure(enabled=True)
    obs_quality.configure_quality(sample=1.0, seed=0, reset=True)
    recorder.install(flight_dir=tmp_dir)
    cfg = {"model": {"data_path": model_path},
           "optimization": {"loss_function": "sigmoid",
                            "round_num": rounds}}
    reg = ModelRegistry(watch_interval_s=0, device=device)
    with compile_credit():
        reg.load("default", "gbdt", cfg)
    app = ServeApp(reg, BatchPolicy(max_batch=64, max_wait_ms=0.5))
    rng = np.random.RandomState(3)
    out = {}
    try:
        for _ in range(40):
            app.predict(gen_rows(rng, 16, shift={0: 4.0, 1: 4.0}),
                        timeout=30.0)
        # two consecutive evaluator judgements (YTK_HEALTH_DRIFT_WINDOWS)
        app.quality.evaluate()
        app.quality.evaluate()
        snap = obs.snapshot()["counters"]
        out["drift_fired"] = snap.get("health.drift", 0.0)
        out["calibration_fired"] = snap.get("health.calibration", 0.0)
        ring_names = [e.get("name") for e in (obs.REGISTRY.ring or [])]
        out["event_in_flight_ring"] = "health.drift" in ring_names
        dump_path = recorder.dump(reason="drift_drill.shift")
        out["flight_dump"] = os.path.basename(dump_path)
        with open(dump_path) as f:
            doc = json.load(f)
        out["event_in_dump"] = any(
            e.get("name") == "health.drift"
            for e in doc["flight"].get("ring") or []
        )
        rep = obs_report(dump_path)
        out["obs_report_rc"] = rep.returncode
        out["drift_in_report"] = "health.drift" in rep.stdout
    finally:
        for b in app._batchers.values():
            b.close(drain=True)
        reg.close()
        recorder.uninstall()
        obs_quality.configure_quality(reset=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--record", default="",
                    help="write the drift_drill record here")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--rows", type=int, default=4096,
                    help="rows per traffic phase")
    ap.add_argument("--overhead-seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda",
                    help="device of the trainer, the in-process scorers and "
                    "every replica: cuda (the default; raises without a "
                    "GPU) or cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    dev, card = resolve(args.device)
    eval_s = 0.5
    # env writes, so the spawned replica workers inherit an armed quality
    # plane (every row sampled, fast evaluator ticks) and obs collection;
    # in-process reads all go through config/knobs.py
    os.environ["YTK_QUALITY_SAMPLE"] = "1.0"
    os.environ["YTK_QUALITY_EVAL_S"] = str(eval_s)
    os.environ.setdefault("YTK_OBS", "1")

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.config import knobs
    from ytklearn_tpu_torch.obs import quality as obs_quality

    if knobs.get_raw("YTK_OBS") != "0":
        obs.configure(enabled=True)
    obs_quality.configure_quality(sample=1.0, seed=0, reset=True)

    psi_threshold = knobs.get_float("YTK_HEALTH_DRIFT_PSI")
    tol = float(os.environ.get("BENCH_REGRESS_TOL", "0.15"))
    fails = []
    steps = {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        log.info("== training the baseline model (%d rounds on %s) ==",
                 args.rounds, dev)
        model_path = train_model(tmp_dir, args.rounds, dev)
        steps["train"] = {
            "rounds": args.rounds,
            "sidecar": os.path.basename(model_path) + ".sketch.json",
        }

        log.info("== step 1+2: live %d-replica fleet, in-distribution -> "
                 "planted shift ==", args.replicas)
        s1 = fleet_step(args, tmp_dir, model_path, eval_s, dev)
        steps.update(s1)
        for rid, rep in (s1["in_distribution"]["replicas"] or {}).items():
            if rep.get("drift_fired"):
                fails.append(
                    f"replica {rid}: health.drift fired on in-distribution "
                    f"traffic ({rep['drift_fired']:g}x)"
                )
            psi = rep.get("psi_max")
            if psi is not None and psi > psi_threshold:
                fails.append(
                    f"replica {rid}: in-distribution PSI {psi} above the "
                    f"{psi_threshold:g} threshold"
                )
        if not s1["shifted"]["replicas"]:
            fails.append("no replica quality payloads after the shift")
        for rid, rep in (s1["shifted"]["replicas"] or {}).items():
            if not rep.get("drift_fired"):
                fails.append(
                    f"replica {rid}: health.drift did not fire under the "
                    "planted covariate shift"
                )
            worst = rep.get("worst_features") or []
            if not set(worst) & {"c0", "c1"}:
                fails.append(
                    f"replica {rid}: shifted features not named (worst = "
                    f"{worst})"
                )
            fpsi = rep.get("feature_psi") or {}
            for name in ("c0", "c1"):
                if not (fpsi.get(name) or 0) > psi_threshold:
                    fails.append(
                        f"replica {rid}: feature {name} PSI "
                        f"{fpsi.get(name)} not above threshold in "
                        "/metrics?quality=1"
                    )
            if rep.get("retraces"):
                fails.append(
                    f"replica {rid}: {rep['retraces']:g} steady-state "
                    "retrace(s): the quality plane must stay off-device"
                )
        if not s1["fleet_merge"]["agrees"]:
            fails.append(
                "fleet front's merged drift view disagrees with the "
                "client-side merge of per-replica summaries"
            )

        log.info("== step 3: flight-ring evidence (in-process) ==")
        s3 = flight_step(tmp_dir, model_path, args.rounds, dev)
        steps["flight"] = s3
        if not s3.get("drift_fired"):
            fails.append("in-process health.drift did not fire")
        if not s3.get("event_in_dump"):
            fails.append("health.drift event missing from the flight dump")
        if not (s3.get("drift_in_report") and s3.get("obs_report_rc") == 0):
            fails.append("obs_report did not surface the drift evidence")

        log.info("== step 4: quality-sampler overhead arms ==")
        rng = np.random.RandomState(11)
        rows = gen_rows(rng, 2048)
        s4 = measure_quality_overhead(
            tmp_dir, _drill_predictor(model_path, args.rounds), args.rounds,
            rows, args.overhead_seconds, log, device=dev,
        )
        steps["overhead"] = s4
        floor_met = s4["sampled_req_per_sec"] >= s4["off_req_per_sec"] * (
            1 - tol)
        if not floor_met:
            fails.append(
                f"quality-sampler overhead {s4['sampled_req_per_sec']:.0f} "
                f"req/s below the {tol:.0%} band of off "
                f"({s4['off_req_per_sec']:.0f})"
            )

    out = {
        "schema": "drift_drill",
        "schema_version": 1,
        "replicas": args.replicas,
        "rounds": args.rounds,
        "psi_threshold": psi_threshold,
        "steps": steps,
        "failures": fails,
        "ok": not fails,
    }
    stamp(out, dev, card, [floor(
        "BENCH_REGRESS_TOL quality", s4.get("sampled_over_off"),
        round(1.0 - tol, 4), floor_met)])
    print(json.dumps(out), flush=True)
    if args.record:
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)
    for msg in fails:
        log.error("FAIL: %s", msg)
    return 1 if fails else 0


def _drill_predictor(model_path: str, rounds: int):
    from ytklearn_tpu_torch.predict import create_predictor

    return create_predictor("gbdt", {
        "model": {"data_path": model_path},
        "optimization": {"loss_function": "sigmoid", "round_num": rounds},
    })


if __name__ == "__main__":
    raise SystemExit(main())
