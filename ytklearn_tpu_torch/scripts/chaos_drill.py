#!/usr/bin/env python
"""Chaos drill: prove the port's resilience layer and serving fleet end to
end, and write one JSON record (the JAX package's scripts/chaos_drill.py,
driving the port's CLI on `--device`).

The drill exercises the whole preemption/retry contract on a synthetic
GBDT workload (deterministic; no reference data needed):

  baseline   uninterrupted train -> model hash (the bit-identity oracle)
  sigterm    YTK_CHAOS=gbdt.sync:sigterm:1:0 -> the preemption guard
             dumps an emergency checkpoint at the round boundary, exits
             143, and the flight dump carries the chaos.inject +
             preempt.checkpoint events and the chaos.injected counter
  resume     `--resume auto` -> completes; final dump BIT-IDENTICAL to
             baseline (round-indexed RNG + exact score replay)
  kill9      YTK_CHAOS=gbdt.sync:kill:1:0 (os._exit(137), no handlers —
             the kill -9 stand-in) with dump_freq=1 -> resume is again
             bit-identical off the periodic checkpoint alone
  transient  YTK_CHAOS=io.read:oserror:<rate>:<seed> at the default
             retry budget -> ZERO run failures, io.retry.* counters and
             chaos.inject events present (in-process, registry-checked)
  serve      registry hot reload under serve.load oserror chaos ->
             reload succeeds after retries, old model never dropped
  fleet      kill -9 one replica of a live 2-replica serving fleet mid-
             load: every in-flight request completes (front reroutes to
             the sibling — zero client-visible failures), the slot
             restarts, and the flight dump carries the
             serve.worker.{died,restarted} evidence naming the replica
  autoscale  kill -9 a replica MID-RAMP: an autoscaling fleet (band
             1..3, p99-over-SLO up signal) is driven into a scale-up,
             then a ready replica is killed while the ramp is live. The
             MONITOR must heal the slot (serve.worker.restarted) while
             the autoscaler DEFERS its decisions (serve.scale.deferred —
             respawn is capacity arriving, not a scale-up trigger), the
             slot count must never exceed --replicas-max (no
             double-spawn), and zero in-flight requests may fail

Every trainer and every fleet replica runs on `--device` (default cuda;
`--device cpu` runs the plain versions). On the card `cli train gbdt`
takes bf16 histograms, whose float atomics may part a leaf at a near-tie
between runs (ROADMAP.md 1.14): the resume arms then report it.

Usage:
    python -m ytklearn_tpu_torch.scripts.chaos_drill --out DRILL.json \
        [--device cpu] [--keep]

Exits non-zero when any step fails; the record is written either way
(a failing drill should leave evidence, not vanish).
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SCHEMA_VERSION = 1


def _write_rows(path: str, n: int, seed: int) -> None:
    import numpy as np

    r = np.random.RandomState(seed)
    w = np.random.RandomState(7).randn(8)
    with open(path, "w") as f:
        for _ in range(n):
            x = r.randn(8)
            s = x @ w + 1.5 * x[0] * x[1] - abs(x[2])
            y = int(r.rand() < 1.0 / (1.0 + math.exp(-s)))
            f.write(
                "1###%d###%s\n"
                % (y, ",".join(f"c{i}:{x[i]:.5f}" for i in range(8)))
            )


def _conf(work: str, model: str, dump_freq: int) -> str:
    path = os.path.join(work, f"{model}.conf")
    with open(path, "w") as f:
        f.write(
            f'data {{ train {{ data_path = "{work}/drill.train" }} '
            "max_feature_dim = 8 }\n"
            f'model {{ data_path = "{work}/{model}" '
            f"dump_freq = {dump_freq} }}\n"
            'loss { loss_function = "sigmoid" }\n'
            "optimization { round_num = 6, max_depth = 3, "
            "learning_rate = 0.3 }\n"
        )
    return path


def _run_cli(args, extra_env=None, work="."):
    env = dict(os.environ)
    env.update({
        "PYTHONPATH": REPO + os.pathsep + env.get("PYTHONPATH", ""),
        "YTK_OBS": "1",
        "YTK_FLIGHT_DIR": os.path.join(work, "flight"),
    })
    env.update(extra_env or {})
    t0 = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "ytklearn_tpu_torch.cli"] + args,
        capture_output=True, text=True, env=env, cwd=REPO, timeout=1200,
    )
    return {
        "argv": args,
        "rc": proc.returncode,
        "wall_s": round(time.time() - t0, 1),
        "stderr_tail": proc.stderr[-2000:],
    }


def _sha(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _newest_flight(work: str):
    hits = sorted(glob.glob(os.path.join(work, "flight", "flight_*.json")))
    if not hits:
        return None
    with open(hits[-1]) as f:
        return json.load(f)


def _flight_evidence(doc) -> dict:
    """Event names in the ring + the chaos/preempt counters of a dump."""
    if doc is None:
        return {"found": False}
    flight = doc.get("flight") or {}
    names = sorted({e.get("name", "") for e in flight.get("ring", [])})
    counters = (flight.get("snapshot") or {}).get("counters", {})
    return {
        "found": True,
        "reason": flight.get("reason"),
        "ring_events": [n for n in names if n.startswith(("chaos.", "preempt.", "io.retry"))],
        "chaos_injected": counters.get("chaos.injected", 0.0),
        "preempt_exits": counters.get("preempt.exits", 0.0),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True,
                    help="path of the JSON record to write")
    ap.add_argument("--device", default="cuda",
                    help="device of every trainer and replica: cuda "
                    "(default) or cpu")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch dir for inspection")
    args = ap.parse_args()

    work = tempfile.mkdtemp(prefix="chaos_drill_")
    _write_rows(os.path.join(work, "drill.train"), 400, 11)
    record = {
        "schema_version": SCHEMA_VERSION,
        "kind": "chaos_drill",
        "device": args.device,
        "created_at": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "steps": {},
        "passed": True,
    }
    problems = []

    def check(cond: bool, msg: str) -> None:
        if not cond:
            problems.append(msg)
            record["passed"] = False
            print(f"FAIL: {msg}", file=sys.stderr)

    # 1. baseline ---------------------------------------------------------
    dev = ["--device", args.device]
    step = _run_cli(["train", "gbdt", _conf(work, "base", 2)] + dev,
                    work=work)
    check(step["rc"] == 0, f"baseline train rc={step['rc']}")
    base_sha = _sha(os.path.join(work, "base")) if step["rc"] == 0 else ""
    step["model_sha256"] = base_sha
    record["steps"]["baseline"] = step

    # 2. sigterm preemption ----------------------------------------------
    step = _run_cli(
        ["train", "gbdt", _conf(work, "pre", 2)] + dev,
        extra_env={"YTK_CHAOS": "gbdt.sync:sigterm:1:0"}, work=work,
    )
    check(step["rc"] == 143, f"sigterm run rc={step['rc']} (want 143)")
    check(os.path.exists(os.path.join(work, "pre")),
          "no emergency checkpoint after sigterm")
    ev = _flight_evidence(_newest_flight(work))
    step["flight"] = ev
    check(ev.get("found"), "no flight dump after preemption")
    check(ev.get("chaos_injected", 0) >= 1,
          "flight dump missing chaos.injected counter")
    check("chaos.inject" in ev.get("ring_events", []),
          "flight ring missing chaos.inject event")
    check("preempt.checkpoint" in ev.get("ring_events", []),
          "flight ring missing preempt.checkpoint event")
    record["steps"]["sigterm"] = step

    # 3. resume -> bit identity ------------------------------------------
    step = _run_cli(
        ["train", "gbdt", _conf(work, "pre", 2), "--resume", "auto"] + dev,
        work=work,
    )
    check(step["rc"] == 0, f"resume rc={step['rc']}")
    sha = _sha(os.path.join(work, "pre")) if step["rc"] == 0 else ""
    step["model_sha256"] = sha
    step["bit_identical"] = bool(base_sha) and sha == base_sha
    check(step["bit_identical"], "resumed model is not bit-identical")
    record["steps"]["resume"] = step

    # 4. kill -9 stand-in + resume off dump_freq checkpoints --------------
    step = _run_cli(
        ["train", "gbdt", _conf(work, "k9", 1)] + dev,
        extra_env={"YTK_CHAOS": "gbdt.sync:kill:1:0"}, work=work,
    )
    check(step["rc"] == 137, f"kill9 run rc={step['rc']} (want 137)")
    record["steps"]["kill9"] = step
    step = _run_cli(
        ["train", "gbdt", _conf(work, "k9", 1), "--resume", "auto"] + dev,
        work=work,
    )
    check(step["rc"] == 0, f"kill9 resume rc={step['rc']}")
    sha = _sha(os.path.join(work, "k9")) if step["rc"] == 0 else ""
    step["model_sha256"] = sha
    step["bit_identical"] = bool(base_sha) and sha == base_sha
    check(step["bit_identical"], "kill9-resumed model is not bit-identical")
    record["steps"]["kill9_resume"] = step

    # 5. transient IO faults at the default retry budget (in-process, so
    #    the drill can read the registry for counter/event evidence) ------
    sys.path.insert(0, REPO)
    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch import resilience
    from ytklearn_tpu_torch.cli import train_main

    obs.configure(enabled=True)
    resilience.reset_chaos()
    os.environ["YTK_CHAOS"] = "io.read:oserror:0.5:3"
    try:
        rc = train_main(["gbdt", _conf(work, "tio", 2)] + dev)
    finally:
        os.environ["YTK_CHAOS"] = ""  # empty = disarmed (get_str treats as unset)
        resilience.reset_chaos()
    snap = obs.snapshot()["counters"]
    ring_names = {e.get("name", "") for e in obs.REGISTRY.events}
    step = {
        "rc": rc,
        "chaos_injected": snap.get("chaos.injected.io.read", 0.0),
        "retry_attempts": snap.get("io.retry.io.read", 0.0),
        "retry_recovered": snap.get("io.retry.recovered", 0.0),
        "events": sorted(n for n in ring_names
                         if n.startswith(("chaos.", "io.retry"))),
    }
    check(rc == 0, f"transient-io train rc={rc} (want 0: zero run failures)")
    check(step["chaos_injected"] >= 1, "no io.read faults were injected")
    check(step["retry_attempts"] == step["chaos_injected"],
          "io.retry.io.read counter does not match injected faults")
    check("chaos.inject" in step["events"] and "io.retry" in step["events"],
          "registry missing chaos.inject / io.retry events")
    record["steps"]["transient_io"] = step

    # 6. serve warm-load retry under chaos --------------------------------
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.serve.registry import ModelRegistry

    cfg = hocon.load(_conf(work, "base", 2))
    registry = ModelRegistry(watch_interval_s=0, device=args.device)
    registry.load("drill", "gbdt", cfg)
    before = obs.snapshot()["counters"].get("io.retry.serve.load", 0.0)
    # touch the version sidecar so the fingerprint changes, then reload
    # under injected faults: pick a seed whose draw schedule injects on
    # the first build attempt and passes the second (counter-based draws
    # make the schedule precomputable — the whole point)
    seed = next(
        s for s in range(1000)
        if resilience.site_draw(s, "serve.load", 1) < 0.6
        and resilience.site_draw(s, "serve.load", 2) >= 0.6
    )
    with open(os.path.join(work, "base.version.json"), "w") as f:
        json.dump({"version": 2, "archives": []}, f)
    resilience.reset_chaos()
    os.environ["YTK_CHAOS"] = f"serve.load:oserror:0.6:{seed}"
    try:
        swapped = registry.maybe_reload("drill")
    finally:
        os.environ["YTK_CHAOS"] = ""  # empty = disarmed (get_str treats as unset)
        resilience.reset_chaos()
    after = obs.snapshot()["counters"].get("io.retry.serve.load", 0.0)
    step = {"swapped": bool(swapped), "retries": after - before,
            "version": registry.get("drill").version}
    check(swapped, "serve reload did not complete under transient chaos")
    check(after - before >= 1, "serve reload recorded no retries")
    record["steps"]["serve_reload"] = step

    # 7. fleet: kill -9 one replica mid-load ------------------------------
    # (real `cli serve` workers over the step-1 model; the front must
    # reroute every in-flight request to the sibling, restart the slot,
    # and leave serve.worker.{died,restarted} evidence in a flight dump)
    import signal as _signal
    import threading

    from ytklearn_tpu_torch.obs import recorder
    from ytklearn_tpu_torch.serve import (
        BatchPolicy,
        FleetFront,
        serve_worker_argv,
    )

    recorder.install(flight_dir=os.path.join(work, "flight"))
    front = FleetFront(
        serve_worker_argv(
            _conf(work, "base", 2), "gbdt",
            ["--watch-interval", "0", "--max-queue", "8192"],
            device=args.device,
        ),
        2,
        policy=BatchPolicy(max_batch=256, max_wait_ms=0.5, max_queue=8192),
        ready_timeout_s=600.0,
        monitor_interval_s=0.1,
        log_dir=os.path.join(work, "fleet_logs"),
    ).start()
    errors, completed = [], [0]
    stop_evt = threading.Event()

    from ytklearn_tpu_torch.obs.recorder import thread_guard

    @thread_guard
    def hammer(tid: int) -> None:
        import numpy as np

        r = np.random.RandomState(tid)
        while not stop_evt.is_set():
            rows = [{f"c{j}": float(v) for j, v in enumerate(r.randn(8))}]
            try:
                out = front.predict(rows, timeout=60.0)
                assert len(out["scores"]) == 1
                completed[0] += 1
            except Exception as e:  # noqa: BLE001 — every failure is a finding
                errors.append(f"{type(e).__name__}: {e}"[:200])

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    victim_pid = None
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)  # traffic provably flowing
        victim_pid = front.handles[0].pid
        os.kill(victim_pid, _signal.SIGKILL)
        deadline = time.time() + 60.0
        while time.time() < deadline and not (
            front.handles[0].restarts >= 1
            and front.handles[0].state == "ready"
        ):
            time.sleep(0.05)
        time.sleep(0.5)  # traffic over the restarted replica too
    finally:
        stop_evt.set()
        for t in threads:
            t.join(timeout=30.0)
    snap = obs.snapshot()["counters"]
    dump_path = recorder.dump("fleet_drill")
    flight_doc = None
    if dump_path:
        with open(dump_path) as f:
            flight_doc = json.load(f)
    ring_names = sorted({
        e.get("name", "")
        for e in ((flight_doc or {}).get("flight") or {}).get("ring", [])
    })
    restarted_ev = next(
        (e for e in ((flight_doc or {}).get("flight") or {}).get("ring", [])
         if e.get("name") == "serve.worker.restarted"), None,
    )
    step = {
        "requests_completed": completed[0],
        "request_failures": len(errors),
        "failure_samples": errors[:3],
        "victim_pid": victim_pid,
        "restarts": front.handles[0].restarts,
        "replica_state": front.handles[0].state,
        "worker_died": snap.get("serve.worker.died", 0.0),
        "worker_restarted": snap.get("serve.worker.restarted", 0.0),
        "reroutes": snap.get("serve.front.reroutes", 0.0),
        "flight_dump": os.path.basename(dump_path) if dump_path else None,
        "flight_ring_events": [n for n in ring_names
                               if n.startswith("serve.")],
        "restart_event_replica": (restarted_ev or {}).get("args", {}).get(
            "replica_id"),
    }
    front.stop(drain=True, timeout=60.0)
    recorder.uninstall()
    check(len(errors) == 0,
          f"fleet kill: {len(errors)} in-flight request failure(s): "
          f"{errors[:3]}")
    check(completed[0] > 50, "fleet kill: almost no traffic completed")
    check(front.handles[0].restarts >= 1, "fleet kill: replica not restarted")
    check(step["worker_died"] >= 1, "fleet kill: no serve.worker.died counter")
    check(step["worker_restarted"] >= 1,
          "fleet kill: no serve.worker.restarted counter")
    check("serve.worker.restarted" in step["flight_ring_events"],
          "fleet kill: flight dump missing serve.worker.restarted event")
    check(step["restart_event_replica"] == 0,
          "fleet kill: restart event does not name replica 0")
    record["steps"]["fleet_kill"] = step

    # 8. autoscale: kill -9 a replica MID-RAMP ----------------------------
    # (the heal/autoscale interplay: the monitor owns the dead slot —
    # respawn counts as capacity arriving, the autoscaler defers, and
    # the slot count never exceeds the --replicas-max bound)
    import collections

    from ytklearn_tpu_torch.serve.batcher import OverloadError

    recorder.install(flight_dir=os.path.join(work, "flight"))
    counters0 = obs.snapshot()["counters"]
    REPLICAS_MAX = 3
    front = FleetFront(
        serve_worker_argv(
            _conf(work, "base", 2), "gbdt",
            ["--watch-interval", "0", "--max-queue", "16384"],
            device=args.device,
        ),
        1,
        policy=BatchPolicy(max_batch=256, max_wait_ms=0.5, max_queue=16384),
        ready_timeout_s=600.0,
        monitor_interval_s=0.1,
        log_dir=os.path.join(work, "fleet_logs"),
        # a tight SLO makes the saturated front's p99 the up signal (the
        # drill model is tiny — backlog alone would never accumulate)
        slo_ms=15.0,
        replicas_min=1,
        replicas_max=REPLICAS_MAX,
        autoscale={"interval_s": 0.3, "up_backlog": 64.0,
                   "down_backlog": 4.0, "up_windows": 2,
                   "down_windows": 1 << 20, "up_cooldown_s": 1.0,
                   "down_cooldown_s": 60.0},
    ).start()
    errors, completed, sheds = [], [0], [0]
    max_slots_seen = [len(front.handles)]
    stop_evt = threading.Event()
    watch_stop = threading.Event()

    from ytklearn_tpu_torch.obs.recorder import thread_guard

    @thread_guard
    def slot_watch() -> None:
        # the no-double-spawn witness: sample the slot count the whole
        # drill — one instant past REPLICAS_MAX is the failure
        while not watch_stop.wait(0.05):
            n = len(front.handles)
            if n > max_slots_seen[0]:
                max_slots_seen[0] = n

    from ytklearn_tpu_torch.obs.recorder import thread_guard

    @thread_guard
    def pump() -> None:
        import numpy as np

        r = np.random.RandomState(0)
        rows = [{f"c{j}": float(v) for j, v in enumerate(r.randn(8))}
                for _ in range(256)]
        inflight = collections.deque()
        i = 0
        while not stop_evt.is_set() or inflight:
            if not stop_evt.is_set() and len(inflight) < 1500:
                try:
                    inflight.append(front.submit([rows[i % len(rows)]]))
                    i += 1
                    continue
                except OverloadError:
                    sheds[0] += 1
                    stop_evt.wait(0.002)
                    continue
                except Exception as e:  # noqa: BLE001 — every failure is a finding
                    errors.append(f"submit {type(e).__name__}: {e}"[:200])
                    stop_evt.wait(0.01)
                    continue
            if inflight:
                p = inflight.popleft()
                try:
                    p.get(timeout=120.0)
                    completed[0] += 1
                except Exception as e:  # noqa: BLE001 — every failure is a finding
                    errors.append(f"{type(e).__name__}: {e}"[:200])

    watcher = threading.Thread(target=slot_watch, daemon=True)
    pumper = threading.Thread(target=pump)
    victim_rid = victim_pid = None
    try:
        watcher.start()
        pumper.start()
        # wait for the ramp to be provably in progress (a scale-up landed)
        deadline = time.time() + 300.0
        while time.time() < deadline and len(front._ready_ids()) < 2:
            time.sleep(0.05)
        ramped = len(front._ready_ids()) >= 2
        # kill a READY replica mid-ramp
        victim_rid = sorted(front._ready_ids())[0]
        victim = front.handles[victim_rid]
        victim_pid = victim.pid
        os.kill(victim_pid, _signal.SIGKILL)
        deadline = time.time() + 300.0
        while time.time() < deadline and not (
            victim.restarts >= 1 and victim.state == "ready"
        ):
            time.sleep(0.05)
        healed = victim.restarts >= 1 and victim.state == "ready"
        time.sleep(1.0)  # load over the healed slot, more defer/up ticks
    finally:
        stop_evt.set()
        pumper.join(timeout=120.0)
        watch_stop.set()
        watcher.join(timeout=10.0)
    snap = obs.snapshot()["counters"]
    autoscale_snap = (front.autoscaler.snapshot()
                      if front.autoscaler is not None else {})
    dump_path = recorder.dump("autoscale_drill")
    flight_doc = None
    if dump_path:
        with open(dump_path) as f:
            flight_doc = json.load(f)
    ring_names = sorted({
        e.get("name", "")
        for e in ((flight_doc or {}).get("flight") or {}).get("ring", [])
    })

    def delta(key: str) -> float:
        return snap.get(key, 0.0) - counters0.get(key, 0.0)

    step = {
        "requests_completed": completed[0],
        "request_failures": len(errors),
        "failure_samples": errors[:3],
        "shed_429": sheds[0],
        "victim_replica": victim_rid,
        "victim_pid": victim_pid,
        "replicas_max": REPLICAS_MAX,
        "max_slots_seen": max_slots_seen[0],
        "ready_at_end": len(front._ready_ids()),
        "scale_up": delta("serve.scale.up"),
        "scale_deferred": delta("serve.scale.deferred"),
        "scale_blocked": delta("serve.scale.blocked"),
        "worker_died": delta("serve.worker.died"),
        "worker_restarted": delta("serve.worker.restarted"),
        "autoscale_state": autoscale_snap,
        "flight_dump": os.path.basename(dump_path) if dump_path else None,
        "flight_ring_events": [n for n in ring_names
                               if n.startswith("serve.")],
    }
    front.stop(drain=True, timeout=60.0)
    recorder.uninstall()
    check(ramped, "autoscale: fleet never ramped past 1 replica under load")
    check(len(errors) == 0,
          f"autoscale kill: {len(errors)} in-flight request failure(s): "
          f"{errors[:3]}")
    check(completed[0] > 100, "autoscale: almost no traffic completed")
    check(healed, "autoscale: monitor did not heal the killed replica")
    check(step["worker_died"] >= 1, "autoscale: no serve.worker.died")
    check(step["worker_restarted"] >= 1,
          "autoscale: no serve.worker.restarted (heal is the monitor's job)")
    check(step["scale_up"] >= 1, "autoscale: no serve.scale.up decision")
    check(step["scale_deferred"] >= 1,
          "autoscale: no serve.scale.deferred while the respawn was in "
          "flight")
    check(step["max_slots_seen"] <= REPLICAS_MAX,
          f"autoscale: slot count hit {step['max_slots_seen']} — the "
          f"autoscaler double-spawned past --replicas-max={REPLICAS_MAX}")
    check("serve.scale.up" in step["flight_ring_events"],
          "autoscale: flight dump missing serve.scale.up event")
    record["steps"]["autoscale_kill_mid_ramp"] = step

    record["problems"] = problems
    with open(args.out + ".tmp", "w") as f:
        json.dump(record, f, indent=1)
    os.replace(args.out + ".tmp", args.out)
    print(f"chaos drill {'PASSED' if record['passed'] else 'FAILED'}; "
          f"artifact: {args.out}")
    if not args.keep:
        shutil.rmtree(work, ignore_errors=True)
    else:
        print(f"scratch kept at {work}")
    return 0 if record["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
