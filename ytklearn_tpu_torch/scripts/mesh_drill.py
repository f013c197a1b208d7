"""Mesh-obs drill on `--device`: per-model SLO and accounting isolation on
a real fleet (the port's counterpart of scripts/mesh_drill.py).

Spawns a multi-replica serving fleet (`cli serve` workers on `--device`
behind the FleetFront) loading 3 linear models, then drives skewed
traffic: one abusive tenant ("hog", with a tight per-model SLO through
YTK_SERVE_SLO_MODELS) saturates its queue with tight-deadline bursts while
two quiet tenants ("calm", "steady") serve normal traffic. Writes one
JSON record (schema "ytkmesh_drill" v1):

  isolation     the hog's per-model burn sentinel fires by name
                (health.slo_burn.serve.model.hog) on the replicas that
                served it; the quiet models' sentinels stay silent, as
                the fleet-merged /metrics?models=1 table shows
  conservation  on every replica, each per-model counter family sums
                exactly to its global twin (serve.model.*.requests ==
                serve.requests, the same for rows/shed/504/cache)
  fleet view    the front unions per-model latency rings across replicas
                and ranks top talkers by served rows
  overhead      the ?models=1 payload costs within a small band of the
                plain /metrics scrape (env MESH_OVERHEAD_BAND)
  flight        an in-process serving postmortem carries the per-model
                block, naming the tenant

The record adds `device`, `card`, `floors` and `kernel_launches` to the
reference's.

Usage:
    python -m ytklearn_tpu_torch.scripts.mesh_drill [--record PATH]
        [--replicas 2] [--quiet-requests 120] [--abuse-requests 400]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import statistics
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np  # noqa: E402

from ytklearn_tpu_torch.scripts.serve_bench import (  # noqa: E402
    floor,
    resolve,
    stamp,
)

log = logging.getLogger("mesh_drill")

N_FEATS = 6
#: (suffix, global twin) pairs under the exact-conservation identity
CONSERVED = [
    ("requests", "serve.requests"),
    ("request_rows", "serve.request_rows"),
    ("shed", "serve.shed"),
    ("deadline_expired", "serve.deadline_expired"),
    ("cache.hit", "serve.cache.hit"),
    ("cache.miss", "serve.cache.miss"),
]


def _write_linear(tmp_dir: str, name: str, seed: int) -> str:
    """A real linear model file and JSON config the registry loads through
    the standard parse path. Distinct seeds give distinct fingerprints,
    so the prediction cache never crosses tenants."""
    rng = np.random.RandomState(seed)
    model_path = os.path.join(tmp_dir, f"{name}.model")
    lines = [
        f"c{i},{rng.randn():.6f},{abs(rng.randn()) + 1.0:.6f}"
        for i in range(N_FEATS)
    ]
    lines.append(f"_bias_,{rng.randn():.6f}")
    with open(model_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    conf_path = os.path.join(tmp_dir, f"{name}.conf")
    with open(conf_path, "w") as f:
        json.dump({"model": {"data_path": model_path},
                   "loss": {"loss_function": "sigmoid"}}, f)
    return conf_path


def _rows(rng, n_rows: int) -> list:
    return [{f"c{i}": float(v) for i, v in enumerate(rng.randn(N_FEATS))}
            for _ in range(n_rows)]


def _get(port: int, path: str, timeout: float = 30.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _quiet_traffic(front, model: str, rng, n: int) -> dict:
    """A sequential well-behaved tenant: small fresh batches plus a
    repeated hot batch (real cache hits for the per-model view)."""
    hot = _rows(np.random.RandomState(hash(model) % 2**31), 2)
    ok = hits = 0
    for i in range(n):
        rows = hot if i % 3 == 2 else _rows(rng, 2)
        out = front.predict(rows, model=model, timeout=60.0)
        ok += 1
        if out.get("cached"):
            hits += 1
    return {"requests": ok, "cached_responses": hits}


def _hog_success(front, rng, n: int, per_request: int) -> int:
    for _ in range(n):
        front.predict(_rows(rng, per_request), model="hog", timeout=60.0)
    return n


def _hog_abuse(front, n_requests: int, threads: int = 16,
               per_request: int = 6, deadline_ms: float = 0.5) -> dict:
    """The abusive burst: many concurrent clients, tight deadlines, more
    rows in flight than the replica queue bound: real replica-side sheds
    (429) and deadline expiries (504), all named 'hog'."""
    from ytklearn_tpu_torch.obs.recorder import thread_guard
    from ytklearn_tpu_torch.serve.batcher import (DeadlineExceeded,
                                                  OverloadError)

    rng_local = np.random.RandomState(99)
    batches = [_rows(rng_local, per_request) for _ in range(n_requests)]
    counts = {"ok": 0, "shed_429": 0, "expired_504": 0, "other": 0}
    lock = threading.Lock()

    @thread_guard
    def client(k):
        for i in range(k, len(batches), threads):
            try:
                front.predict(batches[i], model="hog",
                              deadline_ms=deadline_ms, timeout=60.0)
                key = "ok"
            except OverloadError:
                key = "shed_429"
            except DeadlineExceeded:
                key = "expired_504"
            # every failure class is tallied and judged after the burst
            except Exception:  # noqa: BLE001
                key = "other"
            with lock:
                counts[key] += 1

    ts = [threading.Thread(target=client, args=(k,), daemon=True)
          for k in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300.0)
    return counts


def _replica_models(front) -> dict:
    """{rid: /metrics?models=1 payload} of each ready replica."""
    out = {}
    for rid, h in sorted(front.handles.items()):
        if h.state != "ready":
            continue
        status, m = _get(h.port, "/metrics?models=1&raw=1")
        if status == 200:
            out[str(rid)] = m
    return out


def _check_conservation(replica_payloads: dict, fails: list) -> dict:
    """Per replica, per counter pair: the sum over model families equals
    the global twin exactly (both read from one registry snapshot)."""
    detail = {}
    ok = True
    for rid, payload in sorted(replica_payloads.items()):
        g = payload.get("counters") or {}
        fams = (payload.get("model_metrics") or {}).get("models") or {}
        pairs = {}
        for suffix, twin in CONSERVED:
            models_sum = round(sum(
                (fam.get("counters") or {}).get(suffix, 0.0)
                for fam in fams.values()
            ), 3)
            global_v = round(g.get(twin, 0.0), 3)
            pairs[suffix] = {"models_sum": models_sum, "global": global_v}
            if models_sum != global_v:
                ok = False
                fails.append(
                    f"replica {rid}: conservation broke for {twin}: "
                    f"sum(serve.model.*.{suffix}) = {models_sum} != "
                    f"{global_v}"
                )
        detail[rid] = pairs
    return {"ok": ok, "per_replica": detail}


def _overhead(port: int, reps: int, band: float, fails: list) -> dict:
    """The median front scrape cost: plain /metrics against
    /metrics?models=1."""
    plain, with_models = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        _get(port, "/metrics")
        plain.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        _get(port, "/metrics?models=1")
        with_models.append((time.perf_counter() - t0) * 1e3)
    p, m = statistics.median(plain), statistics.median(with_models)
    ratio = round(m / p, 3) if p > 0 else float("inf")
    ok = m <= p * band
    if not ok:
        fails.append(
            f"?models=1 scrape cost {m:.2f} ms > {band:.1f}x the plain "
            f"{p:.2f} ms scrape (env MESH_OVERHEAD_BAND)"
        )
    return {"plain_ms": round(p, 3), "models_ms": round(m, 3),
            "ratio": ratio, "band": band, "ok": ok}


def _flight_step(confs: dict, fails: list, device) -> dict:
    """In-process postmortem: a ServeApp serving the same 3 tenants, one
    unknown-name 404, then a flight dump: the dump must carry the
    per-model block and name every tenant."""
    from ytklearn_tpu_torch.config import hocon
    from ytklearn_tpu_torch.obs import recorder
    from ytklearn_tpu_torch.serve import BatchPolicy, ModelRegistry, ServeApp

    rng = np.random.RandomState(5)
    reg = ModelRegistry(watch_interval_s=0, device=device)
    for name, conf in confs.items():
        reg.load(name, "linear", hocon.load(conf))
    app = ServeApp(reg, BatchPolicy(max_batch=32, max_wait_ms=0.5))
    try:
        for name in confs:
            app.predict(_rows(rng, 2), model=name, timeout=30.0)
        try:
            app.predict(_rows(rng, 1), model="intruder", timeout=30.0)
        except KeyError:
            pass
        path = recorder.dump(reason="mesh_drill")
        with open(path) as f:
            doc = json.load(f)
        block = (doc.get("flight") or {}).get("model_metrics") or {}
        in_dump = sorted((block.get("models") or {}).keys())
        not_found = ((block.get("models") or {}).get("__overflow__") or {}
                     ).get("counters", {}).get("not_found", 0)
        missing = sorted(set(confs) - set(in_dump))
        if missing:
            fails.append(f"flight dump lost per-model blocks: {missing}")
        if not not_found:
            fails.append("flight dump: the 404 never landed in "
                         "__overflow__.not_found")
        os.unlink(path)  # evidence recorded; the dump itself is scratch
        return {"models_in_dump": in_dump, "overflow_not_found": not_found,
                "ok": not missing and bool(not_found)}
    finally:
        for b in app._batchers.values():
            b.close(drain=True)
        reg.close()


def fleet_step(args, tmp_dir: str, fails: list, device) -> dict:
    from ytklearn_tpu_torch.serve import (BatchPolicy, FleetFront,
                                          serve_worker_argv)

    confs = {name: _write_linear(tmp_dir, name, seed)
             for seed, name in enumerate(("hog", "calm", "steady"))}
    flags = [
        "--name", "hog",
        "--extra-model", f"calm:linear:{confs['calm']}",
        "--extra-model", f"steady:linear:{confs['steady']}",
        "--watch-interval", "0", "--max-batch", "16",
        "--max-wait-ms", "1.0", "--max-queue", "16",
        "--cache-rows", "256", "--slo-ms", "50",
    ]
    front = FleetFront(
        serve_worker_argv(confs["hog"], "linear", flags, device=str(device)),
        args.replicas,
        policy=BatchPolicy(max_batch=64, max_wait_ms=0.5, max_queue=8192),
        ready_timeout_s=600.0,
    ).start().serve_http()
    out = {"confs": confs}
    try:
        rng = np.random.RandomState(1)
        quiet = {
            name: _quiet_traffic(front, name, rng, args.quiet_requests)
            for name in ("calm", "steady")
        }
        hog_ok = _hog_success(front, rng, args.hog_requests, per_request=8)
        abuse = _hog_abuse(front, args.abuse_requests)
        log.info("traffic: quiet=%s hog_ok=%d abuse=%s", quiet, hog_ok, abuse)
        if abuse["shed_429"] + abuse["expired_504"] == 0:
            fails.append(
                "the abusive burst produced no sheds or deadline "
                "expiries: the drill never actually saturated the hog"
            )
        out["traffic"] = {"quiet": quiet, "hog_ok": hog_ok, "abuse": abuse}
        out["requests"] = (2 * args.quiet_requests + hog_ok
                           + sum(abuse.values()))

        time.sleep(2.0)  # in-flight batches land; counters quiesce
        replica_payloads = _replica_models(front)
        if len(replica_payloads) < args.replicas:
            fails.append(
                f"only {len(replica_payloads)}/{args.replicas} replicas "
                "answered /metrics?models=1"
            )
        out["conservation"] = _check_conservation(replica_payloads, fails)

        status, fleet = _get(front.port, "/metrics?models=1")
        if status != 200:
            fails.append(f"front /metrics?models=1 -> {status}")
            fleet = {}
        merged = fleet.get("model_metrics") or {}
        models = merged.get("models") or {}
        out["models"] = models
        out["top_talkers"] = merged.get("top_talkers") or []

        abusive_fired = ((models.get("hog") or {}).get("slo") or {}
                         ).get("windows_fired", 0)
        quiet_fired = sum(
            ((mb.get("slo") or {}).get("windows_fired") or 0)
            for name, mb in models.items() if name != "hog"
        )
        iso_ok = abusive_fired >= 1 and quiet_fired == 0
        if abusive_fired < 1:
            fails.append(
                "the hog's per-model burn sentinel "
                "(health.slo_burn.serve.model.hog) never fired on any "
                "replica despite the saturating burst"
            )
        if quiet_fired:
            fails.append(
                f"quiet models burned {quiet_fired} SLO window(s): the "
                "abusive tenant's load leaked into its neighbors' SLOs"
            )
        out["burn_isolation"] = {
            "abusive": "hog", "abusive_fired": abusive_fired,
            "quiet_fired": quiet_fired, "ok": iso_ok,
        }
        talkers = out["top_talkers"]
        if not talkers or talkers[0].get("model") != "hog":
            fails.append(
                f"top-talker ranking did not name the hog first: {talkers}"
            )
        out["overhead"] = _overhead(
            front.port, reps=30,
            band=float(os.environ.get("MESH_OVERHEAD_BAND", "3.0")),
            fails=fails,
        )
    finally:
        front.stop(drain=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--record", default="",
                    help="write the ytkmesh_drill record here")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--quiet-requests", type=int, default=120,
                    help="requests per quiet tenant")
    ap.add_argument("--hog-requests", type=int, default=150,
                    help="well-formed hog requests (top-talker volume)")
    ap.add_argument("--abuse-requests", type=int, default=400,
                    help="tight-deadline burst requests")
    ap.add_argument("--device", default="cuda",
                    help="device of every replica and the in-process "
                    "server: cuda (the default; raises without a GPU) or "
                    "cpu")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, stream=sys.stderr,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    dev, card = resolve(args.device)
    # env writes, so the spawned replica workers inherit the armed plane:
    # obs collection, the hog's tight per-model SLO and a small burn
    # window the drill's burst fills; in-process reads all go through
    # config/knobs.py
    os.environ.setdefault("YTK_OBS", "1")
    os.environ["YTK_SERVE_SLO_MODELS"] = "hog:2"
    os.environ["YTK_SLO_BURN_WINDOW"] = "32"
    os.environ["YTK_SLO_BURN_BUDGET"] = "0.25"

    from ytklearn_tpu_torch import obs
    from ytklearn_tpu_torch.config import knobs

    if knobs.get_raw("YTK_OBS") != "0":
        obs.configure(enabled=True)

    fails: list = []
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp_dir:
        log.info("== live %d-replica fleet on %s, 3 tenants, skewed "
                 "traffic ==", args.replicas, dev)
        fleet = fleet_step(args, tmp_dir, fails, dev)
        log.info("== in-process flight-dump leg ==")
        flight = _flight_step(fleet.pop("confs"), fails, dev)

    overhead = fleet.get("overhead") or {}
    rec = {
        "schema": "ytkmesh_drill",
        "schema_version": 1,
        "metric": "mesh_model_isolation",
        "value": int(not fails),
        "unit": "ok",
        "replicas": args.replicas,
        "requests": fleet.get("requests"),
        "slo": {"hog_ms": 2.0, "default_ms": 50.0,
                "burn_window": 32, "burn_budget": 0.25},
        "traffic": fleet.get("traffic"),
        "models": fleet.get("models"),
        "top_talkers": fleet.get("top_talkers"),
        "burn_isolation": fleet.get("burn_isolation"),
        "conservation": fleet.get("conservation"),
        "overhead": fleet.get("overhead"),
        "flight": flight,
        "wall_s": round(time.time() - t0, 1),
        "failures": fails,
        "ok": not fails,
    }
    stamp(rec, dev, card, [floor(
        "MESH_OVERHEAD_BAND", overhead.get("ratio"), overhead.get("band"),
        overhead.get("ok"))])
    if args.record:
        with open(args.record, "w") as f:
            json.dump(rec, f, indent=1, sort_keys=True)
        log.info("wrote %s", args.record)
    print(json.dumps({k: rec[k] for k in (
        "metric", "replicas", "requests", "burn_isolation",
        "conservation", "overhead", "wall_s", "ok", "device", "card")},
        indent=2, default=str))
    for msg in fails:
        print(f"FAIL: {msg}", file=sys.stderr)
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
