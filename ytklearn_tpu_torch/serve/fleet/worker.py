"""Replica worker process management for the serving fleet (the JAX
package's ``serve/fleet/worker.py``).

A *replica* is one ordinary single-process server (the port's `cli serve`
— the whole batcher+CompiledScorer+registry stack, launching K6 or K7 on
its `--device`) spawned as a subprocess with `--replica-id N --port 0`. The contract between front and worker is
deliberately thin — shared-nothing, one pipe line and one port:

  banner     the worker prints ONE JSON line on stdout
             (`{"serving": ..., "port": <bound port>, ...}`); the front
             reads the ephemeral port from it
  readiness  the worker's own `/readyz` (models loaded + warmed, not
             draining) — the front polls it before routing traffic, at
             startup and after every restart
  identity   `--replica-id` stamps obs identity (replica_id, pid) into
             the worker's events, flight dumps, and `/metrics.replica`

`spawn_replica` is also what the front's crash-restart path calls: the
spawn itself rides `resilience.retry` (site `serve.worker`), so a
transiently failing exec/bind costs a backoff instead of a dead slot.
Tests inject a stub `argv` (tests/fleet_stub_worker.py) to drill the
spawn/kill/restart machinery without paying a torch import per replica.

On one GPU every replica shares the card: each process makes its own CUDA
context and loads (or, cold, builds) the kernel libraries at its first
launch, and their kernels time-slice the device.
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from ...resilience import retry_call
from ...obs.recorder import thread_guard

log = logging.getLogger("ytklearn_tpu_torch.serve.fleet")


class WorkerStartupError(RuntimeError):
    """The worker exited or failed to report a port/readiness in time."""


class ReplicaHandle:
    """One live (or restarting) replica slot owned by the front."""

    __slots__ = ("replica_id", "proc", "port", "state", "restarts",
                 "started_at", "log_path", "wall_t0")

    def __init__(self, replica_id: int):
        self.replica_id = replica_id
        self.proc: Optional[subprocess.Popen] = None
        self.port: int = 0
        #: starting | ready | dead | draining.  "draining" is the
        #: scale-down fence too (front.scale_down): the balancer skips it
        #: and the monitor ignores it (only ready/dead slots are acted
        #: on), so a slot mid-reap can neither receive traffic nor be
        #: "healed" back to life
        self.state = "starting"
        self.restarts = 0
        self.started_at = 0.0
        self.log_path: Optional[str] = None
        #: the replica's obs clock origin on the wall clock (banner
        #: handshake, stamped at every spawn): trace-hop offsets from this
        #: replica align to the front's timeline as `wall_t0 + ts`
        self.wall_t0: Optional[float] = None

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None


def http_json(
    method: str,
    port: int,
    path: str,
    payload=None,
    timeout: float = 10.0,
    headers: Optional[Dict[str, str]] = None,
):
    """One HTTP round-trip to a local replica -> (status, parsed body).
    `payload` may be a dict (JSON-encoded here) or pre-built str/bytes
    (the front's raw-splice forward path skips a re-encode). `headers`
    merge over the defaults (the trace-context propagation header rides
    here). Connection-level failures raise (OSError shapes — the
    retry/reroute classification in front.py keys off that)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if payload is None:
            body = None
        elif isinstance(payload, bytes):
            body = payload
        elif isinstance(payload, str):
            body = payload.encode()
        else:
            body = json.dumps(payload).encode()
        hdrs = {"Content-Type": "application/json"} if body else {}
        if headers:
            hdrs.update(headers)
        try:
            conn.request(method, path, body=body, headers=hdrs)
            resp = conn.getresponse()
            raw = resp.read()
        except http.client.HTTPException as e:
            # a peer dying MID-exchange surfaces as IncompleteRead /
            # BadStatusLine — HTTPException, not OSError. Normalize to the
            # OSError family so the reroute classification (is_transient)
            # treats a mid-response crash like any other connection loss
            raise ConnectionResetError(
                f"HTTP exchange broke mid-response: {type(e).__name__}: {e}"
            ) from e
        try:
            data = json.loads(raw) if raw else {}
        except json.JSONDecodeError:
            data = {"error": raw[:200].decode("utf-8", "replace")}
        return resp.status, data
    finally:
        conn.close()


def _read_banner(proc: subprocess.Popen, timeout_s: float) -> dict:
    """First stdout line as JSON, read on a helper thread so a silent or
    wedged worker can't hang the front."""
    out: List[str] = []

    @thread_guard
    def _read():
        try:
            out.append(proc.stdout.readline())
        except (OSError, ValueError):
            pass

    t = threading.Thread(target=_read, name="ytk-fleet-banner", daemon=True)
    t.start()
    t.join(timeout=timeout_s)
    if not out or not out[0]:
        raise WorkerStartupError(
            f"worker pid={proc.pid} printed no banner within {timeout_s:.0f}s"
            + (f" (exited rc={proc.returncode})" if proc.poll() is not None
               else "")
        )
    try:
        banner = json.loads(out[0])
    except json.JSONDecodeError as e:
        raise WorkerStartupError(
            f"worker pid={proc.pid} banner is not JSON: {out[0][:200]!r}"
        ) from e
    if not isinstance(banner, dict) or "port" not in banner:
        raise WorkerStartupError(
            f"worker pid={proc.pid} banner has no port: {banner!r}"
        )
    return banner


def wait_ready(port: int, timeout_s: float, proc=None,
               abort: Optional[Callable[[], bool]] = None) -> None:
    """Poll the worker's /readyz until 200 (models loaded AND warm).
    `abort` (e.g. "the fleet is closing") ends the wait early."""
    deadline = time.monotonic() + timeout_s
    last = "no response yet"
    while time.monotonic() < deadline:
        if abort is not None and abort():
            raise WorkerStartupError("worker startup aborted (fleet closing)")
        if proc is not None and proc.poll() is not None:
            raise WorkerStartupError(
                f"worker exited rc={proc.returncode} before becoming ready"
            )
        try:
            status, body = http_json("GET", port, "/readyz", timeout=2.0)
            if status == 200:
                return
            last = f"readyz {status}: {body.get('status')}"
        except OSError as e:
            last = f"{type(e).__name__}: {e}"
        time.sleep(0.05)
    raise WorkerStartupError(
        f"worker on port {port} not ready within {timeout_s:.0f}s ({last})"
    )


def spawn_replica(
    argv: List[str],
    replica_id: int,
    handle: Optional[ReplicaHandle] = None,
    env: Optional[Dict[str, str]] = None,
    log_dir: Optional[str] = None,
    ready_timeout_s: float = 120.0,
    abort: Optional[Callable[[], bool]] = None,
) -> ReplicaHandle:
    """Spawn `argv + [--replica-id N]`, read the port banner, wait for
    /readyz. Reuses `handle` on restart (slot identity, restart count).
    The spawn itself is retried under the `serve.worker` site. `abort`
    ends the ready wait early (fleet shutdown mid-respawn). The child is
    published on `h.proc` IMMEDIATELY after Popen — before it is ready —
    so a stop() racing a respawn can always terminate it (no orphan)."""
    h = handle or ReplicaHandle(replica_id)

    def _once() -> None:
        h.state = "starting"
        stderr = subprocess.DEVNULL
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            h.log_path = os.path.join(log_dir, f"replica_{replica_id}.log")
            stderr = open(h.log_path, "ab")
        try:
            proc = subprocess.Popen(
                list(argv) + ["--replica-id", str(replica_id)],
                stdout=subprocess.PIPE,
                stderr=stderr,
                env=dict(os.environ, **(env or {})),
                text=True,
            )
        finally:
            if stderr is not subprocess.DEVNULL:
                stderr.close()  # the child holds its own fd now
        h.proc = proc  # visible to stop_replica from the first instant
        try:
            banner = _read_banner(proc, ready_timeout_s)
            port = int(banner["port"])
            wait_ready(port, ready_timeout_s, proc=proc, abort=abort)
        except Exception:
            # never leak a half-started worker process into the fleet
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10.0)
            raise
        h.port = port
        h.state = "ready"
        h.started_at = time.time()
        # monotonic-offset handshake: the worker banner carries its obs
        # clock origin (wall_t0); the front keeps it per slot so a trace
        # merge can align replica hop offsets without re-asking a process
        # that may be dead by postmortem time
        h.wall_t0 = banner.get("wall_t0")
        log.info(
            "fleet: replica %d ready (pid=%d port=%d)",
            replica_id, proc.pid, port,
        )

    retry_call(_once, site="serve.worker")
    return h


@thread_guard
def stop_replica(h: ReplicaHandle, timeout_s: float = 30.0,
                 reason: str = "shutdown") -> None:
    """SIGTERM (the worker drains in-flight work), escalate to kill.
    Fleet shutdown and autoscaler scale-down both end here: by the time
    scale_down() calls this the slot is already fenced and its forwarder
    drained, so the worker's own SIGTERM drain finds at most the batch
    it is currently scoring — zero requests are lost to a reap."""
    h.state = "draining"
    proc = h.proc
    if proc is None or proc.poll() is not None:
        h.state = "dead"
        return
    proc.terminate()
    try:
        proc.wait(timeout=timeout_s)
    except subprocess.TimeoutExpired:
        log.warning(
            "fleet: replica %d did not drain in %.0fs (%s); killing",
            h.replica_id, timeout_s, reason,
        )
        proc.kill()
        proc.wait(timeout=10.0)
    h.state = "dead"


def default_replica_count(device=None) -> int:
    """`--replicas -1` / auto: one replica per GPU on `cuda` (the default
    device), or per CPU core divided by two on `cpu` (each CPU replica
    runs a featurize thread and a torch thread pool; 1:1 per core
    oversubscribes). `cuda` with no GPU raises, like every entry point."""
    from ...device import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        import torch

        return max(1, torch.cuda.device_count())
    return max(1, (os.cpu_count() or 2) // 2)


def serve_worker_argv(
    config_path: str,
    model_name: str,
    extra_flags: Optional[List[str]] = None,
    device: str = "cuda",
) -> List[str]:
    """The real worker command: the port's `python -m
    ytklearn_tpu_torch.cli serve` on `device`, bound to an ephemeral
    localhost port, single-process (`--replicas 0`)."""
    return [
        sys.executable, "-m", "ytklearn_tpu_torch.cli", "serve",
        config_path, model_name,
        "--host", "127.0.0.1", "--port", "0", "--replicas", "0",
        "--device", str(device),
    ] + list(extra_flags or [])
