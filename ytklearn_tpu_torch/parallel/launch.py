"""One launcher, N ranks, the whole data (`cli train <family> --devices N`,
`cli retrain <family> --devices N`).

The reference's one-process mesh of N devices (`jax.process_count() == 1`)
becomes a launcher process and N rank processes, one a device. This
module is the plumbing every family shares; a family brings two steps:

  prepare(dirpath) -> meta   in the launcher: parse (and for GBDT bin)
                             the data once and write what the ranks read
                             into `dirpath` (.npy arrays they memory-map,
                             a pickle); `meta` may name "data_path", the
                             model a preempted run leaves behind
  rank_main(dirpath, mesh) -> report
                             in each rank: read the arrays, take the
                             rank's contiguous row shard, train with
                             `mesh`; rank 0 dumps. The report is
                             rank_report(mesh, seconds, result=<the JSON
                             record the CLI prints>, <the family's keys>)

`run_ranks` picks the backend (parallel.mesh.choose_backend: NCCL when
every rank has a GPU of its own, gloo on the CPU and when ranks share a
card) and a rendezvous file in `dirpath` (no port to race for), starts
`python -m ytklearn_tpu_torch.parallel.launch <dir> <rank>` for each
rank, waits for every rank (the first that fails stops the others:
its peers would wait in a collective until the group's timeout), and
returns rank 0's result with every rank's report under "ranks": its
device, backend, collective census, health sentinel counts, seconds and
the family's keys. A rank's error goes to the launcher's stderr; a
preempted rank's exit code (128 + signum) is the launcher's `Preempted`
when every rank exits with it.
"""

from __future__ import annotations

import importlib
import json
import logging
import os
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Tuple

log = logging.getLogger("ytklearn_tpu_torch.parallel.launch")

#: seconds between polls of the rank processes
POLL_S = 0.2

#: the module of each family's rank_main
FAMILIES = {
    "gbdt": "ytklearn_tpu_torch.gbdt.launch",
    "sparse": "ytklearn_tpu_torch.train_launch",
}


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def save_meta(dirpath: str, meta: dict) -> None:
    with open(os.path.join(dirpath, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)


def load_meta(dirpath: str) -> dict:
    with open(os.path.join(dirpath, "meta.pkl"), "rb") as f:
        return pickle.load(f)


def run_ranks(family: str, devices: List[str],
              prepare: Callable[[str], dict]) -> Tuple[dict, dict]:
    """Train on len(devices) ranks (devices[r] is rank r's) -> (rank 0's
    result with "ranks", every rank's report; the prepare step's meta)."""
    import torch

    from ..obs import enabled as obs_enabled
    from .mesh import choose_backend

    world = len(devices)
    backend = choose_backend([torch.device(d) for d in devices])
    dirpath = tempfile.mkdtemp(prefix="ytk_devices_")
    try:
        meta = prepare(dirpath)
        spec = {"family": family, "devices": list(devices),
                "backend": backend, "world": world,
                "addr": f"file://{os.path.join(dirpath, 'rendezvous')}",
                "obs": obs_enabled()}
        with open(os.path.join(dirpath, "spec.json"), "w") as f:
            json.dump(spec, f)
        log.info("--devices %d: %s %s ranks on %s over %s", world, world,
                 family, ",".join(devices), backend)
        # the ranks import this package from where the launcher did
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [x for x in [env.get("PYTHONPATH")] if x])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.parallel.launch",
             dirpath, str(r)], env=env) for r in range(world)]
        rcs = _wait(procs)
        if any(rcs):
            codes = set(rcs)
            if len(codes) == 1 and next(iter(codes)) > 128:
                from ..resilience import Preempted

                raise Preempted(next(iter(codes)) - 128,
                                str(meta.get("data_path", "")))
            raise RuntimeError(f"--devices {world}: rank exit codes {rcs}")
        reports = []
        for r in range(world):
            with open(os.path.join(dirpath, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        out = dict(reports[0]["result"])
        for rep in reports:
            rep.pop("result")
        out["ranks"] = reports
        return out, meta
    finally:
        shutil.rmtree(dirpath, ignore_errors=True)


def _wait(procs) -> List[int]:
    """Every rank's exit code; the first failure stops the rest."""
    try:
        while True:
            rcs = [p.poll() for p in procs]
            if all(rc is not None for rc in rcs):
                return rcs
            if any(rc not in (None, 0) for rc in rcs):
                break
            time.sleep(POLL_S)
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
        raise
    for p in procs:
        if p.poll() is None:
            p.terminate()
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    return [p.returncode if p.returncode is not None else -9 for p in procs]


def rank_report(mesh, seconds: float, **extra) -> Dict:
    """A rank's device, backend, collective census, health sentinel counts
    (while obs is on), seconds, and the family's `extra` keys."""
    from ..obs import collective_census, snapshot
    from ..obs.health import root_health_counters

    return {
        "rank": mesh.rank, "device": str(mesh.device),
        "backend": mesh.backend, **extra,
        "collectives": collective_census(),
        "health": dict(root_health_counters(snapshot()["counters"])),
        "seconds": seconds,
    }


def _rank(dirpath: str, rank: int) -> int:
    """One rank: join the group, run the family's rank step, write the
    report."""
    from .. import obs
    from ..cli import _setup_logging
    from .mesh import distributed_initialize_if_needed, make_mesh, \
        release_mesh

    _setup_logging(False)
    with open(os.path.join(dirpath, "spec.json")) as f:
        spec = json.load(f)
    if spec["obs"]:
        # the launcher's health gate reads the ranks' sentinel counts
        obs.configure(enabled=True)
    device = spec["devices"][rank]
    distributed_initialize_if_needed(coordinator=spec["addr"],
                                     world_size=spec["world"], rank=rank,
                                     device=device, backend=spec["backend"])
    try:
        mesh = make_mesh(device, shared_ingest=True)
        module = importlib.import_module(FAMILIES[spec["family"]])
        report = module.rank_main(dirpath, mesh)
        tmp = os.path.join(dirpath, f"rank{rank}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, os.path.join(dirpath, f"rank{rank}.json"))
        return 0
    finally:
        release_mesh()


if __name__ == "__main__":
    try:
        sys.exit(_rank(sys.argv[1], int(sys.argv[2])))
    except Exception as e:  # noqa: BLE001 — the exit code is the report
        from ..resilience import Preempted

        if isinstance(e, Preempted):
            sys.exit(e.exit_code)
        raise
