"""`cli train gbdt --devices N`: one launcher, N ranks, the whole data.

The reference's one-process mesh of N devices (`jax.process_count() == 1`)
becomes a launcher process and N rank processes, one a device:

  1. the launcher parses the data once (GBDTIngest.load, the native parser
     unless a hook or a delimiter sends it to the Python one) and, for the
     device engine, builds the bins once over every row (build_bins on the
     host, the reference's choice for a mesh, trainer.py:445-454) and the
     EFB plan;
  2. it writes the parsed arrays (.npy) and the bins and plan (pickle) into
     a temporary directory, picks the backend (parallel.mesh.
     choose_backend: NCCL when every rank has a GPU of its own, gloo on the
     CPU and when ranks share a card) and a rendezvous file there (no
     port to race for);
  3. it starts `python -m ytklearn_tpu_torch.gbdt.launch <dir> <rank>` for
     each rank. A rank joins the group, memory-maps the arrays, takes its
     contiguous row shard, bins it on its device and trains
     (GBDTTrainer(mesh=...)); rank 0 dumps;
  4. it waits for every rank (the first that fails stops the others), and
     returns rank 0's result with every rank's report: its device, the
     backend, its kernel launch counts (`<wrapper>.launches`), its
     collective census and its seconds.

A rank's error goes to the launcher's stderr; a preempted rank's exit code
(128 + signum) is the launcher's when every rank exits with it.
"""

from __future__ import annotations

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
from typing import Dict, List

import numpy as np

log = logging.getLogger("ytklearn_tpu_torch.gbdt.launch")

#: seconds between polls of the rank processes
POLL_S = 0.2


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _save(dirpath: str, name: str, arr) -> None:
    a = arr.detach().cpu().numpy() if hasattr(arr, "detach") else arr
    np.save(os.path.join(dirpath, f"{name}.npy"), np.ascontiguousarray(a))


def _prepare(dirpath: str, cfg: dict, hook, hist_precision: str) -> dict:
    """Parse and bin once; write what the ranks read. Returns the meta."""
    import torch

    from ..config import knobs
    from ..config.params import GBDTParams
    from ..io.fs import create_filesystem
    from .binning import build_bins, build_bundle_plan
    from .data import GBDTIngest
    from .trainer import GBDTTrainer

    p = GBDTParams.from_config(cfg)
    fs = create_filesystem(str(cfg.get("fs_scheme", "local")))
    t0 = time.perf_counter()
    ingest = GBDTIngest(p, fs, transform_hook=hook)
    train, test = ingest.load()
    t_load = time.perf_counter() - t0
    # the trainer's own engine rule (precise LAD and the feature maker go
    # to the host engine, which bins on every rank)
    engine = GBDTTrainer(p, device="cpu").engine
    bins = plan = None
    t0 = time.perf_counter()
    if engine == "device":
        X = np.asarray(train.X)
        w = np.ascontiguousarray(np.asarray(train.weight), np.float32)
        bins = build_bins(X, w, p, train.feature_names)
        if knobs.get_bool("YTK_EFB"):
            B = max(8, 1 << (bins.max_bins - 1).bit_length())
            plan = build_bundle_plan(
                torch.from_numpy(np.ascontiguousarray(X.T)), bins,
                knobs.get_int("YTK_EFB_CONFLICT"), B)
    t_bins = time.perf_counter() - t0
    for split, d in (("train", train), ("test", test)):
        if d is None:
            continue
        _save(dirpath, f"{split}_X", d.X)
        _save(dirpath, f"{split}_y", d.y)
        _save(dirpath, f"{split}_w", d.weight)
    meta = {
        "cfg": cfg, "hist_precision": hist_precision, "engine": engine,
        "bins": bins, "plan": plan, "names": train.feature_names,
        "fill": train.missing_fill, "n_real": train.n_real,
        "test_n_real": None if test is None else test.n_real,
        "parser": ingest.parser, "load_s": t_load, "bins_s": t_bins,
    }
    with open(os.path.join(dirpath, "meta.pkl"), "wb") as f:
        pickle.dump(meta, f)
    return meta


def run_devices(cfg: dict, devices: List[str], hook=None,
                hist_precision: str = "bf16") -> dict:
    """Train `cfg`'s GBDT on len(devices) ranks (devices[r] is rank r's):
    rank 0's result dict plus "ranks", every rank's report."""
    from ..parallel.mesh import choose_backend

    import torch

    world = len(devices)
    backend = choose_backend([torch.device(d) for d in devices])
    dirpath = tempfile.mkdtemp(prefix="ytk_devices_")
    try:
        meta = _prepare(dirpath, cfg, hook, hist_precision)
        spec = {"devices": list(devices), "backend": backend,
                "addr": f"file://{os.path.join(dirpath, 'rendezvous')}",
                "world": world}
        with open(os.path.join(dirpath, "spec.json"), "w") as f:
            json.dump(spec, f)
        log.info("--devices %d: %s ranks on %s over %s; parsed %d rows "
                 "(%s parser) in %.3f s, bins in %.3f s", world, world,
                 ",".join(devices), backend, meta["n_real"], meta["parser"],
                 meta["load_s"], meta["bins_s"])
        procs = [subprocess.Popen(
            [sys.executable, "-m", "ytklearn_tpu_torch.gbdt.launch", dirpath,
             str(r)], env=dict(os.environ)) for r in range(world)]
        rcs = _wait(procs)
        if any(rcs):
            codes = set(rcs)
            if len(codes) == 1 and next(iter(codes)) > 128:
                from ..resilience import Preempted

                raise Preempted(next(iter(codes)) - 128,
                                str(meta["cfg"].get("model", {}).get(
                                    "data_path", "")))
            raise RuntimeError(f"--devices {world}: rank exit codes {rcs}")
        reports = []
        for r in range(world):
            with open(os.path.join(dirpath, f"rank{r}.json")) as f:
                reports.append(json.load(f))
        out = dict(reports[0].pop("result"))
        for rep in reports:
            rep.pop("result", None)
        out["parser"] = meta["parser"]
        out["ranks"] = reports
        return out
    finally:
        shutil.rmtree(dirpath, ignore_errors=True)


def _wait(procs) -> List[int]:
    """Every rank's exit code; the first failure stops the rest, since its
    peers would wait in a collective until the group's timeout."""
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


def rank_report(trainer, mesh, seconds: float) -> Dict:
    """A rank's device, backend, kernel launches, collective census and
    seconds."""
    from ..obs import collective_census
    from . import engine, hist, route

    return {
        "rank": mesh.rank, "device": str(mesh.device),
        "backend": mesh.backend, "engine": trainer.engine,
        "launches": {
            "hist": hist.hist_wave.launches,
            "hist_gather": hist.hist_wave_gather_mxu.launches,
            "hist_q": hist.hist_wave_q.launches,
            "hist_gather_q": hist.hist_wave_gather.launches,
            "route": route.route_wave.launches,
            "host_syncs": engine.grow.host_syncs,
        },
        "collectives": collective_census(),
        "seconds": seconds,
    }


def _worker(dirpath: str, rank: int) -> int:
    """One rank: join the group, read the shared arrays, train."""
    from ..cli import _setup_logging
    from ..config.params import GBDTParams
    from ..io.fs import create_filesystem
    from ..parallel.mesh import distributed_initialize_if_needed, \
        make_mesh, release_mesh
    from .data import GBDTData
    from .trainer import GBDTTrainer

    _setup_logging(False)
    with open(os.path.join(dirpath, "spec.json")) as f:
        spec = json.load(f)
    with open(os.path.join(dirpath, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    device = spec["devices"][rank]
    distributed_initialize_if_needed(coordinator=spec["addr"],
                                     world_size=spec["world"], rank=rank,
                                     device=device, backend=spec["backend"])
    try:
        mesh = make_mesh(device, shared_ingest=True)

        def load(split, n_real):
            if n_real is None:
                return None

            def arr(k):
                return np.load(os.path.join(dirpath, f"{split}_{k}.npy"),
                               mmap_mode="r")

            return GBDTData(X=arr("X"), y=np.asarray(arr("y")),
                            weight=np.asarray(arr("w")), n_real=n_real,
                            feature_names=meta["names"],
                            missing_fill=meta["fill"])

        train = load("train", meta["n_real"])
        test = load("test", meta["test_n_real"])
        cfg = meta["cfg"]
        trainer = GBDTTrainer(
            GBDTParams.from_config(cfg), device=device,
            fs=create_filesystem(str(cfg.get("fs_scheme", "local"))),
            mesh=mesh, hist_precision=meta["hist_precision"],
            engine=meta["engine"])
        if meta["bins"] is not None:
            trainer.shared_prep = (meta["bins"], meta["plan"])
        t0 = time.perf_counter()
        res = trainer.train(train=train, test=test)
        report = rank_report(trainer, mesh, time.perf_counter() - t0)
        report["result"] = result_record(res)
        tmp = os.path.join(dirpath, f"rank{rank}.json.tmp")
        with open(tmp, "w") as f:
            json.dump(report, f)
        os.replace(tmp, os.path.join(dirpath, f"rank{rank}.json"))
        return 0
    finally:
        release_mesh()


def result_record(res) -> dict:
    """The JSON line `cli train gbdt` prints for a GBDTResult."""
    return {
        "model": "gbdt",
        "trees": len(res.model.trees),
        "train_loss": res.train_loss,
        "test_loss": res.test_loss,
        "train_metrics": res.train_metrics,
        "test_metrics": res.test_metrics,
    }


if __name__ == "__main__":
    try:
        sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
    except Exception as e:  # noqa: BLE001 — the exit code is the report
        from ..resilience import Preempted

        if isinstance(e, Preempted):
            sys.exit(e.exit_code)
        raise
