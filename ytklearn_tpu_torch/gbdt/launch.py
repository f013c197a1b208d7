"""`cli train gbdt --devices N`: GBDT's two steps on the launcher of
parallel/launch.py (one launcher, N ranks, the whole data).

  prepare    the launcher parses the data once (GBDTIngest.load, the
             native parser unless a hook or a delimiter sends it to the
             Python one) and, for the device engine, builds the bins once
             over every row (build_bins on the host, the reference's
             choice for a mesh, trainer.py:445-454) and the EFB plan; it
             writes the parsed arrays (.npy) and the bins and plan
             (pickle) for the ranks
  rank_main  a rank memory-maps the arrays, takes its contiguous row
             shard, bins it on its device and trains
             (GBDTTrainer(mesh=...)); rank 0 dumps. Its report adds the
             engine and its kernel launch counts (`<wrapper>.launches`)
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List

import numpy as np

from ..parallel.launch import free_port, load_meta, run_ranks, save_meta

__all__ = ["free_port", "rank_main", "rank_report", "result_record",
           "run_devices"]

log = logging.getLogger("ytklearn_tpu_torch.gbdt.launch")


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
        "data_path": p.model.data_path,
    }
    save_meta(dirpath, meta)
    log.info("--devices: parsed %d rows (%s parser) in %.3f s, bins in "
             "%.3f s", train.n_real, ingest.parser, t_load, t_bins)
    return meta


def run_devices(cfg: dict, devices: List[str], hook=None,
                hist_precision: str = "bf16") -> dict:
    """Train `cfg`'s GBDT on len(devices) ranks (devices[r] is rank r's):
    rank 0's result dict plus "parser" and "ranks", every rank's report."""
    out, meta = run_ranks(
        "gbdt", devices,
        lambda d: _prepare(d, cfg, hook, hist_precision))
    out["parser"] = meta["parser"]
    return out


def rank_report(trainer, mesh, seconds: float, **extra) -> Dict:
    """A rank's report (parallel.launch.rank_report) with the engine and
    the kernel launch counts."""
    from ..parallel.launch import rank_report as base_report
    from . import engine, hist, route

    return base_report(mesh, seconds, engine=trainer.engine, launches={
        "hist": hist.hist_wave.launches,
        "hist_gather": hist.hist_wave_gather_mxu.launches,
        "hist_q": hist.hist_wave_q.launches,
        "hist_gather_q": hist.hist_wave_gather.launches,
        "route": route.route_wave.launches,
        "host_syncs": engine.grow.host_syncs,
    }, **extra)


def rank_main(dirpath: str, mesh) -> Dict:
    """One rank: read the shared arrays, train."""
    from ..config.params import GBDTParams
    from ..io.fs import create_filesystem
    from .data import GBDTData
    from .trainer import GBDTTrainer

    meta = load_meta(dirpath)

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
        GBDTParams.from_config(cfg), device=mesh.device,
        fs=create_filesystem(str(cfg.get("fs_scheme", "local"))),
        mesh=mesh, hist_precision=meta["hist_precision"],
        engine=meta["engine"])
    if meta["bins"] is not None:
        trainer.shared_prep = (meta["bins"], meta["plan"])
    t0 = time.perf_counter()
    res = trainer.train(train=train, test=test)
    return rank_report(trainer, mesh, time.perf_counter() - t0,
                       result=result_record(res))


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
