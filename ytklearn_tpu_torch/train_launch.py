"""`cli train <convex or GBST family> --devices N`: the DataIngest
families' two steps on the launcher of parallel/launch.py (one launcher,
N ranks, the whole data).

  prepare    the launcher parses the text once (DataIngest.load with the
             family's label width and FFM's field map) and writes the
             SparseDataset fields of both splits (`idx`, `val`, `y`,
             `weight`, `field`) as .npy, and `n_real`, `dim`, the feature
             map, the transform nodes and the field map as a pickle
  rank_main  a rank memory-maps the arrays into the IngestResult of the
             whole data and trains it with its mesh (HoagTrainer or
             GBSTTrainer): the trainer takes the rank's contiguous row
             block (SparseDataset.shard), the reference's one-process
             mesh; rank 0 dumps
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np

from .models.gbst import GBST_NAMES
from .parallel.launch import load_meta, rank_report, run_ranks, save_meta

log = logging.getLogger("ytklearn_tpu_torch.train_launch")

_FIELDS = ("idx", "val", "y", "weight", "field")


def make_trainer(name: str, cfg: dict, hook=None, device=None, mesh=None):
    """The family's trainer on `device` (or this rank's device of
    `mesh`)."""
    from .config.params import CommonParams
    from .io.fs import create_filesystem

    p = CommonParams.from_config(cfg)
    fs = create_filesystem(str(cfg.get("fs_scheme", "local")))
    if name in GBST_NAMES:
        from .boost import GBSTTrainer

        return GBSTTrainer(p, name, fs=fs, transform_hook=hook,
                           device=device, mesh=mesh)
    from .train import HoagTrainer

    return HoagTrainer(p, name, fs=fs, transform_hook=hook, device=device,
                       mesh=mesh)


def result_record(name: str, res) -> dict:
    """The JSON line `cli train <name>` prints for a TrainResult or a
    BoostResult."""
    if name in GBST_NAMES:
        return {"model": name, "trees": res.n_trees,
                "train_loss": res.train_loss, "test_loss": res.test_loss,
                "train_metrics": res.train_metrics,
                "test_metrics": res.test_metrics}
    return {"model": name, "n_iter": res.n_iter, "status": res.status,
            "avg_loss": res.avg_loss, "test_loss": res.test_loss,
            "train_metrics": res.train_metrics,
            "test_metrics": res.test_metrics}


def ingest(name: str, cfg: dict, hook=None):
    """The family's ingest of the whole data on the host (HoagTrainer's
    `_ingest`: the label width and FFM's field map; GBST's plain one)."""
    if name in GBST_NAMES:
        from .config.params import CommonParams
        from .io.fs import create_filesystem
        from .io.reader import DataIngest

        return DataIngest(CommonParams.from_config(cfg),
                          fs=create_filesystem(str(cfg.get("fs_scheme",
                                                           "local"))),
                          transform_hook=hook).load(), None
    trainer = make_trainer(name, cfg, hook, device="cpu")
    res = trainer._ingest()
    return res, (trainer._fields() if name == "ffm" else None)


def _prepare(dirpath: str, name: str, cfg: dict, hook) -> dict:
    t0 = time.perf_counter()
    res, field_map = ingest(name, cfg, hook)
    splits = {}
    for split, ds in (("train", res.train), ("test", res.test)):
        if ds is None:
            continue
        for k in _FIELDS:
            a = getattr(ds, k)
            if a is not None:
                np.save(os.path.join(dirpath, f"{split}_{k}.npy"),
                        np.ascontiguousarray(a))
        splits[split] = {"n_real": ds.n_real, "dim": ds.dim,
                         "field": ds.field is not None}
    meta = {"name": name, "cfg": cfg, "splits": splits,
            "feature_map": res.feature_map,
            "transform_nodes": res.transform_nodes,
            "y_real_stat": res.y_real_stat,
            "y_weight_stat": res.y_weight_stat, "parser": res.parser,
            "field_map": field_map,
            "data_path": str(cfg.get("model", {}).get("data_path", ""))}
    save_meta(dirpath, meta)
    log.info("--devices: parsed %d rows (%s parser) in %.3f s",
             res.train.n_real, res.parser, time.perf_counter() - t0)
    return meta


def run_devices(name: str, cfg: dict, devices: List[str],
                hook=None) -> dict:
    """Train `cfg`'s `name` model on len(devices) ranks (devices[r] is
    rank r's): rank 0's result dict plus "parser" and "ranks", every
    rank's report."""
    out, meta = run_ranks("sparse", devices,
                          lambda d: _prepare(d, name, cfg, hook))
    out["parser"] = meta["parser"]
    return out


def _load_split(dirpath: str, split: str, info: Optional[dict]):
    from .io.reader import SparseDataset

    if info is None:
        return None

    def arr(k):
        return np.load(os.path.join(dirpath, f"{split}_{k}.npy"),
                       mmap_mode="r")

    return SparseDataset(idx=arr("idx"), val=arr("val"), y=arr("y"),
                         weight=arr("weight"), n_real=info["n_real"],
                         dim=info["dim"],
                         field=arr("field") if info["field"] else None)


def rank_main(dirpath: str, mesh) -> Dict:
    """One rank: the whole data's IngestResult from the shared arrays,
    trained on this rank's rows."""
    from .io.reader import IngestResult

    meta = load_meta(dirpath)
    splits = meta["splits"]
    res_in = IngestResult(
        train=_load_split(dirpath, "train", splits.get("train")),
        test=_load_split(dirpath, "test", splits.get("test")),
        feature_map=meta["feature_map"],
        transform_nodes=meta["transform_nodes"],
        y_real_stat=meta["y_real_stat"],
        y_weight_stat=meta["y_weight_stat"], parser=meta["parser"])
    name = meta["name"]
    trainer = make_trainer(name, meta["cfg"], mesh=mesh)
    if meta["field_map"] is not None:
        trainer._field_map = meta["field_map"]
    t0 = time.perf_counter()
    res = trainer.train(ingest=res_in)
    return rank_report(mesh, time.perf_counter() - t0,
                       result=result_record(name, res))
