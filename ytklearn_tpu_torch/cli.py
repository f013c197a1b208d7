"""Command-line entry points of the port.

  python -m ytklearn_tpu_torch.cli train <model_name> <config_path> [options]
  python -m ytklearn_tpu_torch.cli retrain <model_name> <config_path> [options]
  python -m ytklearn_tpu_torch.cli predict <config_path> <model_name> <file_dir>
  python -m ytklearn_tpu_torch.cli convert <mode> <input_path> <output_path>
  python -m ytklearn_tpu_torch.cli serve <config_path> <model_name> [options]

`train` is the reference's bin/local_optimizer.sh: it parses the HOCON
config (with `--set key=value` overrides) and trains on `--device`
(default `cuda`), optionally through a python `--transform` line hook.
`gbdt` loads data.train/test through GBDTIngest (the native C++ parser
unless YTK_NO_NATIVE, a transform hook or a multi-char delimiter sends it
to the Python one), trains with the JAX CLI's defaults (bf16 histograms;
every scalar loss, softmax with K trees a round, l1 with the approximate
LAD refine, any feature.approximate spec, model.continue_train), dumps the
model, its `.bins.json` sidecar and the feature importance file, and
prints one JSON line (model, trees, train/test loss and metrics). `linear`, `multiclass_linear`, `fm` and
`ffm` train through HoagTrainer (L-BFGS/OWL-QN, grid and HOAG rounds),
dump the model text and print one JSON line (model, n_iter, status,
avg_loss, test_loss, train/test metrics). `gbmlr`, `gbsdt`, `gbhmlr` and
`gbhsdt` load through DataIngest and train through GBSTTrainer (one L-BFGS
fit a tree, gradient_boosting or random_forest, continue_train from the
tree dumps), dump each tree and print one JSON line (model, trees,
train/test loss and metrics). `--resume auto` sets model.continue_train
when model.data_path holds a dump (the atomic dumps make it the newest
complete checkpoint) and cold-starts otherwise; `--max-restarts N`
re-enters training with continue_train after a failed attempt, up to N
times. A preempted run (SIGTERM/SIGINT, deferred to the trainer's next
boundary, which dumps first) exits 128 + signum and is never retried; a
CUDA error that poisons the process's context (an illegal address, a
device-side assert) is re-raised at once, since an in-process restart
could only fail again. `--trace-out T` writes a Chrome-trace/Perfetto
JSON of the run's obs spans; `--profile [DIR]` arms the profiling plane
(obs/profiler.py: phase accounting, the build ledger, memory watermarks),
logs its report at the end and, with DIR, captures a torch.profiler trace
of each capture phase (the GBDT rounds, the L-BFGS iterations) into DIR
and writes the report there as `ytkprof.json`. `--hist-precision` picks
the GBDT histograms (bf16, the default as in the JAX CLI; f32; int8).

Every family trains on more than one device in the reference's two
modes, one rank a process and a device:
  `--devices N` (N > 1): one launcher parses (and for GBDT bins) the whole
    data once and starts N ranks on cuda:0..N-1 (`--device cpu`: N gloo
    ranks on the CPU; `--rank-devices D0,D1,...` places them, two ranks
    may share a card); each trains on its contiguous row shard and rank 0
    dumps (parallel/launch.py with gbdt/launch.py or train_launch.py).
    The JSON line adds "ranks": each rank's device, backend, collective
    census, health sentinel counts and seconds (GBDT: also its engine and
    kernel launches). Fewer GPUs than N exits as the reference does.
  `--coordinator host:port --num-processes P --process-id r`: this process
    is rank r of P, reads its line shard (io/reader.py::shard_plan), merges
    the feature dict and transform statistics (GBDT: also bins and fills)
    with the others, and trains; rank 0 dumps; `--max-restarts` is off
    (restart the whole launch). The JSON line adds "rank", this rank's
    report.
The backend is NCCL when every rank has a GPU of its own, gloo on the CPU
and when ranks share a card, with a finite timeout
(parallel/mesh.py::TIMEOUT_S).

`serve` is the JAX package's single-process `cli serve` at its defaults:
it loads any family `train` writes (and every `--extra-model`) into a
ModelRegistry on `--device` (default `cuda`), warms every ladder rung,
starts the model-file watcher (hot reload every YTK_SERVE_WATCH_S = 5 s),
starts the HTTP app with the AIMD batch-size controller (YTK_SERVE_SLO_MS
= 100), the SLO burn sentinel, the drift monitor (YTK_QUALITY_SAMPLE =
0.05), request trace sampling (YTK_TRACE_SAMPLE = 0.01), /metrics,
/admin/{traces,rollback,pin,unpin} and 429 with Retry-After, and prints
one JSON banner line with the bound port, `wall_t0` and the rung (its
precision: YTK_SERVE_PRECISION) on stdout. SIGTERM drains and exits 0.
`--replicas N` (or a `--replicas-min`/`--replicas-max` band) starts the
fleet instead: a front process that spawns N replica workers, each this
single-process server on `--device` (`python -m ytklearn_tpu_torch.cli
serve ... --replicas 0 --device D --replica-id I`), balances requests on
least-queued rows, reroutes around and restarts dead replicas, fans
/admin/* out, merges /metrics, and autoscales within the band
(serve/fleet/). Its banner names `fleet`, `replicas`, `replica_ports` and
`wall_t0`; with YTK_OBS=1 it dumps its flight ring (the replicas' deaths,
restarts and scale decisions) into YTK_FLIGHT_DIR at SIGTERM. YTK_PROF=1
arms the profiling plane in the server (and, through the environment, in
every replica): `/metrics?prof=1` then answers each rung's settled
execute time and rows, the build ledger and the phases.

`retrain` is the continual-training driver (continual/): it warm-starts a
candidate on `--data` in a shadow path on `--device` (default `cuda`),
gates it on the health sentinels and the held-out loss over `--test`
against the serving incumbent, promotes it atomically on a pass (the
serving watcher swaps it in), and prints one JSON record; `--rollback`
restores the newest archive; `--mode ftrl` streams one FTRL-proximal pass
(convex families). `--devices N` (with `--rank-devices`) trains the
candidate on N ranks through the `train` launcher; the lock, the gates,
promotion and rollback stay in the retrain process on `--device`, and
`--mode ftrl` runs in it on one device whatever `--devices` says. A
strict rejection (YTK_CONTINUAL_STRICT=1) exits 1.
`predict` is the offline batch predictor (bin/predict.sh, Predicts.java):
it writes `<file><suffix>` result files in any save mode and predict type
and prints the weighted average loss; the activation and the loss run on
`--device` (default `cuda`). `convert` is bin/libsvm_convert_2_ytklearn.sh
(io/libsvm.py). Both take `--trace-out T` (a Chrome trace of the run).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time
from typing import List, Optional, Tuple

MODEL_NAMES = (
    "linear",
    "multiclass_linear",
    "fm",
    "ffm",
    "gbmlr",
    "gbsdt",
    "gbhmlr",
    "gbhsdt",
    "gbdt",
)
#: registry name of the served model (the default target of /predict)
SERVE_NAME = "default"


def _setup_logging(verbose: bool) -> None:
    logging.basicConfig(
        level=logging.DEBUG if verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )


def _apply_overrides(cfg: dict, sets: List[str]) -> dict:
    """--set key=value overrides (reference: TrainWorker.setCustomParam,
    worker/TrainWorker.java:118-131). Values parse as JSON when possible,
    else stay strings."""
    from .config import hocon

    for kv in sets or []:
        key, sep, val = kv.partition("=")
        if not sep:
            raise SystemExit(f"--set expects key=value, got {kv!r}")
        try:
            parsed = json.loads(val)
        except json.JSONDecodeError:
            parsed = val
        cfg = hocon.set_path(cfg, key.strip(), parsed)
    return cfg


#: messages of the CUDA errors that leave the context unusable: every later
#: call in the process fails too, so a restart in the process cannot help
STICKY_CUDA_ERRORS = (
    "illegal memory access",
    "an illegal address",
    "device-side assert",
    "misaligned address",
    "illegal instruction",
    "unspecified launch failure",
    "invalid program counter",
    "hardware stack error",
    "launch timed out",
    "uncorrectable ECC error",
)


def is_sticky_cuda_error(exc: BaseException) -> bool:
    """True for an error whose CUDA context cannot recover in-process."""
    text = str(exc)
    return "CUDA" in text and any(m in text for m in STICKY_CUDA_ERRORS)


def _make_mesh(n_devices: int, device: str,
               rank_devices: str = "") -> Optional[List[str]]:
    """--devices N: the N ranks' devices, or None for one device
    (reference cli.py:73-82). cuda: cuda:0..N-1, and fewer GPUs than N
    exits; cpu: N ranks on the CPU; `rank_devices` (a comma list of N)
    places them, a card may hold more than one rank."""
    if rank_devices:
        devs = [d.strip() for d in rank_devices.split(",") if d.strip()]
        if len(devs) != max(n_devices, 1):
            raise SystemExit(f"--rank-devices names {len(devs)} devices, "
                             f"--devices asks for {n_devices}")
        return devs if len(devs) > 1 else None
    if n_devices <= 1:
        return None
    if device.startswith("cuda"):
        import torch

        avail = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if n_devices > avail:
            raise SystemExit(f"requested {n_devices} devices, only {avail} "
                             "available")
        return [f"cuda:{i}" for i in range(n_devices)]
    if device != "cpu":
        raise SystemExit(f"--devices: unsupported device {device!r}")
    return ["cpu"] * n_devices


def train_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-train",
        description="Train a model on the card from a HOCON config "
        "(reference: bin/local_optimizer.sh + LocalTrainWorker)",
    )
    ap.add_argument("model_name", choices=MODEL_NAMES)
    ap.add_argument("config_path")
    ap.add_argument("--transform", action="store_true",
                    help="enable the python line-transform hook")
    ap.add_argument("--transform-script", default="bin/transform.py")
    ap.add_argument("--device", default="cuda",
                    help="device to train on: cuda (default) or cpu")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to train on, one rank each: a launcher "
                    "parses (GBDT: and bins) once and starts the ranks")
    ap.add_argument("--rank-devices", default="",
                    help="with --devices N: the N ranks' devices, comma "
                    "separated (default cuda:0..N-1, or cpu)")
    ap.add_argument("--hist-precision", default="bf16",
                    choices=("bf16", "f32", "int8"),
                    help="GBDT histogram precision (default bf16)")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="on a failed attempt, restart training in this "
                    "process from the last dump (model.continue_train), "
                    "up to N times")
    ap.add_argument("--resume", default="never", choices=("never", "auto"),
                    help="auto: resume from the dump at model.data_path "
                    "when there is one, else start cold")
    ap.add_argument("--coordinator", default="",
                    help="host:port of the rendezvous of a multi-process "
                    "run (rank 0's process group store; a file:// URL "
                    "serves ranks on one host); use with --num-processes "
                    "and --process-id")
    ap.add_argument("--num-processes", type=int, default=0)
    ap.add_argument("--process-id", type=int, default=-1)
    ap.add_argument("--set", action="append", dest="sets",
                    metavar="KEY=VALUE", help="config override, repeatable")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the run to "
                    "this path (YTK_TRACE=path everywhere else)")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="DIR",
                    help="arm the ytkprof profiling plane: phase and "
                    "device-time accounting, build ledger, memory "
                    "watermarks; with DIR also capture torch.profiler "
                    "traces and write the report (ytkprof.json) into it "
                    "(YTK_PROF everywhere else)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _setup_trace(args.trace_out)
    _setup_profile(args.profile)

    from .config import hocon

    cfg = _apply_overrides(hocon.load(args.config_path), args.sets)
    hook = None
    if args.transform:
        from .io.reader import load_transform_hook

        hook = load_transform_hook(args.transform_script)
    log = logging.getLogger("ytklearn_tpu_torch.cli")
    if args.resume == "auto":
        from .io.fs import create_filesystem

        fs = create_filesystem(str(cfg.get("fs_scheme", "local")))
        path = hocon.get_path(cfg, "model.data_path")
        if path and fs.exists(str(path)):
            cfg = hocon.set_path(cfg, "model.continue_train", True)
            log.info("--resume auto: checkpoint found at %s; resuming", path)
        else:
            log.info("--resume auto: no checkpoint at %s; cold start", path)
    from .resilience import Preempted

    restarts = max(args.max_restarts, 0)
    ranks = _make_mesh(args.devices, args.device, args.rank_devices)
    mesh = None
    if args.coordinator:
        if ranks is not None:
            raise SystemExit("--coordinator runs one rank a process: drop "
                             "--devices/--rank-devices")
        from .parallel.mesh import distributed_initialize_if_needed, \
            make_mesh, rank_device

        distributed_initialize_if_needed(
            coordinator=args.coordinator, world_size=args.num_processes,
            rank=args.process_id, device=args.device)
        mesh = make_mesh(rank_device(args.device, args.process_id,
                                     args.num_processes),
                         shared_ingest=False)
        if restarts and mesh.world > 1:
            # a rank re-entering training alone would desync the group's
            # collectives: recovery restarts the whole launch
            log.warning("--max-restarts is per-process and unsafe in "
                        "multi-process mode; disabled: restart the launcher "
                        "to resume from the last checkpoint")
            restarts = 0
    t0 = time.perf_counter()
    try:
        for attempt in range(restarts + 1):
            try:
                if ranks is not None:
                    rc, wall = _train_devices(args.model_name, cfg, hook,
                                              ranks, args.hist_precision)
                else:
                    rc, wall = _train_once(args.model_name, cfg, hook,
                                           args.device, args.hist_precision,
                                           mesh)
                _flush_trace(args.trace_out)
                _flush_profile(args.profile, wall)
                return rc
            except Preempted as e:
                # not a failure: the checkpoint is on disk, and a restart
                # here would eat the grace period; the relaunch resumes it
                log.warning("%s; exiting %d", e, e.exit_code)
                _flush_trace(args.trace_out)
                _flush_profile(args.profile, time.perf_counter() - t0)
                return e.exit_code
            except KeyboardInterrupt:
                raise
            except Exception as e:
                if attempt >= restarts or is_sticky_cuda_error(e):
                    raise
                log.exception("training attempt %d/%d failed; restarting "
                              "with model.continue_train=true", attempt + 1,
                              restarts + 1)
                cfg = hocon.set_path(cfg, "model.continue_train", True)
    finally:
        if mesh is not None:
            from .parallel.mesh import release_mesh

            release_mesh()
    return 1  # unreachable


def run_devices(name: str, cfg: dict, devices: List[str], hook=None,
                hist_precision: str = "bf16") -> dict:
    """`name` trained on len(devices) ranks by the launcher
    (parallel/launch.py): rank 0's result with every rank's report."""
    if name == "gbdt":
        from .gbdt.launch import run_devices as gbdt_devices

        return gbdt_devices(cfg, devices, hook=hook,
                            hist_precision=hist_precision)
    from .train_launch import run_devices as sparse_devices

    return sparse_devices(name, cfg, devices, hook=hook)


def _train_devices(name: str, cfg: dict, hook, devices: List[str],
                   hist_precision: str) -> Tuple[int, float]:
    """`--devices N`: the launcher and its JSON line."""
    t0 = time.perf_counter()
    out = run_devices(name, cfg, devices, hook=hook,
                      hist_precision=hist_precision)
    wall = time.perf_counter() - t0
    print(json.dumps(out), flush=True)
    return 0, wall


def _train_once(name: str, cfg: dict, hook, device,
                hist_precision: str = "bf16", mesh=None) -> Tuple[int, float]:
    """Train one attempt and print its JSON line: (0, the seconds of the
    trainer's train(), the wall the profiling plane decomposes). `mesh`:
    this process's rank under --coordinator; the line then adds "rank",
    this rank's report."""
    if name != "gbdt":
        from .train_launch import make_trainer, result_record

        trainer = make_trainer(name, cfg, hook, device=device, mesh=mesh)
        t0 = time.perf_counter()
        res = trainer.train()
        wall = time.perf_counter() - t0
        out = result_record(name, res)
        if mesh is not None:
            from .parallel.launch import rank_report

            out["rank"] = rank_report(mesh, wall)
        print(json.dumps(out), flush=True)
        return 0, wall

    from .config.params import GBDTParams
    from .gbdt.launch import rank_report, result_record
    from .gbdt.trainer import GBDTTrainer
    from .io.fs import create_filesystem

    # the trainer loads data.train/test through GBDTIngest and records the
    # parser and the load's seconds in its time_stats
    trainer = GBDTTrainer(GBDTParams.from_config(cfg),
                          device=device if mesh is None else mesh.device,
                          fs=create_filesystem(str(cfg.get("fs_scheme",
                                                           "local"))),
                          transform_hook=hook,
                          hist_precision=hist_precision, mesh=mesh)
    t0 = time.perf_counter()
    res = trainer.train()
    wall = time.perf_counter() - t0
    out = result_record(res)
    if mesh is not None:
        out["rank"] = rank_report(trainer, mesh, wall)
    print(json.dumps(out), flush=True)
    return 0, wall


def predict_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-predict",
        description="Offline batch prediction "
        "(reference: bin/predict.sh + predictor/Predicts.java:36-54)",
    )
    ap.add_argument("config_path")
    ap.add_argument("model_name", choices=MODEL_NAMES)
    ap.add_argument("file_dir", help="file or directory of data to predict")
    ap.add_argument("--transform", action="store_true")
    ap.add_argument("--transform-script", default="bin/transform.py")
    ap.add_argument("--save-mode", default="predict_result_only",
                    choices=("predict_result_only", "label_and_predict",
                             "predict_as_feature"))
    ap.add_argument("--suffix", default="_predict")
    ap.add_argument("--max-error-tol", type=int, default=100)
    ap.add_argument("--eval-metric", default="", help='e.g. "auc,mae"')
    ap.add_argument("--predict-type", default="value",
                    choices=("value", "leafid"))
    ap.add_argument("--set", action="append", dest="sets",
                    metavar="KEY=VALUE")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the batch "
                    "predict to this path")
    ap.add_argument("--device", default="cuda",
                    help="device of the activation and the loss: cuda "
                    "(default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _setup_trace(args.trace_out)

    from .config import hocon
    from .predict import batch_predict_from_files, create_predictor

    cfg = _apply_overrides(hocon.load(args.config_path), args.sets)
    predictor = create_predictor(args.model_name, cfg)
    K = int(cfg.get("k", -1)) if args.model_name == "multiclass_linear" else -1
    avg_loss = batch_predict_from_files(
        predictor,
        args.model_name,
        args.file_dir,
        need_py_transform=args.transform,
        py_transform_script=args.transform_script,
        result_save_mode=args.save_mode,
        result_file_suffix=args.suffix,
        max_error_tol=args.max_error_tol,
        eval_metric_str=args.eval_metric,
        predict_type_str=args.predict_type,
        K=K,
        device=args.device,
    )
    _flush_trace(args.trace_out)
    print(json.dumps({"model": args.model_name, "avg_loss": avg_loss}),
          flush=True)
    return 0


def convert_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-convert",
        description="libsvm -> ytklearn format (reference: "
        "bin/libsvm_convert_2_ytklearn.sh + utils/LibsvmConvertTool.java)",
    )
    ap.add_argument("mode", help='binary_classification@l0,l1 | '
                                 'multi_classification@l0,l1,... | regression')
    ap.add_argument("input_path")
    ap.add_argument("output_path")
    ap.add_argument("--x-delim", default="###")
    ap.add_argument("--y-delim", default=",")
    ap.add_argument("--features-delim", default=",")
    ap.add_argument("--feature-name-val-delim", default=":")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)

    from .io.libsvm import convert_libsvm

    cnt = convert_libsvm(
        args.mode,
        args.input_path,
        args.output_path,
        x_delim=args.x_delim,
        y_delim=args.y_delim,
        features_delim=args.features_delim,
        feature_name_val_delim=args.feature_name_val_delim,
    )
    print(json.dumps({"lines": cnt, "output": args.output_path}), flush=True)
    return 0


def retrain_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-retrain",
        description="Continual training driver: warm-start a candidate on "
        "new data in a shadow path, validate it against the health gates "
        "and a held-out metric band versus the serving incumbent, and "
        "promote it atomically only on a pass; the serving registry's "
        "fingerprint watcher swaps the promoted model in under traffic",
    )
    ap.add_argument("model_name", choices=MODEL_NAMES)
    ap.add_argument("config_path")
    ap.add_argument("--data", default="",
                    help="fresh training data path(s) (comma-separated); "
                    "overrides data.train.data_path")
    ap.add_argument("--test", default="",
                    help="held-out data path(s) for the metric gate; "
                    "overrides data.test.data_path")
    ap.add_argument("--mode", default="", choices=("", "warm", "ftrl"),
                    help="warm = full warm-start refit (default); ftrl = "
                    "one FTRL-proximal online pass (convex families)")
    ap.add_argument("--extra-rounds", type=int, default=-1,
                    help="extra boosting rounds for GBDT/GBST warm starts "
                    "(default: continual.extra_rounds)")
    ap.add_argument("--rollback", action="store_true",
                    help="restore the newest archived version over the "
                    "served path instead of retraining")
    ap.add_argument("--transform", action="store_true",
                    help="enable the python line-transform hook")
    ap.add_argument("--transform-script", default="bin/transform.py")
    ap.add_argument("--device", default="cuda",
                    help="device to train and gate on: cuda (default) or "
                    "cpu")
    ap.add_argument("--devices", type=int, default=0,
                    help="devices to train the candidate on, one rank each "
                    "(the train launcher); --mode ftrl runs in this "
                    "process on one device whatever this says")
    ap.add_argument("--rank-devices", default="",
                    help="with --devices N: the N ranks' devices, comma "
                    "separated (default cuda:0..N-1, or cpu)")
    ap.add_argument("--set", action="append", dest="sets",
                    metavar="KEY=VALUE", help="config override, repeatable")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON of the retrain")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _setup_trace(args.trace_out)

    from .config import hocon
    from .continual import RetrainRejected, retrain, rollback

    cfg = _apply_overrides(hocon.load(args.config_path), args.sets)
    if args.data:
        cfg = hocon.set_path(cfg, "data.train.data_path", args.data)
    if args.test:
        cfg = hocon.set_path(cfg, "data.test.data_path", args.test)

    if args.rollback:
        res = rollback(args.model_name, cfg)
        _flush_trace(args.trace_out)
        print(json.dumps(res.to_json()), flush=True)
        return 0

    hook = None
    if args.transform:
        from .io.reader import load_transform_hook

        hook = load_transform_hook(args.transform_script)
    from .resilience import Preempted

    try:
        res = retrain(
            args.model_name, cfg,
            mode=args.mode or None,
            extra_rounds=args.extra_rounds if args.extra_rounds >= 0 else None,
            transform_hook=hook,
            device=args.device,
            devices=_make_mesh(args.devices, args.device, args.rank_devices),
        )
    except Preempted as e:
        # the candidate's training was preempted: the incumbent keeps
        # serving, the lock is released, and the next run retrains
        logging.getLogger("ytklearn_tpu_torch.cli").warning(
            "%s; exiting %d", e, e.exit_code)
        _flush_trace(args.trace_out)
        return e.exit_code
    except RetrainRejected as e:
        # YTK_CONTINUAL_STRICT=1: a rejection fails the surrounding
        # pipeline, with a clean JSON record on stdout all the same
        print(json.dumps({
            "promoted": False,
            "strict": True,
            "reasons": e.report.reasons,
        }), flush=True)
        _flush_trace(args.trace_out)
        return 1
    _flush_trace(args.trace_out)
    print(json.dumps(res.to_json()), flush=True)
    return 0


def _setup_trace(trace_out: str) -> None:
    """--trace-out: enable obs + register the Chrome-trace export."""
    if trace_out:
        from . import obs

        obs.configure(enabled=True, trace_path=trace_out)


def _flush_trace(trace_out: str) -> None:
    """Write the trace now — *_main may be driven in-process (no atexit)."""
    if trace_out:
        from . import obs

        obs.flush()


def _setup_profile(profile: Optional[str]) -> None:
    """--profile [DIR]: arm the ytkprof profiling plane (phase accounting,
    build ledger, memory-watermark sampler); with DIR, also capture
    torch.profiler traces per capture phase into it (YTK_PROF everywhere
    else)."""
    if profile is None:
        return
    from .obs import profiler

    if profile:
        profiler.configure_profiler(on=True, capture_dir=profile)
    else:
        profiler.configure_profiler(on=True)


def _flush_profile(profile: Optional[str], wall_s: float) -> None:
    """--profile: log the plane's report over `wall_s` (the trainer's
    train(), or the attempt's wall at a preemption); with DIR also write it
    there as ytkprof.json."""
    if profile is None:
        return
    from .obs import profiler

    rep = profiler.report(wall_s=wall_s)
    logging.getLogger("ytklearn_tpu_torch.cli").info(
        "ytkprof report:\n%s", profiler.format_report(rep))
    if profile:
        os.makedirs(profile, exist_ok=True)
        with open(os.path.join(profile, "ytkprof.json"), "w") as f:
            json.dump(rep, f, indent=1)


def serve_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-serve",
        description="Online prediction server: batch scorer with a padded "
        "shape ladder, dynamic micro-batching with backpressure and AIMD "
        "batch sizing, and fingerprint-watch hot model reload",
    )
    ap.add_argument("config_path")
    ap.add_argument("model_name", choices=MODEL_NAMES)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080,
                    help="listen port (0 picks an ephemeral port)")
    ap.add_argument("--name", default=SERVE_NAME,
                    help="registry name for this model (the default target "
                    "of /predict requests without a \"model\" field)")
    ap.add_argument("--extra-model", action="append", default=[],
                    metavar="NAME:MODEL_NAME:CONFIG_PATH",
                    help="load an additional model into the registry "
                    "(repeatable); requests address it via the \"model\" "
                    "field")
    ap.add_argument("--ladder", default="",
                    help='batch-shape ladder, e.g. "1,8,64,512" (default; '
                    "env YTK_SERVE_LADDER); every rung is warmed at load")
    ap.add_argument("--max-batch", type=int, default=512,
                    help="max rows coalesced into one scorer call")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch straggler wait after the first request")
    ap.add_argument("--max-queue", type=int, default=2048,
                    help="pending-request bound; beyond it requests are shed "
                    "with a typed 429")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="default per-request deadline (0 = none); expired "
                    "requests fail with 504 before wasting scorer time")
    ap.add_argument("--watch-interval", type=float, default=None,
                    help="model-file fingerprint poll seconds for hot reload "
                    "(default 5; 0 disables; env YTK_SERVE_WATCH_S)")
    ap.add_argument("--replicas", type=int, default=None,
                    help="serving fleet size: N > 0 starts a front process "
                    "owning N replica workers on --device; 0 serves in "
                    "this process; -1 one replica per GPU (cuda) or per "
                    "two cores (cpu) (env YTK_SERVE_REPLICAS)")
    ap.add_argument("--replicas-min", type=int, default=None,
                    help="fleet autoscaler floor (default: --replicas; env "
                    "YTK_SERVE_REPLICAS_MIN)")
    ap.add_argument("--replicas-max", type=int, default=None,
                    help="fleet autoscaler ceiling; above the floor it arms "
                    "load-driven autoscaling (default: --replicas, a fixed "
                    "fleet; env YTK_SERVE_REPLICAS_MAX)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="p99 latency SLO in ms for the AIMD batch-size "
                    "controller (0 disables AIMD and restores the fixed "
                    "--max-batch/--max-wait-ms; env YTK_SERVE_SLO_MS, "
                    "default 100)")
    ap.add_argument("--cache-rows", type=int, default=None,
                    help="bounded LRU prediction-cache rows, keyed on "
                    "(model fingerprint, feature row); 0 disables (env "
                    "YTK_SERVE_CACHE_ROWS)")
    ap.add_argument("--replica-id", type=int, default=None,
                    help="this process is replica N (stamps obs identity "
                    "for postmortems)")
    ap.add_argument("--set", action="append", dest="sets",
                    metavar="KEY=VALUE", help="config override, repeatable")
    ap.add_argument("--trace-out", default="",
                    help="write a Chrome-trace/Perfetto JSON at shutdown")
    ap.add_argument("--device", default="cuda",
                    help="device to score on: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)

    from .config import knobs

    replicas = (args.replicas if args.replicas is not None
                else knobs.get_int("YTK_SERVE_REPLICAS"))
    slo_ms = (args.slo_ms if args.slo_ms is not None
              else knobs.get_float("YTK_SERVE_SLO_MS"))
    cache_rows = (args.cache_rows if args.cache_rows is not None
                  else knobs.get_int("YTK_SERVE_CACHE_ROWS"))
    # autoscaling band (0 / unset = follow --replicas = fixed fleet); a
    # band alone is enough to go fleet mode: `--replicas-max 4` on a
    # default single-process invocation serves one replica that can grow
    r_min = (args.replicas_min if args.replicas_min is not None
             else knobs.get_int("YTK_SERVE_REPLICAS_MIN")) or 0
    r_max = (args.replicas_max if args.replicas_max is not None
             else knobs.get_int("YTK_SERVE_REPLICAS_MAX")) or 0
    _setup_trace(args.trace_out)
    if replicas != 0 or r_max > 0 or r_min > 0:
        return _serve_fleet_main(args, replicas, slo_ms, cache_rows,
                                 r_min, r_max)

    from . import obs
    from .config import hocon
    from .serve import BatchPolicy, ModelRegistry, ServeApp, parse_ladder

    if args.replica_id is not None:
        # every obs event / flight dump / metrics scrape from this process
        # names its replica
        obs.set_identity(replica_id=args.replica_id)

    cfg = _apply_overrides(hocon.load(args.config_path), args.sets)
    ladder = parse_ladder(args.ladder) if args.ladder else None
    registry = ModelRegistry(ladder=ladder,
                             watch_interval_s=args.watch_interval,
                             device=args.device)
    registry.load(args.name, args.model_name, cfg)
    for spec in args.extra_model:
        try:
            xname, xmodel, xconf = spec.split(":", 2)
        except ValueError:
            ap.error(f"--extra-model {spec!r}: expected "
                     "NAME:MODEL_NAME:CONFIG_PATH")
        if xmodel not in MODEL_NAMES:
            ap.error(f"--extra-model {spec!r}: unknown model family "
                     f"{xmodel!r} (choices: {', '.join(MODEL_NAMES)})")
        registry.load(xname, xmodel,
                      _apply_overrides(hocon.load(xconf), args.sets))
    registry.start_watching()
    policy = BatchPolicy(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
        default_deadline_ms=args.deadline_ms,
    )
    app = ServeApp(
        registry, policy, host=args.host, port=args.port,
        slo_ms=slo_ms, cache_rows=cache_rows, replica_id=args.replica_id,
    ).start()
    app.install_signal_handlers()
    scorer = registry.get(args.name).scorer
    print(json.dumps({
        "serving": args.name,
        "model": args.model_name,
        "host": args.host,
        "port": app.port,
        "replica_id": args.replica_id,
        "ladder": list(scorer.ladder),
        # this process's obs clock origin on the wall clock: trace hop
        # offsets + wall_t0 align across processes (obs/trace.py)
        "wall_t0": obs.core.WALL_T0,
        "rung": scorer.rung_info(),
    }), flush=True)
    try:
        while app._serve_thread is not None and app._serve_thread.is_alive():
            app._serve_thread.join(timeout=1.0)
        # the listener stops before the drain closes the models: exit only
        # after it (an interpreter torn down under the drain's torch work
        # aborts the process)
        if app._drain_thread is not None:
            app._drain_thread.join()
    except KeyboardInterrupt:
        app.stop(drain=True)
    _flush_trace(args.trace_out)
    return 0


def _serve_fleet_main(args, replicas: int, slo_ms, cache_rows,
                      r_min: int = 0, r_max: int = 0) -> int:
    """`serve --replicas N`: a front process owning N worker subprocesses,
    each the port's single-process `cli serve` on `--device`."""
    from . import obs
    from .device import resolve_device
    from .serve import (
        BatchPolicy,
        FleetFront,
        default_replica_count,
        serve_worker_argv,
    )

    # `cuda` with no GPU raises here, before any replica is spawned: no
    # replica ever serves on the CPU unless --device cpu asks for it
    resolve_device(args.device)
    if replicas < 0:
        replicas = default_replica_count(args.device)
    if replicas == 0:
        # reached via a bare autoscaling band (--replicas-max without
        # --replicas): start at the floor and let load grow the fleet
        replicas = max(1, r_min)
    worker_flags = []
    for flag, val in (
        ("--name", args.name),
        ("--ladder", args.ladder),
        ("--max-batch", args.max_batch),
        ("--max-wait-ms", args.max_wait_ms),
        ("--max-queue", args.max_queue),
        ("--deadline-ms", args.deadline_ms),
        ("--watch-interval", args.watch_interval),
        ("--slo-ms", slo_ms),
        ("--cache-rows", cache_rows),
    ):
        if val not in (None, ""):
            worker_flags += [flag, str(val)]
    for s in args.sets or []:
        worker_flags += ["--set", s]
    for spec in args.extra_model or []:
        # every replica serves the full model set (shared-nothing fleet:
        # any replica can answer any named-model request)
        worker_flags += ["--extra-model", spec]
    if args.verbose:
        worker_flags.append("--verbose")
    front = FleetFront(
        serve_worker_argv(args.config_path, args.model_name, worker_flags,
                          device=args.device),
        replicas,
        policy=BatchPolicy(
            max_batch=args.max_batch,
            max_wait_ms=min(args.max_wait_ms, 1.0),
            max_queue=args.max_queue,
            default_deadline_ms=args.deadline_ms,
        ),
        host=args.host,
        port=args.port,
        slo_ms=slo_ms,
        replicas_min=(r_min or None),
        replicas_max=(r_max or None),
    )
    front.start().serve_http()
    front.install_signal_handlers()
    # with obs on, the front keeps the flight ring (the serve.worker.* and
    # serve.scale.* evidence of its replicas) and dumps it at SIGTERM
    # before its own drain runs: installed after the drain handler, the
    # recorder's handler chains to it, as in a trainer's guard
    obs.recorder.auto_install()
    print(json.dumps({
        "serving": args.name,
        "model": args.model_name,
        "host": args.host,
        "port": front.port,
        "device": args.device,
        "replicas": front.n_replicas,
        "replicas_min": front.replicas_min,
        "replicas_max": front.replicas_max,
        "autoscale": front.autoscaler is not None,
        "fleet": True,
        "replica_ports": {
            str(rid): h.port for rid, h in sorted(front.handles.items())
        },
        "wall_t0": obs.core.WALL_T0,
    }), flush=True)
    try:
        while (front._serve_thread is not None
               and front._serve_thread.is_alive()):
            front._serve_thread.join(timeout=1.0)
    except KeyboardInterrupt:
        front.stop(drain=True)
    _flush_trace(args.trace_out)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m ytklearn_tpu_torch.cli "
              "{train,retrain,predict,convert,serve} ...")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    commands = {"train": train_main, "retrain": retrain_main,
                "predict": predict_main, "convert": convert_main,
                "serve": serve_main}
    if cmd not in commands:
        print(f"unknown command {cmd!r}; expected "
              "train|retrain|predict|convert|serve", file=sys.stderr)
        return 2
    return commands[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
