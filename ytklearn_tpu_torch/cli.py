"""Command-line entry points of the port.

  python -m ytklearn_tpu_torch.cli train <model_name> <config_path> [options]
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
could only fail again. Multi-process and multi-GPU runs and the
trace/profile planes raise NotImplementedError naming their ROADMAP.md
item.

`serve` loads any family `train` writes into a ModelRegistry on
`--device` (default `cuda`), warms every ladder rung, starts the HTTP
app, and prints one JSON banner line with the bound port and the rung
(its precision: YTK_SERVE_PRECISION) on stdout. SIGTERM drains and exits
0.
The other subcommands of the JAX package's CLI come with their slices
(ROADMAP.md).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from typing import List, Optional

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
GBST_NAMES = ("gbmlr", "gbsdt", "gbhmlr", "gbhsdt")
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


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md {item})")


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


def _refuse_unported(args) -> None:
    """Every train option this port does not run yet raises by its
    ROADMAP.md item, before anything loads."""
    for bad, what, item in (
        (bool(args.coordinator), "multi-process training (--coordinator)",
         "1.7, multi-GPU data-parallel GBDT"),
        (args.devices > 1, "--devices > 1",
         "1.7, multi-GPU data-parallel GBDT"),
        (bool(args.trace_out), "--trace-out", "1.12, the obs planes"),
        (args.profile is not None, "--profile", "1.12, the obs planes"),
    ):
        if bad:
            raise _not_ported(what, item)


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
                    help="GPUs to train on; more than one is not ported yet")
    ap.add_argument("--max-restarts", type=int, default=0,
                    help="on a failed attempt, restart training in this "
                    "process from the last dump (model.continue_train), "
                    "up to N times")
    ap.add_argument("--resume", default="never", choices=("never", "auto"),
                    help="auto: resume from the dump at model.data_path "
                    "when there is one, else start cold")
    ap.add_argument("--coordinator", default="",
                    help="host:port of a multi-process rendezvous (not "
                    "ported yet)")
    ap.add_argument("--set", action="append", dest="sets",
                    metavar="KEY=VALUE", help="config override, repeatable")
    ap.add_argument("--trace-out", default="",
                    help="Chrome-trace output (not ported yet)")
    ap.add_argument("--profile", nargs="?", const="", default=None,
                    metavar="DIR", help="profiling plane (not ported yet)")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)
    _refuse_unported(args)

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
    for attempt in range(restarts + 1):
        try:
            return _train_once(args.model_name, cfg, hook, args.device)
        except Preempted as e:
            # not a failure: the checkpoint is on disk, and a restart here
            # would eat the grace period; the relaunch resumes it
            log.warning("%s; exiting %d", e, e.exit_code)
            return e.exit_code
        except KeyboardInterrupt:
            raise
        except Exception as e:
            if attempt >= restarts or is_sticky_cuda_error(e):
                raise
            log.exception("training attempt %d/%d failed; restarting with "
                          "model.continue_train=true", attempt + 1,
                          restarts + 1)
            cfg = hocon.set_path(cfg, "model.continue_train", True)
    return 1  # unreachable


def _train_once(name: str, cfg: dict, hook, device) -> int:
    from .io.fs import create_filesystem

    fs = create_filesystem(str(cfg.get("fs_scheme", "local")))
    if name in GBST_NAMES:
        from .boost import GBSTTrainer
        from .config.params import CommonParams

        res = GBSTTrainer(CommonParams.from_config(cfg), name, fs=fs,
                          transform_hook=hook, device=device).train()
        print(json.dumps({
            "model": name,
            "trees": res.n_trees,
            "train_loss": res.train_loss,
            "test_loss": res.test_loss,
            "train_metrics": res.train_metrics,
            "test_metrics": res.test_metrics,
        }), flush=True)
        return 0
    if name != "gbdt":
        from .config.params import CommonParams
        from .train import HoagTrainer

        res = HoagTrainer(CommonParams.from_config(cfg), name, fs=fs,
                          transform_hook=hook, device=device).train()
        print(json.dumps({
            "model": name,
            "n_iter": res.n_iter,
            "status": res.status,
            "avg_loss": res.avg_loss,
            "test_loss": res.test_loss,
            "train_metrics": res.train_metrics,
            "test_metrics": res.test_metrics,
        }), flush=True)
        return 0

    from .config.params import GBDTParams
    from .gbdt.trainer import GBDTTrainer

    # the trainer loads data.train/test through GBDTIngest and records the
    # parser and the load's seconds in its time_stats
    res = GBDTTrainer(GBDTParams.from_config(cfg), device=device, fs=fs,
                      transform_hook=hook).train()
    print(json.dumps({
        "model": name,
        "trees": len(res.model.trees),
        "train_loss": res.train_loss,
        "test_loss": res.test_loss,
        "train_metrics": res.train_metrics,
        "test_metrics": res.test_metrics,
    }), flush=True)
    return 0


def serve_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="ytklearn-tpu-torch-serve",
        description="Online prediction server: batch scorer with a padded "
        "shape ladder and dynamic micro-batching with backpressure",
    )
    ap.add_argument("config_path")
    ap.add_argument("model_name", choices=MODEL_NAMES)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080,
                    help="listen port (0 picks an ephemeral port)")
    ap.add_argument("--ladder", default="",
                    help='batch-shape ladder, e.g. "1,8,64,512" (default; '
                    "env YTK_SERVE_LADDER)")
    ap.add_argument("--max-batch", type=int, default=512,
                    help="max rows coalesced into one scorer call")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch straggler wait after the first request")
    ap.add_argument("--max-queue", type=int, default=2048,
                    help="pending-request bound; beyond it requests are shed "
                    "with a typed 429")
    ap.add_argument("--device", default="cuda",
                    help="device to score on: cuda (default) or cpu")
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args(argv)
    _setup_logging(args.verbose)

    from .config import hocon
    from .serve import BatchPolicy, ModelRegistry, ServeApp, parse_ladder

    ladder = parse_ladder(args.ladder) if args.ladder else None
    registry = ModelRegistry(ladder=ladder, device=args.device)
    registry.load(SERVE_NAME, args.model_name, hocon.load(args.config_path))
    policy = BatchPolicy(
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        max_queue=args.max_queue,
    )
    app = ServeApp(registry, policy, host=args.host, port=args.port).start()
    app.install_signal_handlers()
    scorer = registry.get(SERVE_NAME).scorer
    print(json.dumps({
        "serving": SERVE_NAME,
        "model": args.model_name,
        "host": args.host,
        "port": app.port,
        "ladder": list(scorer.ladder),
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
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m ytklearn_tpu_torch.cli {train,serve} ...")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "train":
        return train_main(rest)
    if cmd == "serve":
        return serve_main(rest)
    print(f"unknown command {cmd!r}; the port has: train, serve "
          "(retrain/predict/convert come with their slices)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
