"""Command-line entry points of the port.

  python -m ytklearn_tpu_torch.cli serve <config_path> <model_name> [options]

`serve` loads the model into a ModelRegistry on `--device` (default
`cuda`), warms every ladder rung, starts the HTTP app, and prints one JSON
banner line with the bound port on stdout. SIGTERM drains and exits 0.
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
#: registry name of the served model (the default target of /predict)
SERVE_NAME = "default"


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
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )

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
    except KeyboardInterrupt:
        app.stop(drain=True)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m ytklearn_tpu_torch.cli serve ...")
        return 0 if argv else 2
    cmd, rest = argv[0], argv[1:]
    if cmd == "serve":
        return serve_main(rest)
    print(f"unknown command {cmd!r}; the port has: serve "
          "(train/retrain/predict/convert come with their slices)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    sys.exit(main())
