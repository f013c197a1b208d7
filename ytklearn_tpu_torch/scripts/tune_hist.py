"""Launch-shape sweep of K1 (hist_wave, bf16) at Higgs width: the port's
counterpart of scripts/tune_hist.py and scripts/micro_hist_chain.py.

For each wave of N in {16, 32, 42, 64} slots, positions are drawn over the
wave's N nodes (tune_hist.py: every row is in the wave) and over 509 nodes
(micro_hist_chain.py: most rows are skipped). K1 runs at float_plan's
default plan, at the red kind (512 and 1024 threads), and at tiles of fg
features in {1, 2, 4, 7, 14, 28} (the most slots that fit) x two chunk
lengths, every plan through check_float_plan. Every variant's counts are
held equal to the default plan's (exact); exit 1 when one is not.

    python -m ytklearn_tpu_torch.scripts.tune_hist [--rows N] [--chain K]
        [--repeats R] [--device cpu]

One line per variant with the time of one pass: K back-to-back launches
between two CUDA events (micro_hist_chain.py's K chained passes), the
median of --repeats, and the card's name and power limit. A shape that
does not fit is listed and not launched. With --device cpu the plain
version runs the control flow and the count check, and every time reads
"not measured (cpu)".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..gbdt import hist
from ._common import Timer, fmt_ms, k1_plans, parser, setup

F, B = 28, 256
ROWS = 10_500_000
WAVES = (16, 32, 42, 64)
SPREADS = (None, 509)  # None: over the wave's own N nodes
FGS = (1, 2, 4, 7, 14, 28)
CHUNK_ROWS = (131072, 524288)


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], ROWS)
    ap.add_argument("--chain", type=int, default=10,
                    help="launches between the two events of one timing")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    n = args.rows
    rng = np.random.RandomState(0)
    bins = torch.from_numpy(
        rng.randint(0, 255, size=(F, n), dtype=np.uint8)).to(dev)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    h = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)).to(dev)
    timer = Timer(dev, args.repeats)
    sm = 1 if dev.type == "cpu" else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"tune_hist: n={n} F={F} B={B} u8 bins, K1 bf16, {args.chain} "
          f"chained launches a timing, device {dev} [{card}]", flush=True)
    ok = True
    for N in WAVES:
        ids = torch.arange(N, dtype=torch.int32, device=dev)
        for spread in SPREADS:
            M = spread or N
            pos = torch.from_numpy(
                rng.randint(0, M, size=n).astype(np.int32)).to(dev)
            head = f"N={N:3d} over {M:3d} nodes"

            def run(plan=None):
                return hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                                      plan=plan)

            want = run()[..., 2]
            ms = timer.ms(run, chain=args.chain)
            print(f"{head} default plan (float_plan){'':23s} "
                  f"{fmt_ms(ms)}/pass [{card}]", flush=True)
            for plan, label, why in k1_plans(FGS, CHUNK_ROWS, N, F, B, M, n,
                                             sm):
                if plan is None:
                    print(f"{head} {label:56s} does not fit: {why}; not "
                          f"launched [{card}]", flush=True)
                    continue
                same = torch.equal(run(plan)[..., 2], want)
                ok &= same
                ms = timer.ms(lambda: run(plan), chain=args.chain)
                print(f"{head} {label:56s} {fmt_ms(ms)}/pass, counts equal "
                      f"the default plan's {same} [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
