"""K4 (hist_wave_gather, the fused gather-histogram) against gathering the
rows first and running K2 on them, at row budgets R: the port's
counterpart of scripts/micro_hist_gather.py, the tool for YTK_LADDER and
YTK_FUSED_MAX_ROWS.

A 64-slot wave with positions over 509 nodes; for each divisor div the
budget is R = ceil(n / div) rounded up to the 1024-row unit. Each pass
compacts the wave's rows into R slots (compact_indices, the per-row
gathers of pos and grads), then either
  fused     K4 over the compacted list (bins gathered in the kernel), or
  gathered  index_select of the (R, F) rows, a transpose, and K2.
The two passes' histograms must be equal (torch.equal); exit 1 when not.
A third line times the compaction alone, which both passes include: a
pass's time less it is the histogram path's own.

    python -m ytklearn_tpu_torch.scripts.micro_hist_gather [--rows N]
        [--divs 8,32,...] [--chain K] [--repeats R] [--device cpu]

One line per (path, budget) with the time of one pass: K back-to-back
passes between two CUDA events, the median of --repeats, and the card's
name and power limit. With --device cpu the plain versions run the passes
and the check, and every time reads "not measured (cpu)".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..gbdt import hist
from ._common import Timer, fmt_ms, parser, setup

F, B, N = 28, 256, 64
SPREAD = 509
ROWS = 10_485_760
DIVS = (8, 32, 64, 128, 256, 512)


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], ROWS)
    ap.add_argument("--divs", default=",".join(map(str, DIVS)),
                    help="budget divisors: R = ceil(n / div)")
    ap.add_argument("--chain", type=int, default=10,
                    help="passes between the two events of one timing")
    args = ap.parse_args(argv)
    dev, card = setup(args)
    n = args.rows
    rng = np.random.RandomState(0)
    rows = torch.from_numpy(
        rng.randint(0, 255, size=(n, F), dtype=np.uint8)).to(dev)
    pos = torch.from_numpy(
        rng.randint(0, SPREAD, size=n).astype(np.int32)).to(dev)
    gq = torch.from_numpy(rng.randint(-127, 128, n).astype(np.float32)).to(dev)
    hq = torch.from_numpy(rng.randint(0, 128, n).astype(np.float32)).to(dev)
    ids = torch.arange(N, dtype=torch.int32, device=dev)
    timer = Timer(dev, args.repeats)
    print(f"micro_hist_gather: n={n} F={F} B={B} wave N={N} positions over "
          f"{SPREAD} nodes, {args.chain} chained passes a timing, device "
          f"{dev} [{card}]", flush=True)

    def compact(R):
        mask = torch.isin(pos, ids)
        idx, cnt = hist.compact_indices(mask, R)
        valid = torch.arange(R, device=dev) < cnt
        li = idx.long()
        pg = torch.where(valid, pos[li], -1).to(torch.int32)
        return idx, li, pg, gq[li], hq[li]

    def fused(R):
        idx, _, pg, gg, hg = compact(R)
        return hist.hist_wave_gather(rows, idx, pg, gg, hg, ids, B,
                                     max_nodes=SPREAD)

    def gathered(R):
        _, li, pg, gg, hg = compact(R)
        bt = rows.index_select(0, li).t().contiguous()
        return hist.hist_wave_q(bt, pg, gg, hg, ids, B, max_nodes=SPREAD)

    ok = True
    for div in (int(d) for d in args.divs.split(",")):
        R = max(-(-(-(-n // div)) // hist.BMG_DEFAULT) * hist.BMG_DEFAULT,
                hist.BMG_DEFAULT)
        if R >= n:
            print(f"div={div:4d} R={R:9d} >= n: no budget to test [{card}]",
                  flush=True)
            continue
        same = torch.equal(fused(R), gathered(R))
        ok &= same
        for name, fn in (("compact", compact), ("gathered", gathered),
                         ("fused", fused)):
            ms = timer.ms(lambda: fn(R), chain=args.chain)
            print(f"{name:9s} div={div:4d} R={R:9d} {fmt_ms(ms)}/pass "
                  f"[{card}]", flush=True)
        print(f"          div={div:4d} R={R:9d} fused == gathered (exact): "
              f"{same} [{card}]", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
