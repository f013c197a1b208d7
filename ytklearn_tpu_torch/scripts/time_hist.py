"""K1-K4 at chip_smoke.py's timing shapes, on one line: the quick A/B of
two checkouts of the histogram kernels on one card. Run it from each
checkout in turns (A, B, B, A) within one call:

    python -m ytklearn_tpu_torch.scripts.time_hist [--rows N]
        [--repeats R] [--device cpu]

The data: u8 bins (F = 28, B = 256) over --rows rows (default the
training run's 10,502,144 padded rows), positions over 129 nodes, a
64-slot wave of the odd ids, grads drawn from a seeded generator on the
device. K2 (int8) and K1 (bf16) run one full-scan wave over every row;
K4 (int8) and K3 (bf16) the first fused rung of it, R = n/64 rounded up to
1024 rows, each at its planner's default plan (q_plan for K2/K4,
float_plan for K1/K3), printed after the times. Times are CUDA events,
the median of --repeats runs of 10 (K1, K2) or 50 (K3, K4) launches, with
the card's name and power limit; with --device cpu the plain versions run
once and every time reads "not measured (cpu)".
"""

from __future__ import annotations

import sys

import torch

from ..gbdt import hist
from ._common import Timer, fmt_ms, parser, setup

F, B, N = 28, 256, 64
ROWS = 10_502_144


def main(argv=None) -> int:
    args = parser(__doc__.split("\n\n")[0], ROWS).parse_args(argv)
    dev, card = setup(args)
    n = args.rows
    M = 2 * N + 1
    gen = torch.Generator(device=dev).manual_seed(3)
    bins = torch.randint(0, 255, (F, n), generator=gen, device=dev,
                         dtype=torch.int32).to(torch.uint8)
    pos = torch.randint(0, M, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    gq = torch.randint(-127, 128, (n,), generator=gen, device=dev).float()
    hq = torch.randint(0, 128, (n,), generator=gen, device=dev).float()
    g, h = gq / 50, hq / 50
    ids = torch.arange(1, M, 2, device=dev, dtype=torch.int32)
    rows = bins.t().contiguous()
    R = -(-(n // 64) // hist.BMG_DEFAULT) * hist.BMG_DEFAULT
    member = torch.nonzero(torch.isin(pos, ids)).flatten()[:R]
    idx = torch.zeros(R, dtype=torch.int32, device=dev)
    idx[:len(member)] = member.to(torch.int32)
    pg = torch.full((R,), -1, dtype=torch.int32, device=dev)
    pg[:len(member)] = pos[member]
    li = idx.long()
    gg, hg, g2, h2 = gq[li], hq[li], g[li], h[li]
    timer = Timer(dev, args.repeats)
    out = {
        "K2": timer.ms(lambda: hist.hist_wave_q(bins, pos, gq, hq, ids, B,
                                                max_nodes=M), chain=10),
        "K1": timer.ms(lambda: hist.hist_wave(bins, pos, g, h, ids, B,
                                              max_nodes=M), chain=10),
        "K4": timer.ms(lambda: hist.hist_wave_gather(
            rows, idx, pg, gg, hg, ids, B, max_nodes=M), chain=50),
        "K3": timer.ms(lambda: hist.hist_wave_gather(
            rows, idx, pg, g2, h2, ids, B, mode="mxu", max_nodes=M),
            chain=50),
    }
    sm = 1 if dev.type == "cpu" else \
        torch.cuda.get_device_properties(dev).multi_processor_count
    plans = {"K2": hist.q_plan(N, F, B, M, n, sm),
             "K1": hist.float_plan(N, F, B, M, n, sm),
             "K4": hist.q_plan(N, F, B, M, R, sm, True),
             "K3": hist.float_plan(N, F, B, M, R, sm, True)}
    print(f"time_hist: n={n} R={R} wave N={N}: "
          + ", ".join(f"{k} {fmt_ms(v)}" for k, v in out.items())
          + "; plans " + ", ".join(
              f"{k} {p['kind']} {p['ng']}x{p['fg']} {p['n_tiles']}x"
              f"{p['n_chunks']}" for k, p in plans.items())
          + f" [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
