"""Launch-shape sweep of the histogram kernels at the reference's tune
shape (scripts/tune_hist_kernel.py): 1280 x 8192 rows, F = 28, B = 256,
a 32-slot wave, seeded numpy data as the reference draws it.

  * K2 (hist_wave_q, int8) at q_plan's default plan, then across tile
    plans: fg features a tile in {1, 2, 4, 7, 14, 28} x two chunk lengths,
    each with the whole wave in a tile (the reference's tile) or, when that
    does not fit, the most slots that fit; then the red kind at 512 and
    1024 threads, every plan through check_q_plan and its sums held equal
    to the default plan's (torch.equal);
  * K1 (hist_wave, bf16) at float_plan's default plan, the red kind and
    two tiles (2 and 7 features);
  * K8 (hist_q_u8, the int8 one-hot product on wgmma tensor cores)
    across u8_plan's knobs, fg features an item in {1, 2, 4, 7} x two
    row-chunk lengths, and its default;
  * the reference's spot check: K8 equals K2 (permuted to K8's layout),
    torch.equal. Exit 1 when it does not, or a K2 plan's sums differ.

    python -m ytklearn_tpu_torch.scripts.tune_hist_kernel [--rows N]
        [--repeats R] [--device cpu]

One line per variant with its time (CUDA events: a warm-up, then the
median of --repeats) and the card's name and power limit. A variant that
does not fit is listed with the shared memory it would need and is not
launched; a launch that fails raises. With --device cpu the plain versions
run each variant's control flow and the spot check, and every time reads
"not measured (cpu)".
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..gbdt import hist
from ._common import (
    Timer,
    fmt_ms,
    k1_plans,
    k2k4_plans,
    k2k4_red_plans,
    parser,
    plan_label,
    setup,
)

F, B, N = 28, 256, 32
ROWS = 1280 * 8192
#: positions are drawn over this many nodes, as in the reference
SPREAD = 64
K2_FG = (1, 2, 4, 7, 14, 28)
CHUNK_ROWS = (131072, 524288)
K8_FG = (1, 2, 4, 7)
K8_ROWS = (131072, 524288)


def make_data(n: int, dev: torch.device):
    """The reference's data (RandomState(0), the same draws in the same
    order): u8 bins in [0, 254], positions over 64 nodes, grads quantized
    as round(50 g) clipped to +-127, the wave's ids 0..31."""
    rng = np.random.RandomState(0)
    bins = rng.randint(0, 255, size=(F, n), dtype=np.uint8)
    pos = rng.randint(0, SPREAD, size=n).astype(np.int32)
    g = rng.randn(n).astype(np.float32)
    h = np.abs(rng.randn(n)).astype(np.float32)
    gq = np.clip(np.round(g * 50), -127, 127).astype(np.float32)
    hq = np.clip(np.round(h * 50), -127, 127).astype(np.float32)
    ids = np.arange(N, dtype=np.int32)
    return [torch.from_numpy(a).to(dev)
            for a in (bins, pos, g, h, gq, hq, ids)]


def main(argv=None) -> int:
    args = parser(__doc__.split("\n\n")[0], ROWS).parse_args(argv)
    dev, card = setup(args)
    n = args.rows
    bins, pos, g, h, gq, hq, ids = make_data(n, dev)
    timer = Timer(dev, args.repeats)
    M = SPREAD
    print(f"tune_hist_kernel: n={n} F={F} B={B} wave N={N} positions over "
          f"{SPREAD} nodes, device {dev} [{card}]", flush=True)

    def line(label, ms, extra=""):
        print(f"{label:60s} {fmt_ms(ms)}{extra} [{card}]", flush=True)

    sm = 1 if dev.type == "cpu" else \
        torch.cuda.get_device_properties(dev).multi_processor_count

    # --- K2: the default plan, tile plans, the red kind ---------------------
    def k2(plan=None):
        return hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M,
                                plan=plan)

    default = hist.q_plan(N, F, B, M, n, sm)
    want = k2()
    line(f"K2 int8 default plan (q_plan: {plan_label(default)})",
         timer.ms(k2))
    same_all = True
    plans = [p for rows in CHUNK_ROWS for fg in K2_FG
             for p in k2k4_plans(fg, rows, N, F, B, M, n)]
    plans += [(p, plan_label(p), "")
              for p in k2k4_red_plans(N, F, B, M, n, sm)]
    for plan, label, why in plans:
        if plan is None:
            print(f"{'K2 int8 ' + label:60s} does not fit: {why}; "
                  f"not launched [{card}]", flush=True)
            continue
        same = torch.equal(k2(plan), want)
        same_all &= same
        line("K2 int8 " + label, timer.ms(lambda: k2(plan)),
             f", equals the default plan's {same}")

    # --- K1 in bf16: the default plan, the red kind and two tiles -------
    line("K1 bf16 default plan (float_plan)", timer.ms(
        lambda: hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M)))
    plans = k1_plans((2, 7), CHUNK_ROWS[:1], N, F, B, M, n, sm)
    for plan, label, _ in [plans[0]] + plans[2:]:
        line("K1 bf16 " + label, timer.ms(
            lambda: hist.hist_wave(bins, pos, g, h, ids, B, max_nodes=M,
                                   plan=plan)))

    # --- K8: the int8 one-hot product, fg x rows per block ----------------
    shapes = [(fg, rows) for rows in K8_ROWS for fg in K8_FG] + [(None, None)]
    for fg, rows in shapes:
        plan = hist.u8_plan(N, F, B, n, sm, fg, rows)
        label = (f"K8 u8-OH fg={plan['fg']} rows/block="
                 f"{plan['rows_per_block']} W={plan['W']} items="
                 f"{plan['items']} blocks={plan['blocks']}"
                 + (" (default)" if fg is None else ""))
        line(label, timer.ms(
            lambda: hist.hist_q_u8(bins, pos, gq, hq, ids, B, fg=fg,
                                   rows_per_block=rows)))

    # --- the reference's spot check: K8 == K2 -----------------------------
    a = hist.hist_wave_q(bins, pos, gq, hq, ids, B, max_nodes=M)
    b = hist.hist_q_u8(bins, pos, gq, hq, ids, B, fg=7)
    exact = torch.equal(a.permute(1, 3, 0, 2).reshape(F, 3 * N, B), b)
    print(f"u8 variant exact: {exact} (K8 fg=7 against K2, torch.equal) "
          f"[{card}]", flush=True)
    print(f"K2 plans exact: {same_all} (every K2 plan against the default "
          f"plan, torch.equal) [{card}]", flush=True)
    return 0 if exact and same_all else 1


if __name__ == "__main__":
    sys.exit(main())
