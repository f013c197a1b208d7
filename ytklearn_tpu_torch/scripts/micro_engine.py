"""Per-component timing of the device GBDT engine at Higgs scale: the
port's counterpart of scripts/micro_engine.py.

Times, each call between two CUDA events and synchronized before the
next, so no queued launch hides in the number:
  - hist_wave (kernel K1, bf16) for waves of 16 and 32 slots
  - route_wave (kernel K5) over a wave of 16 splits
  - one full engine.grow tree (255 leaves, wave 16)

The inputs are the reference's (scripts/micro_engine.py:43-53, 75-84):
RandomState(0) int32 bins over 28 features and 256 bins, padded by
hist.pad_inputs, and its g, h, positions and split table.

    python -m ytklearn_tpu_torch.scripts.micro_engine [n_rows]
        [--device cpu]

On the CPU every part runs once on the plain versions (its control flow)
and reads "not measured (cpu)".
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

F, B = 28, 256


def timeit(label: str, fn, dev, card: str, reps: int = 5):
    """The median ms of `reps` calls after one that builds and runs to
    completion, each call alone between two CUDA events; on the CPU one
    call and "not measured"."""
    from ytklearn_tpu_torch.scripts._common import Timer, fmt_ms

    ms = Timer(dev, reps).ms(fn)
    print(f"{label:40s} {fmt_ms(ms)}"
          + (f" [{card}]" if ms is not None else ""), flush=True)
    return ms


def make_inputs(n: int, dev):
    """(bins_t (F, n_pad) int32, g, h, n_pad, rng) on `dev`: the
    reference's draws in its order."""
    from ytklearn_tpu_torch.gbdt.hist import pad_inputs

    rng = np.random.RandomState(0)
    bins = rng.randint(0, 255, size=(n, F)).astype(np.int32)
    bins_t_np, n_pad = pad_inputs(bins)
    del bins
    bins_t = torch.from_numpy(bins_t_np).to(dev)
    del bins_t_np
    g = torch.from_numpy(rng.randn(n_pad).astype(np.float32)).to(dev)
    h = torch.from_numpy(np.abs(rng.randn(n_pad)).astype(np.float32)).to(dev)
    return bins_t, g, h, n_pad, rng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=10_500_000)
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from ytklearn_tpu_torch.gbdt import engine, hist, route
    from ytklearn_tpu_torch.scripts._common import launch_line, setup

    dev, card = setup(args)
    n = args.n_rows
    bins_t, g, h, n_pad, rng = make_inputs(n, dev)
    print(f"n={n} n_pad={n_pad} [{card}]", flush=True)

    def i32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    for NW in (16, 32):
        pos = i32(rng.randint(0, 400, size=(n_pad,)))
        ids = i32(np.arange(NW))
        timeit(f"hist_wave N={NW} bf16",
               lambda: hist.hist_wave(bins_t, pos, g, h, ids, B,
                                      max_nodes=509), dev, card)

    # route: one wave of 16 splits
    NW = 16
    pos = i32(rng.randint(0, 16, size=(n_pad,)))
    sel_valid = torch.ones((NW,), dtype=torch.bool, device=dev)
    sel_nid = i32(np.arange(NW))
    sel_feat = i32(rng.randint(0, F, NW))
    sel_slot = i32(np.full(NW, 128))
    sel_lo = i32(np.zeros(NW))
    sel_hi = i32(np.full(NW, B - 1))
    sel_l = i32(np.arange(16, 16 + NW))
    sel_r = sel_l + 1
    timeit("route wave of 16",
           lambda: route.route_wave(bins_t, pos, sel_valid, sel_nid,
                                    sel_feat, sel_slot, sel_l, sel_r,
                                    lo=sel_lo, hi=sel_hi), dev, card)

    # full tree
    spec = engine.GrowSpec(
        F=F, B=B, max_nodes=509, wave=16, policy="loss", max_depth=60,
        max_leaves=255, lr=0.1, l1=0.0, l2=0.0, min_h=100.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, hist_mode="mxu")
    include = torch.arange(n_pad, device=dev) < n
    fmask = torch.ones((F,), dtype=torch.bool, device=dev)
    timeit("grow full tree (255 leaves, wave 16)",
           lambda: engine.grow(spec, bins_t, include, g, h, fmask), dev,
           card, reps=3)
    print(launch_line(card), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
