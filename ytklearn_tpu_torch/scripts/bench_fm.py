"""The FM cell of bench.py as the reference runs it, on the port: the
counterpart of bench.py::bench_fm (:367-422).

    python -m ytklearn_tpu_torch.scripts.bench_fm [--repeats N]
        [--rows N] [--out PATH] [--device cpu]

A rank-8 factorization machine, full-batch L-BFGS (m = 8), on
Criteo-shaped synthetic sparse rows: `BENCH_FM_ROWS` rows (default
2,000,000; `--rows` wins), dim 2^18, 39 non-zeros a row with slot 0 the
bias, values 1.0 but 13 uniform "numeric" columns, labels from a planted
linear model plus noise, all drawn from numpy's RandomState(7) in
bench.py's order. The loss and gradient run blocked over row chunks
(`FMModel.suggest_row_chunk`). Two warm iterations, then 12 timed; the
clock stops after a device sync.

Prints one JSON object a run: `fm_examples_per_sec` = rows x iterations /
seconds (one data pass an iteration; line-search trials beyond the first
are not counted, so the rate is conservative), `fm_loss` (the final
regularized loss over the rows), the iterations, status, row chunk,
seconds, and the card's name and power limit. `--repeats N` runs the
cell N times, each in a fresh process, and prints after their lines one
object with every run and the medians. With `--device cpu` the rate reads
"not measured (cpu)". Cut from bench.py's cell: none.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..config.params import CommonParams
from ..models.fm import FMModel
from ..optimize import LBFGSConfig, minimize_lbfgs
from ._common import NOT_MEASURED, setup

DIM, NNZ, K = 1 << 18, 39, 8
SEED = 7
DEFAULT_ROWS = 2_000_000
WARM_ITERS, TIMED_ITERS = 2, 12


def make_data(n: int):
    """bench.py's rows, host numpy: (idx, val, y, weight)."""
    rng = np.random.RandomState(SEED)
    idx = rng.randint(1, DIM, size=(n, NNZ)).astype(np.int32)
    idx[:, 0] = 0  # the bias slot
    val = np.ones((n, NNZ), np.float32)
    val[:, 1:14] = rng.rand(n, 13).astype(np.float32)
    w_true = (rng.randn(DIM) * 0.3).astype(np.float32)
    score = (val * w_true[idx]).sum(axis=1)
    y = (score + 0.5 * rng.randn(n) > 0).astype(np.float32)
    return idx, val, y, np.ones(n, np.float32)


class Cell:
    """The model, its batch on the device and the L-BFGS runs."""

    def __init__(self, n: int, dev: torch.device):
        p = CommonParams()
        p.k = [1, K]
        p.model.need_bias = True
        self.n, self.dev = n, dev
        self.model = FMModel(p, DIM, device=dev)
        self.batch = tuple(torch.from_numpy(a).to(dev)
                           for a in make_data(n))
        self.reg = torch.zeros((self.model.dim,), device=dev)
        self.w0 = torch.from_numpy(self.model.init_weights()).to(dev)
        self.row_chunk = self.model.suggest_row_chunk(n, NNZ)

    def run(self, iters: int, callback=None):
        res = minimize_lbfgs(
            self.model.pure_loss, self.w0, LBFGSConfig(max_iter=iters, m=8),
            batch=self.batch, l1_vec=self.reg, l2_vec=self.reg,
            g_weight=float(self.n), row_chunk=self.row_chunk,
            callback=callback)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return res


def cell_rows(rows=None) -> int:
    """--rows, else BENCH_FM_ROWS, else bench.py's 2,000,000."""
    return rows if rows is not None else int(
        os.environ.get("BENCH_FM_ROWS", DEFAULT_ROWS))


def run_cell(args) -> dict:
    dev, card = setup(args)
    return measure(Cell(cell_rows(args.rows), dev), card)


def measure(cell: Cell, card: str) -> dict:
    """Two warm iterations, then the 12 timed ones."""
    n, dev = cell.n, cell.dev
    cell.run(WARM_ITERS)
    t0 = time.perf_counter()
    res = cell.run(TIMED_ITERS)
    dt = time.perf_counter() - t0
    return {
        "fm_examples_per_sec": (n * res.n_iter / dt if dev.type == "cuda"
                                else NOT_MEASURED),
        "fm_loss": res.loss / n,
        "n_iter": res.n_iter,
        "status": res.status,
        "rows": n,
        "row_chunk": cell.row_chunk,
        "seconds": dt if dev.type == "cuda" else NOT_MEASURED,
        "card": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default; raises without a GPU) or cpu")
    ap.add_argument("--rows", type=int, default=None)
    ap.add_argument("--repeats", type=int, default=1,
                    help="runs of the cell, each in a fresh process")
    ap.add_argument("--out", default=None, help="write the JSON here too")
    args = ap.parse_args(argv)
    if args.repeats <= 1:
        out = run_cell(args)
        print(json.dumps(out), flush=True)
    else:
        from .bench_gbdt import _drop_option, _median

        child = list(argv if argv is not None else sys.argv[1:])
        child = _drop_option(_drop_option(child, "--repeats"), "--out")
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        runs = []
        for _ in range(args.repeats):
            proc = subprocess.run(
                [sys.executable, "-m", "ytklearn_tpu_torch.scripts.bench_fm",
                 *child], capture_output=True, text=True, cwd=root, env=env)
            if proc.returncode != 0:
                sys.stderr.write(proc.stderr[-4000:])
                raise RuntimeError(f"bench_fm: a run exited "
                                   f"{proc.returncode}")
            line = proc.stdout.strip().splitlines()[-1]
            print(line, flush=True)
            runs.append(json.loads(line))
        out = {"runs": runs, "repeats": args.repeats, "card": runs[0]["card"],
               "median": {k: _median(runs, k) for k in
                          ("fm_examples_per_sec", "fm_loss")}}
        print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
