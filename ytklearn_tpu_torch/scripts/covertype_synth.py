"""Covertype-shaped synthetic text for multiclass GBDT runs.

UCI Covertype, the multiclass set of the GBDT benchmark literature, has 54
features: 10 integer measurements (elevation, aspect, slope, three
distances, three hillshades, the fire-point distance) and two one-hot
groups, 4 wilderness areas and 40 soil types, with 7 cover types as the
label. `covertype_like(n, seed)` draws rows of that shape from a seed
(ranges and class shares of the UCI set; the labels from a planted
multinomial model over the measurements and both groups, so the classes
are learnable and overlap); nothing is downloaded. `write_split` writes
one draw as train and test ytklearn lines, `1###class###f0:v,...,f9:v,f<10+w>:1,
f<14+s>:1`: the one-hot groups name only their set column, as a libsvm
file does, and the rest are missing (the Higgs config fills them with
value@0).

    python -m ytklearn_tpu_torch.scripts.covertype_synth OUT_DIR
        [--rows N] [--test-rows M] [--seed S]

writes OUT_DIR/train.txt and OUT_DIR/test.txt.
"""

from __future__ import annotations

import argparse
import os
from typing import Tuple

import numpy as np

N_NUMERIC, N_WILD, N_SOIL, K = 10, 4, 40, 7
N_FEATURES = N_NUMERIC + N_WILD + N_SOIL  # 54
#: the UCI set's class shares (581,012 rows)
CLASS_SHARE = (0.3646, 0.4876, 0.0615, 0.0047, 0.0163, 0.0299, 0.0353)
WILD_SHARE = (0.4489, 0.0514, 0.4361, 0.0636)


def _numeric(rng: np.random.RandomState, n: int) -> np.ndarray:
    """(n, 10) integer measurements in the UCI set's ranges."""
    cols = [
        np.clip(rng.normal(2959, 280, n), 1859, 3858),  # elevation
        rng.uniform(0, 360, n),  # aspect
        np.clip(np.abs(rng.normal(14, 7.5, n)), 0, 66),  # slope
        np.minimum(rng.exponential(270, n), 1397),  # horizontal to water
        np.clip(rng.normal(46, 58, n), -173, 601),  # vertical to water
        np.minimum(rng.exponential(2350, n), 7117),  # to roadways
        np.clip(rng.normal(212, 27, n), 0, 254),  # hillshade 9am
        np.clip(rng.normal(223, 20, n), 0, 254),  # hillshade noon
        np.clip(rng.normal(143, 38, n), 0, 254),  # hillshade 3pm
        np.minimum(rng.exponential(1980, n), 7173),  # to fire points
    ]
    return np.rint(np.stack(cols, axis=1)).astype(np.int32)


def covertype_like(n: int, seed: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(numeric (n, 10) int32, wilderness (n,) in [0, 4), soil (n,) in
    [0, 40), label (n,) in [0, 7)); the planted model is drawn from
    `seed`."""
    rng = np.random.RandomState(seed)
    model = np.random.RandomState(seed ^ 0x5EED)
    soil_share = model.dirichlet(np.full(N_SOIL, 0.6))
    w_num = model.normal(0, 1.0, (N_NUMERIC, K))
    w_num[0] *= 3.0  # elevation leads, as in the UCI set
    w_wild = model.normal(0, 1.0, (N_WILD, K))
    w_soil = model.normal(0, 1.2, (N_SOIL, K))
    num = _numeric(rng, n)
    wild = rng.choice(N_WILD, size=n, p=WILD_SHARE)
    soil = rng.choice(N_SOIL, size=n, p=soil_share)
    mu = num.mean(axis=0) if n else np.zeros(N_NUMERIC)
    sd = num.std(axis=0) + 1e-9 if n else np.ones(N_NUMERIC)
    z = (num - mu) / sd
    logits = (z @ w_num + np.sin(2.0 * z[:, :1]) * w_num[1]
              + w_wild[wild] + w_soil[soil] + np.log(CLASS_SHARE))
    label = np.argmax(logits + rng.gumbel(size=(n, K)), axis=1)
    return num, wild, soil, label.astype(np.int32)


def write_split(out_dir: str, rows: int, test_rows: int, seed: int
                ) -> Tuple[str, str, np.ndarray]:
    """train.txt (rows lines) and test.txt (test_rows lines) under
    out_dir, from one draw of one planted model. Returns the two paths and
    the test labels."""
    os.makedirs(out_dir, exist_ok=True)
    num, wild, soil, label = covertype_like(rows + test_rows, seed)
    paths = []
    head = "1###%d###" + ",".join(f"f{j}:%d" for j in range(N_NUMERIC)) \
        + ",f%d:1,f%d:1\n"
    for name, sl in (("train", slice(0, rows)),
                     ("test", slice(rows, rows + test_rows))):
        path = os.path.join(out_dir, f"{name}.txt")
        with open(path, "w") as f:
            lo, hi = sl.start, sl.stop
            for i in range(lo, hi, 65536):
                s = slice(i, min(i + 65536, hi))
                rows_ = np.concatenate(
                    [label[s, None], num[s], N_NUMERIC + wild[s, None],
                     N_NUMERIC + N_WILD + soil[s, None]], axis=1).tolist()
                f.write("".join(head % tuple(r) for r in rows_))
        paths.append(path)
    return paths[0], paths[1], label[rows:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--rows", type=int, default=1 << 19)
    ap.add_argument("--test-rows", type=int, default=1 << 16)
    ap.add_argument("--seed", type=int, default=20261017)
    args = ap.parse_args(argv)
    write_split(args.out_dir, args.rows, args.test_rows, args.seed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
