"""Seeded synthetic data and configs for the convex families, in the
reference's text format (`weight###label###name:val,...`).

    write_convex_case(dirpath, family, n_train, n_test, seed, **shape)
        -> config dict for `cli train <family>` (HOCON keys as a dict)

Rows draw `nnz` distinct feature names from a vocabulary of `vocab`
(`f<j>`; FFM's are `<field>@f<j>`, the field dict in `fields.dict`), values
1.0 or uniform(0, 1), and a label from a planted model: a Bernoulli of the
sigmoid of a sparse linear score plus a pairwise term (binary), or the
argmax of K noisy class scores (multiclass_linear, K classes).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _rows(rng, n: int, vocab: int, nnz: int):
    """(n, nnz) distinct feature ids a row (one from each of nnz equal
    slices of the vocabulary) and their values."""
    span = vocab // nnz
    ids = np.arange(nnz) * span + rng.randint(0, span, (n, nnz))
    vals = np.where(rng.rand(n, nnz) < 0.5, 1.0,
                    np.round(rng.rand(n, nnz), 4))
    return ids, vals


def planted(seed: int, family: str, vocab: int, K: int):
    """The planted model the labels come from."""
    rng = np.random.RandomState(seed)
    if family == "multiclass_linear":
        return (rng.randn(vocab, K),)
    return rng.randn(vocab) * 0.7, rng.randn(vocab, 2) * 0.5


def _labels(rng, family: str, ids, vals, model):
    if family == "multiclass_linear":
        (W,) = model
        s = np.einsum("nw,nwk->nk", vals, W[ids]) \
            + rng.randn(len(ids), W.shape[1])
        return np.argmax(s, axis=1).astype(np.float64)
    w, V = model
    vx = V[ids] * vals[..., None]
    s = (vals * w[ids]).sum(1) + 0.5 * ((vx.sum(1) ** 2)
                                         - (vx ** 2).sum(1)).sum(1)
    return (rng.rand(len(ids)) < 1.0 / (1.0 + np.exp(-s))).astype(np.float64)


def write_lines(path: str, family: str, n: int, seed: int, model,
                nnz: int, n_fields: int = 0) -> None:
    """n lines from RandomState(seed) labelled by `model`."""
    rng = np.random.RandomState(seed)
    ids, vals = _rows(rng, n, model[0].shape[0], nnz)
    y = _labels(rng, family, ids, vals, model)
    weight = np.where(rng.rand(n) < 0.1, 2.0, 1.0)
    with open(path, "w") as f:
        for i in range(n):
            if n_fields:
                names = [f"c{j % n_fields}@f{j}" for j in ids[i]]
            else:
                names = [f"f{j}" for j in ids[i]]
            feats = ",".join(f"{nm}:{v:g}" for nm, v in zip(names, vals[i]))
            f.write(f"{weight[i]:g}###{int(y[i])}###{feats}\n")


def write_convex_case(dirpath: str, family: str, n_train: int, n_test: int,
                      seed: int, vocab: int = 200, nnz: int = 8, K: int = 5,
                      n_fields: int = 8, k: int = 4, loss: Optional[str] = None,
                      l1: float = 0.0, l2: float = 0.0, max_iter: int = 30,
                      mode: str = "wolfe", hyper: Optional[dict] = None
                      ) -> dict:
    """Writes train/test files (and FFM's field dict) under `dirpath` and
    returns the training config."""
    os.makedirs(dirpath, exist_ok=True)
    fields = n_fields if family == "ffm" else 0
    kk = K if family == "multiclass_linear" else 2
    train = os.path.join(dirpath, "train.txt")
    test = os.path.join(dirpath, "test.txt")
    model = planted(seed, family, vocab, kk)
    write_lines(train, family, n_train, seed + 1, model, nnz, fields)
    write_lines(test, family, n_test, seed + 2, model, nnz, fields)
    if loss is None:
        loss = "softmax" if family == "multiclass_linear" else "sigmoid"
    cfg = {
        "data": {"train": {"data_path": train},
                 "test": {"data_path": test}},
        "model": {"data_path": os.path.join(dirpath, "model"),
                  "dump_freq": -1},
        "loss": {"loss_function": loss,
                 "evaluate_metric": (["confusion_matrix"]
                                     if family == "multiclass_linear"
                                     else ["auc"]),
                 "regularization": {"l1": [l1], "l2": [l2]}},
        "optimization": {"line_search": {
            "mode": mode,
            "lbfgs": {"convergence": {"max_iter": max_iter, "eps": 1e-5}}}},
    }
    if family == "multiclass_linear":
        cfg["k"] = K
    elif family in ("fm", "ffm"):
        cfg["k"] = [1, k]
    if family == "ffm":
        fd = os.path.join(dirpath, "fields.dict")
        with open(fd, "w") as f:
            f.writelines(f"c{j}\n" for j in range(n_fields))
        cfg["model"]["field_dict_path"] = fd
    if hyper:
        cfg["hyper"] = hyper
    return cfg
