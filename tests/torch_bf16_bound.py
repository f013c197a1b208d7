"""The stated bound of the bf16 serving rung (tests/test_torch_scorer.py
against the JAX rung, tests/test_torch_cuda.py card against CPU).

The rung rounds its operands to bf16 and sums their products in f32 (the
JAX package's preferred_element_type=f32). A bf16 x bf16 product is exact
in f32, so two such rungs differ only in the order of their f32 sums: a
sum of n terms lies within n * 2^-24 * (the sum of its terms' magnitudes)
of the exact sum. The bound is four times that over the whole score, with
n = D + 2 and the magnitudes taken by the same products on |operands|.
`xla_square` adds, for FFM, the one difference that is not an order: XLA's
fused program squares the bf16 X in f32 where the JAX source (and the
port) round X * X to bf16, at most |x^2 - bf16(x^2)| * |sn| a feature (sn
the self-interaction norm), halved. Imports no JAX.
"""

import numpy as np
import torch

U32 = 2.0 ** -24


def bf16_round(a):
    """float64 values rounded to bf16, as float64."""
    return torch.from_numpy(np.asarray(a, np.float64)).to(
        torch.bfloat16).double().numpy()


def bf16_bound(family, pred, scorer, X, xla_square=False):
    """(B,) or (B, K-1): the bound on |a - b| of two bf16 rungs' scores of
    the featurized rows X for the port's predictor `pred` and `scorer`'s
    vocab."""
    vocab, bias_col = scorer.vocab, scorer._bias_col
    bias = pred.params.model.bias_feature_name
    D = X.shape[1]
    rows = dict((j, pred.model_map[n]) for n, j in vocab.items())
    if bias_col is not None:
        rows[bias_col] = pred.model_map[bias]
    A = np.stack([rows[j] for j in range(D)])
    ax = np.abs(bf16_round(X))
    extra = 0.0
    if family == "linear":
        mag = ax @ np.abs(bf16_round(A[:, 0]))
    elif family == "multiclass_linear":
        mag = ax @ np.abs(bf16_round(A))
    elif family == "fm":
        V = A[:, 1:1 + pred.sok]
        S = ax @ np.abs(bf16_round(V))
        S2 = (ax * ax) @ np.abs(bf16_round(V * V))
        mag = ax @ np.abs(bf16_round(A[:, 0])) + np.sum(S * S + S2, axis=-1)
    elif family == "ffm":
        k, F = pred.sok, pred.n_fields
        V = A[:, 1:1 + F * k].reshape(D, F, k)
        fld = np.zeros(D, np.int64)
        for n, j in vocab.items():
            fld[j] = pred._field_of(n)
        Vs = V[np.arange(D), fld]
        sn = np.abs(bf16_round(np.einsum("dk,dk->d", Vs, Vs)))
        M = np.zeros((D, F))
        M[np.arange(D), fld] = 1.0
        T = np.einsum("bd,da,dfk->bafk", ax, M, np.abs(bf16_round(V)))
        mag = (ax @ np.abs(bf16_round(A[:, 0]))
               + np.einsum("bafk,bfak->b", T, T) + (ax * ax) @ sn)
        if xla_square:
            x2 = bf16_round(X) ** 2
            extra = 0.5 * (np.abs(x2 - bf16_round(x2)) @ sn)
    else:
        raise ValueError(f"no bf16 rung for {family!r}")
    return 4 * (D + 2) * U32 * mag + extra
