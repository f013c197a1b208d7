"""Batched raw-feature assembly for serving.

The identity mode of ``ytklearn_tpu/transform/pipeline.py::
TransformPipeline`` (the one GBDT serving uses): request dicts scatter into
a dense (B, dim) float64 matrix against the model vocab, unknown features
drop, absent ones keep the fill (NaN routes a row to the split's default
child). Hashing and transform-stat replay belong to the convex families
and come with them (ROADMAP.md).
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["TransformPipeline"]


class TransformPipeline:
    """Batched raw-features front door for one loaded model."""

    def __init__(self, *, vocab: Dict[str, int], dim: int, fill: float):
        self.vocab = vocab
        self.dim = dim
        self.fill = fill

    @classmethod
    def for_identity(
        cls, vocab: Dict[str, int], dim: int, fill: float
    ) -> "TransformPipeline":
        return cls(vocab=vocab, dim=dim, fill=fill)

    def featurize(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        """Request dicts -> dense (B, dim) float64 in one batched stage."""
        B = len(rows)
        X = np.full((B, self.dim), self.fill, np.float64)
        keys: List[str] = []
        vals: List[float] = []
        lens: List[int] = []
        ke, ve, la = keys.extend, vals.extend, lens.append
        for fmap in rows:
            ke(fmap.keys())
            ve(fmap.values())
            la(len(fmap))
        if not keys:
            return X
        jj = np.fromiter(
            map(self.vocab.get, keys, itertools.repeat(-1)), np.int64, len(keys)
        )
        m = jj >= 0  # unknown features drop, as in the host walk
        try:
            vv = np.asarray(vals, np.float64)
        except (ValueError, TypeError):
            # a non-numeric value on an unknown (dropped) feature must not
            # fail the request; a known feature's bad value still raises
            vv = np.asarray(
                [float(v) if k else 0.0 for v, k in zip(vals, m)], np.float64
            )
        ii = np.repeat(np.arange(B), lens)
        X[ii[m], jj[m]] = vv[m]
        return X
