"""The one transform path of ingest, the predictors and serving
(``ytklearn_tpu/transform/pipeline.py``).

  TransformTable, apply_nodes  the vectorized TransformNode replay, one
                               implementation for the convex ingest
                               (`DataIngest.to_dataset`) and the
                               predictors (`prep_row`)
  TransformPipeline            `prep_row`: a predictor's bias drop, murmur
                               hashing and replay of one feature dict;
                               `featurize`: request dicts into a dense
                               (B, dim) float64 matrix against the model
                               vocab in one batched stage, the same drop,
                               hashing (signed collisions summed) and
                               replay, and the bias column at 1.0; or, in
                               the identity mode GBDT serving uses, raw
                               values with a missing fill

Replay semantics, bit for bit the scalar `TransformNode.transform`:
standardization `(val - mean) / stdvar` unless `stdvar < 1e-6`
(identity); scale_range `rmin + (rmax - rmin) * ((val - min) / (max -
min))`, or 1.0 when `|max - min| < 1e-6`; for the predictors only
(`nodeless_zero`), a feature without a stat node maps to 0.0 when the
transform is on (ContinuousOnlinePredictor.transform:135-143).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import knobs

__all__ = ["TransformTable", "apply_nodes", "TransformPipeline"]


@dataclass
class TransformTable:
    """TransformNode fields as dense lookup arrays: one row a global
    feature index (`from_indexed`), or a row a node after a row-0 "no
    node" sentinel (`from_named`)."""

    has: np.ndarray  # bool: a stat node exists for this row
    is_std: np.ndarray  # bool: mode == standardization
    mean: np.ndarray
    std: np.ndarray
    mn: np.ndarray
    mx: np.ndarray
    rmin: np.ndarray
    rmax: np.ndarray

    @classmethod
    def zeros(cls, dim: int) -> "TransformTable":
        z = np.zeros(dim)
        return cls(has=np.zeros(dim, bool), is_std=np.zeros(dim, bool),
                   mean=z.copy(), std=z.copy(), mn=z.copy(), mx=z.copy(),
                   rmin=z.copy(), rmax=z.copy())

    def set_node(self, i: int, node) -> None:
        self.has[i] = True
        self.is_std[i] = node.mode == "standardization"
        self.mean[i], self.std[i] = node.mean, node.stdvar
        self.mn[i], self.mx[i] = node.min, node.max
        self.rmin[i], self.rmax[i] = node.range_min, node.range_max

    @classmethod
    def from_indexed(cls, nodes: Dict[int, object],
                     dim: int) -> "TransformTable":
        t = cls.zeros(dim)
        for g, node in nodes.items():
            t.set_node(g, node)
        return t

    @classmethod
    def from_named(cls, nodes: Dict[str, object]
                   ) -> Tuple["TransformTable", Dict[str, int]]:
        t = cls.zeros(len(nodes) + 1)
        index: Dict[str, int] = {}
        for i, (name, node) in enumerate(nodes.items(), start=1):
            index[name] = i
            t.set_node(i, node)
        return t, index

    @classmethod
    def from_vocab(cls, nodes: Dict[str, object], vocab: Dict[str, int],
                   dim: int) -> "TransformTable":
        """A row a scoring column (the serve layout); names outside the
        vocab drop before the replay."""
        t = cls.zeros(max(dim, 1))
        for name, node in nodes.items():
            col = vocab.get(name)
            if col is not None:
                t.set_node(col, node)
        return t


def apply_nodes(table: TransformTable, gi: np.ndarray, val: np.ndarray,
                nodeless_zero: bool = False) -> np.ndarray:
    """The vectorized TransformNode replay: `gi` indexes rows of `table`,
    `val` is float64; returns float64."""
    h = table.has[gi]
    stdv = table.std[gi]
    std_ok = table.is_std[gi] & (stdv >= 1e-6)
    val = np.where(h & std_ok,
                   (val - table.mean[gi]) / np.where(stdv == 0, 1, stdv),
                   val)
    span = table.mx[gi] - table.mn[gi]
    small = np.abs(span) < 1e-6
    # a * (b / c), the scalar transform's association
    scaled = np.where(
        small, 1.0,
        table.rmin[gi] + (table.rmax[gi] - table.rmin[gi])
        * ((val - table.mn[gi]) / np.where(small, 1, span)))
    val = np.where(h & ~table.is_std[gi], scaled, val)
    if nodeless_zero:
        val = np.where(h, val, 0.0)
    return val


class TransformPipeline:
    """The raw-features front door of one loaded model: the full stage of
    the convex and GBST families, or the identity assembly of GBDT."""

    def __init__(self, *, vocab: Optional[Dict[str, int]] = None,
                 dim: int = 0, bias_col: Optional[int] = None,
                 fill: float = 0.0, bias_name: Optional[str] = None,
                 feature_hash=None,
                 nodes: Optional[Dict[str, object]] = None,
                 transform_on: bool = False, identity: bool = False):
        self.vocab = vocab
        self.dim = dim
        self.bias_col = bias_col
        self.fill = fill
        self.bias_name = bias_name
        self.feature_hash = feature_hash
        self.transform_on = transform_on
        self.identity = identity
        nodes = dict(nodes or {})
        self._table, self._index = TransformTable.from_named(nodes)
        self._col_table = (TransformTable.from_vocab(nodes, vocab, dim)
                           if vocab is not None and not identity else None)
        # raw name -> (column, murmur sign), bounded (YTK_TRANSFORM_CACHE):
        # past the bound new names compute uncached
        self._hash_cache: Dict[str, Tuple[int, float]] = {}
        self._hash_cache_cap = max(
            int(knobs.get_int("YTK_TRANSFORM_CACHE")), 0)
        self._hash_lock = threading.Lock()

    @classmethod
    def for_identity(
        cls, vocab: Dict[str, int], dim: int, fill: float
    ) -> "TransformPipeline":
        return cls(vocab=vocab, dim=dim, fill=fill, identity=True)

    def prep_row(self, features: Dict[str, float]) -> List[Tuple[str, float]]:
        """Bias removal, hashing when configured, and the replay of one
        feature dict (a convex predictor's `_prep`)."""
        items = [(n, v) for n, v in features.items() if n != self.bias_name]
        if self.feature_hash is not None:
            items = self.feature_hash.hash_features(items)
        if not self.transform_on or not items:
            return items
        idx = np.fromiter((self._index.get(n, 0) for n, _ in items),
                          np.int64, len(items))
        vals = np.fromiter((v for _, v in items), np.float64, len(items))
        out = apply_nodes(self._table, idx, vals, nodeless_zero=True)
        return [(items[i][0], float(out[i])) for i in range(len(items))]

    def _resolve_hashed(self, keys: Sequence[str]
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Raw names -> (vocab column or -1, murmur sign), cached."""
        cache, vocab, fh = self._hash_cache, self.vocab, self.feature_hash
        cols = np.empty(len(keys), np.int64)
        signs = np.empty(len(keys), np.float64)
        misses: Dict[str, Tuple[int, float]] = {}
        for i, name in enumerate(keys):
            hit = cache.get(name)
            if hit is None:
                if name == self.bias_name:
                    hit = (-1, 1.0)
                else:
                    hashed, sign = fh.hash_name(name)
                    hit = (vocab.get(hashed, -1), sign)
                misses[name] = hit
            cols[i], signs[i] = hit
        if misses:
            with self._hash_lock:
                room = self._hash_cache_cap - len(cache)
                if room > 0:
                    cache.update(itertools.islice(misses.items(), room))
        return cols, signs

    def featurize(self, rows: Sequence[Dict[str, float]]) -> np.ndarray:
        """Request dicts -> dense (B, dim) float64 in one batched stage,
        row by row what `prep_row` gives, scattered against the vocab."""
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
        hashing = self.feature_hash is not None and not self.identity
        if hashing and keys:
            jj, signs = self._resolve_hashed(keys)
        else:
            # the bias name has no vocab column (it rides bias_col), so
            # the lookup drops it as prep_row does
            jj = np.fromiter(map(self.vocab.get, keys, itertools.repeat(-1)),
                             np.int64, len(keys))
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
        ii, jj, vv = ii[m], jj[m], vv[m]
        if hashing and len(ii):
            # collisions add their signed values in request order: the
            # additions of hash_features' dict, in its order (fill is 0.0)
            np.add.at(X, (ii, jj), vv * signs[m])
            flat = np.unique(ii * np.int64(self.dim) + jj)
            ii, jj = flat // self.dim, flat % self.dim
        else:
            X[ii, jj] = vv
        if self.transform_on and not self.identity and len(ii):
            X[ii, jj] = apply_nodes(self._col_table, jj, X[ii, jj],
                                    nodeless_zero=True)
        if self.bias_col is not None:
            X[:, self.bias_col] = 1.0
        return X
