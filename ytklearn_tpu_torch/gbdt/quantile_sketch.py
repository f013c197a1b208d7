"""Streaming weighted quantile sketch: the memory-bounded host binning path.

The port's copy of ``ytklearn_tpu/gbdt/quantile_sketch.py``, the rebuild of
the reference's utils/WeightApproximateQuantile.java (the GK-style weighted
quantile summary behind sample_by_quantile, SampleManager.java:128-143):

  Summary   (value, rmin, rmax, w) entries whose [rmin, rmax] bound the
            true weighted rank of each value (WeightApproximateQuantile
            .java:237-251). Built exactly from a chunk (sort + cumsum),
            merged by the rank combination (merge:476, one vectorised
            searchsorted a side), pruned by querying evenly spaced ranks
            (compress:418).
  WeightedQuantileSketch  the level cascade (update:93-117): a binary
            counter of summaries, level l holding the merge of 2^l chunks,
            so the prune error stays O(eps * log(n / chunk)).

Error bound: an exact chunk summary has rank error 0; a merge adds none;
each prune to `b` entries adds <= B/(2b) (the midpoint query of the
interval bounds). With the cascade a value's error is at most
(levels + 1) * B/(2b).

numpy only: this runs on the host at binning time and streams chunks that
never materialise the full column; gbdt/binning.py uses it above
YTK_SKETCH_ROWS rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


@dataclass
class Summary:
    """Weighted rank summary; `value` sorted ascending, ranks in weight
    units: rmin[i] = lower bound of sum(w of entries < value[i]) plus this
    entry's own start, rmax[i] = upper bound including the entry."""

    value: np.ndarray  # (k,) f64 sorted
    rmin: np.ndarray  # (k,) f64
    rmax: np.ndarray  # (k,) f64
    w: np.ndarray  # (k,) f64
    total: float  # B: total pushed weight

    @property
    def size(self) -> int:
        return len(self.value)

    @classmethod
    def from_exact(cls, values: np.ndarray, weights: Optional[np.ndarray] = None) -> "Summary":
        """Exact summary of a chunk: duplicates grouped, rmin/rmax tight
        (reference Summary.sort:303-310 after an insert phase)."""
        v = np.asarray(values, np.float64)
        if weights is None:
            w = np.ones_like(v)
        else:
            w = np.asarray(weights, np.float64)
        order = np.argsort(v, kind="stable")
        v, w = v[order], w[order]
        uv, start = np.unique(v, return_index=True)
        gw = np.add.reduceat(w, start) if len(v) else np.zeros(0)
        cum = np.cumsum(gw)
        return cls(
            value=uv,
            rmin=cum - gw,
            rmax=cum,
            w=gw,
            total=float(cum[-1]) if len(cum) else 0.0,
        )

    def query_values(self, max_cnt: int) -> np.ndarray:
        """Candidates at max_cnt evenly spaced weighted ranks, midpoint
        rule on [rmin, rmax] (SampleByQuantile.java:60-105 query loop)."""
        if self.size == 0:
            return np.zeros(0, np.float32)
        ranks = (np.arange(1, max_cnt + 1) / max_cnt) * self.total
        mid = 0.5 * (self.rmin + self.rmax)
        pos = np.searchsorted(mid, ranks, side="left").clip(0, self.size - 1)
        return np.unique(self.value[pos].astype(np.float32))


def merge_summaries(a: Summary, b: Summary) -> Summary:
    """Rank-combining merge (reference merge:476-560, vectorized).

    For each entry of one side, the other side contributes
      rmin += rmin[last entry with value <= v]      (0 if none)
      rmax += rmax[first entry with value >= v] - w[that entry]
              (or its full rmax when no larger entry exists)
    which keeps [rmin, rmax] true bounds of the combined rank."""
    if a.size == 0:
        return b
    if b.size == 0:
        return a

    def deltas(v, other: Summary):
        ls = np.searchsorted(other.value, v, side="right") - 1
        ls_c = np.maximum(ls, 0)
        # strictly-smaller entries contribute their own point mass to the
        # lower bound too (tight variant — the reference's rmin[LS] alone
        # is valid but loose; cf. merge:476 thatLSPointer delta)
        eq = (ls >= 0) & (other.value[ls_c] == v)
        rmin_d = np.where(
            ls >= 0,
            other.rmin[ls_c] + np.where(eq, 0.0, other.w[ls_c]),
            0.0,
        )
        sl = np.searchsorted(other.value, v, side="left")
        in_range = sl < other.size
        sl_c = np.minimum(sl, other.size - 1)
        rmax_d = np.where(
            in_range, other.rmax[sl_c] - other.w[sl_c], other.rmax[-1]
        )
        return rmin_d, rmax_d

    # exact-tie handling: an entry of `a` with the same value as one in `b`
    # coalesces (both sides' mass belongs to the same value)
    a_rmin_d, a_rmax_d = deltas(a.value, b)
    b_rmin_d, b_rmax_d = deltas(b.value, a)
    v = np.concatenate([a.value, b.value])
    rmin = np.concatenate([a.rmin + a_rmin_d, b.rmin + b_rmin_d])
    rmax = np.concatenate([a.rmax + a_rmax_d, b.rmax + b_rmax_d])
    w = np.concatenate([a.w, b.w])
    order = np.argsort(v, kind="stable")
    v, rmin, rmax, w = v[order], rmin[order], rmax[order], w[order]
    # coalesce duplicate values: they represent the same point mass; keep
    # the widest valid bounds and the summed weight
    uv, start = np.unique(v, return_index=True)
    if len(uv) != len(v):
        rmin = np.minimum.reduceat(rmin, start)
        rmax = np.maximum.reduceat(rmax, start)
        w = np.add.reduceat(w, start)
        v = uv
        # twin entries each excluded the other's mass AT the value from
        # their rmax (reference SL-pointer convention); restore the upper
        # bound so rmax >= rmin + own mass stays true after coalescing
        rmax = np.maximum(rmax, rmin + w)
    return Summary(value=v, rmin=rmin, rmax=rmax, w=w, total=a.total + b.total)


def prune_summary(s: Summary, b: int) -> Summary:
    """Keep entries at ~b evenly spaced ranks (+ both extremes), the
    compress step (reference compress:418-473). Adds <= B/(2b) rank error."""
    if s.size <= b + 1:
        return s
    mid = 0.5 * (s.rmin + s.rmax)
    ranks = (np.arange(1, b) / b) * s.total
    keep = np.searchsorted(mid, ranks, side="left").clip(0, s.size - 1)
    keep = np.unique(np.concatenate([[0], keep, [s.size - 1]]))
    return Summary(
        value=s.value[keep],
        rmin=s.rmin[keep],
        rmax=s.rmax[keep],
        w=s.w[keep],
        total=s.total,
    )


class WeightedQuantileSketch:
    """Chunked streaming sketch with the reference's level cascade
    (update:93-117): level l holds a pruned summary of 2^l chunks; pushing
    a chunk carry-merges like a binary counter."""

    def __init__(self, b: int = 1024, chunk_rows: int = 1 << 20):
        self.b = int(b)
        self.chunk_rows = int(chunk_rows)
        self.levels: List[Optional[Summary]] = []
        self._buf_v: List[np.ndarray] = []
        self._buf_w: List[np.ndarray] = []
        self._buffered = 0
        self._pruned = False  # True once any prune actually dropped entries

    @property
    def is_exact(self) -> bool:
        """True while no prune has dropped entries — every distinct pushed
        value is still in the summary with exact rank bounds (low-
        cardinality columns never overflow b, so their sketch stays a
        perfect distinct-value table)."""
        return not self._pruned

    def _prune(self, s: Summary) -> Summary:
        out = prune_summary(s, self.b)
        if out.size < s.size:
            self._pruned = True
        return out

    def push(self, values: np.ndarray, weights: Optional[np.ndarray] = None) -> None:
        values = np.asarray(values)
        self._buf_v.append(values)
        self._buf_w.append(
            np.asarray(weights)
            if weights is not None
            else np.ones(len(values), np.float64)
        )
        self._buffered += len(values)
        while self._buffered >= self.chunk_rows:
            self._flush_chunk()

    def _take_chunk(self):
        out_v: List[np.ndarray] = []
        out_w: List[np.ndarray] = []
        need = self.chunk_rows
        while need > 0 and self._buf_v:
            v, w = self._buf_v[0], self._buf_w[0]
            if len(v) <= need:
                out_v.append(v)
                out_w.append(w)
                self._buf_v.pop(0)
                self._buf_w.pop(0)
                need -= len(v)
            else:
                out_v.append(v[:need])
                out_w.append(w[:need])
                self._buf_v[0] = v[need:]
                self._buf_w[0] = w[need:]
                need = 0
        self._buffered -= sum(len(v) for v in out_v)
        return np.concatenate(out_v), np.concatenate(out_w)

    def _flush_chunk(self) -> None:
        v, w = self._take_chunk()
        s = self._prune(Summary.from_exact(v, w))
        lvl = 0
        while True:
            if lvl == len(self.levels):
                self.levels.append(s)
                break
            if self.levels[lvl] is None:
                self.levels[lvl] = s
                break
            s = self._prune(merge_summaries(self.levels[lvl], s))
            self.levels[lvl] = None
            lvl += 1

    def summary(self) -> Summary:
        """Merge every level + the partial buffer (mergeAll:118-131).
        Does not consume the sketch."""
        parts: List[Summary] = [s for s in self.levels if s is not None]
        if self._buffered:
            v = np.concatenate(self._buf_v)
            w = np.concatenate(self._buf_w)
            parts.append(self._prune(Summary.from_exact(v, w)))
        if not parts:
            return Summary.from_exact(np.zeros(0), np.zeros(0))
        out = parts[0]
        for p in parts[1:]:
            out = merge_summaries(out, p)
        return out

    def query_values(self, max_cnt: int) -> np.ndarray:
        return self.summary().query_values(max_cnt)
