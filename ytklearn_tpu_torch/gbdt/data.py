"""GBDT data: the training container and the text ingest
(``ytklearn_tpu/gbdt/data.py``, reference dataflow/GBDTCoreData.java and
feature/gbdt/missing/*).

GBDTData: X is a dense (n, F) float32 matrix with NaN marking a missing
value, as a numpy array or as a torch tensor (which may already lie on the
training device: a generator can make it there and skip the host copy).

GBDTIngest parses ytklearn text lines (`weight###label###name:val,...`)
into that matrix and fills the missing values with the configured strategy
(`value@v`, `mean`, `quantile@q`), the semantics of the reference's Python
path: columns in the order features are first seen in the training data,
the test data read through that frozen map (unseen features skipped),
`max_feature_dim` overflow as an error line, `max_error_tol`. `_parse`
dispatches to the native C++ parser (io/native.py, `_parse_native`: a
columnar parse and a vectorised assembly of the matrix) unless a python
transform hook is set, a delimiter is one it does not take, or
YTK_NO_NATIVE is on at that call; `_parse_python` is the Python parser.
Both give the same rows, errors and columns; the native path parses
values as float32, as the JAX package's native path does. `parser` names
the one the last `_parse` ran.

Under `--coordinator` each process parses its shard (io/reader.py::
shard_plan) and `load` merges over host_allgather_objects what the
reference merges (data.py:315-435): an empty shard raises on every rank,
the first-seen feature dicts become one sorted name -> column map, and the
`mean` fill (exact) and `quantile` fill (per-process quantile grids merged
as weighted sketches) are global.
"""

from __future__ import annotations

import logging
from array import array
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config.params import GBDTParams
from ..io import native
from ..io.fs import LocalFileSystem
from ..io.reader import parse_line, shard_plan, shard_read_lines
from ..obs import inc as obs_inc, span as obs_span

log = logging.getLogger("ytklearn_tpu_torch.ingest")

Array = Union[np.ndarray, torch.Tensor]


@dataclass
class GBDTData:
    X: Array  # (n, F) f32, NaN = missing until filled
    y: Array  # (n,) f32
    weight: Array  # (n,) f32
    n_real: int
    feature_names: List[str]  # index -> name
    missing_fill: Optional[np.ndarray] = None  # (F,) fill values used

    @property
    def n(self) -> int:
        return int(self.X.shape[0])

    @property
    def n_features(self) -> int:
        return int(self.X.shape[1])

    def pad_rows(self, multiple: int) -> "GBDTData":
        """Zero rows (weight 0, label 0) up to a multiple of `multiple`;
        n_real stays (reference data.py:43)."""
        n = self.n
        target = (n + multiple - 1) // multiple * multiple
        if target == n:
            return self
        pad = target - n
        X, y, w = (np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
                   for a in (self.X, self.y, self.weight))
        return GBDTData(
            X=np.pad(X, ((0, pad), (0, 0))),
            y=np.pad(y, ((0, pad),) + ((0, 0),) * (y.ndim - 1)),
            weight=np.pad(w, (0, pad)),
            n_real=self.n_real, feature_names=self.feature_names,
            missing_fill=self.missing_fill,
        )


class GBDTIngest:
    """Parse ytklearn lines into the dense matrix; compute and apply the
    missing-value fill (reference: FillMissingValue.java:49,61)."""

    def __init__(self, params: GBDTParams, fs=None, transform_hook=None):
        self.params = params
        self.fs = fs or LocalFileSystem()
        self.transform_hook = transform_hook
        if params.data.max_feature_dim <= 0:
            raise ValueError("gbdt requires data.max_feature_dim")
        self.F = params.data.max_feature_dim
        self.K = params.class_num if params.loss_function == "softmax" else 1
        self.parser: Optional[str] = None  # native | python, the last parse

    def _lines(self, paths):
        """Raw lines, expanded through the python transform hook when one
        is configured (reference: Jython transform, CoreData.java:298)."""
        for raw in shard_read_lines(self.fs, self.params.data, paths):
            if self.transform_hook is None:
                yield raw
            else:
                yield from self.transform_hook(raw.encode())

    def _parse(self, paths, max_error_tol: int,
               fmap: Optional[Dict[str, int]] = None,
               frozen: bool = False) -> GBDTData:
        """fmap: feature name -> dense column, grown in first-seen order
        while parsing train data, frozen for test data (the reference's
        OnlineFeatureMap, GBDTCoreData.java:371-381: unseen test features
        are skipped, train overflow past max_feature_dim is an error line).
        A line that fails to parse counts toward max_error_tol and claims
        no column; a duplicate feature keeps its last value. Dispatches to
        the native parser when it can run (reference gbdt/data.py:90)."""
        fast = native.use_native(self.params.data.delim, self.transform_hook)
        self.parser = "native" if fast else "python"
        log.info("gbdt ingest: the %s parser", self.parser)
        if fast:
            return self._parse_native(paths, max_error_tol, fmap, frozen)
        return self._parse_python(paths, max_error_tol, fmap, frozen)

    def _parse_native(self, paths, max_error_tol: int,
                      fmap: Optional[Dict[str, int]] = None,
                      frozen: bool = False) -> GBDTData:
        """Columnar native parse -> vectorised dense-matrix assembly
        (reference gbdt/data.py:112-237)."""
        dp = self.params.data
        paths, divisor, remainder = shard_plan(self.fs, dp, paths)
        d = dp.delim
        blk = native.parse_paths(
            self.fs, paths, d.x_delim, d.y_delim, d.features_delim,
            d.feature_name_val_delim, divisor=divisor, remainder=remainder)
        n_errors = blk.n_errors
        bad, y_all = native.expand_labels_columnar(blk.label_ptr, blk.labels,
                                                   blk.n, self.K)
        n_errors += int(bad.sum())
        keep = ~bad
        # name -> column, continuing fmap; a bad-label row claims no column
        # (the Python path stages names until a whole line validates), and
        # names go in by first-seen (row, position) order over kept rows
        if fmap is None:
            fmap = {}
        rows_all = np.repeat(np.arange(blk.n), np.diff(blk.row_ptr))
        kept_feat = keep[rows_all]
        col_of_local = np.full(len(blk.names), -1, np.int64)
        unknown = []
        for lid, name in enumerate(blk.names):
            idx = fmap.get(name)
            if idx is not None:
                col_of_local[lid] = idx
            else:
                unknown.append(lid)
        if unknown and not frozen:
            unk_mask = np.zeros(len(blk.names), bool)
            unk_mask[np.asarray(unknown, np.int64)] = True
            sel = kept_feat & unk_mask[blk.feat_ids]
            u_rows = rows_all[sel]
            u_ids = blk.feat_ids[sel]
            present = np.unique(u_ids)
            if len(fmap) + len(present) <= self.F:
                # everything fits: global first-seen order, vectorised
                first_idx = np.full(len(blk.names), np.iinfo(np.int64).max)
                np.minimum.at(first_idx, u_ids, np.arange(len(u_ids)))
                for lid in present[np.argsort(first_idx[present],
                                              kind="stable")]:
                    fmap[blk.names[lid]] = len(fmap)
                    col_of_local[lid] = fmap[blk.names[lid]]
            else:
                n_errors, keep = self._claim_rows(
                    blk, u_rows, u_ids, col_of_local, fmap, keep, n_errors,
                    max_error_tol)
                kept_feat = keep[rows_all]
        if n_errors > max_error_tol:
            raise ValueError(f"data error lines ({n_errors}) exceed "
                             f"max_error_tol ({max_error_tol})")
        self._fmap = fmap
        # the last in-row occurrence of a (row, column) pair wins, as the
        # Python path's sequential stores do
        new_row = np.cumsum(keep) - 1
        n = int(keep.sum())
        X = np.full((n, self.F), np.nan, np.float32)
        cols = col_of_local[blk.feat_ids]
        m = kept_feat & (cols >= 0)
        r = new_row[rows_all[m]]
        c = cols[m]
        v = blk.feat_vals[m]
        flat = r * np.int64(self.F) + c
        last = len(flat) - 1 - np.unique(flat[::-1], return_index=True)[1]
        X[r[last], c[last]] = v[last]
        return GBDTData(X=X, y=y_all[keep],
                        weight=blk.weights[keep].astype(np.float32),
                        n_real=n, feature_names=self._names_from_fmap(fmap))

    def _claim_rows(self, blk, u_rows, u_ids, col_of_local, fmap, keep,
                    n_errors, max_error_tol):
        """max_feature_dim overflow, row by row as the Python path: a row
        whose new names would pass it is an error line that claims no
        column (later rows may still claim its other names). Returns
        (n_errors, keep)."""
        bad_cap = np.zeros(blk.n, bool)
        last_name = ""
        boundaries = np.flatnonzero(np.diff(u_rows)) + 1
        for g in np.split(np.arange(len(u_rows)), boundaries):
            if len(g) == 0:
                continue
            staged: List[int] = []
            seen = set()
            ok = True
            for occ in g:
                lid = int(u_ids[occ])
                if col_of_local[lid] >= 0 or lid in seen:
                    continue
                if len(fmap) + len(staged) >= self.F:
                    ok = False
                    last_name = blk.names[lid]
                    break
                seen.add(lid)
                staged.append(lid)
            if ok:
                for lid in staged:
                    fmap[blk.names[lid]] = len(fmap)
                    col_of_local[lid] = fmap[blk.names[lid]]
            else:
                bad_cap[u_rows[g[0]]] = True
        n_errors += int(bad_cap.sum())
        if n_errors > max_error_tol:
            raise ValueError(
                f"max_feature_dim({self.F}) smaller than real feature "
                f"number in data set (feature {last_name!r})")
        return n_errors, keep & ~bad_cap

    def _parse_python(self, paths, max_error_tol: int,
                      fmap: Optional[Dict[str, int]] = None,
                      frozen: bool = False) -> GBDTData:
        """The Python parser (also the transform-hook path). The matrix is
        filled in one scatter at the end: the reference's Python path
        (gbdt/data.py:238) value for value."""
        delim = self.params.data.delim
        if fmap is None:
            fmap = {}
        weights: List[float] = []
        labels_all: list = []
        counts: List[int] = []
        cols, vals = array("q"), array("d")  # flat (column, value) pairs
        errors = 0
        for line in self._lines(paths):
            s = line.strip()
            if not s:
                continue
            try:
                pl = parse_line(s, delim)
                names = [name for name, _ in pl.feats]
                fv = [v for _, v in pl.feats]
                idxs = [fmap.get(name) for name in names]
                staged: Dict[str, int] = {}
                if None in idxs:
                    idxs, fv, staged = self._claim(names, idxs, fv, fmap,
                                                   frozen)
                labels = pl.labels
                if self.K > 1:
                    if len(labels) == 1:
                        c = int(labels[0])
                        labels = [0.0] * self.K
                        labels[c] = 1.0
                    elif len(labels) != self.K:
                        raise ValueError("label width mismatch")
            except (ValueError, IndexError, OverflowError):
                errors += 1
                if errors > max_error_tol:
                    raise
                continue
            fmap.update(staged)  # new names claim columns once a line is clean
            weights.append(pl.weight)
            labels_all.append(labels if self.K > 1 else labels[0])
            counts.append(len(idxs))
            cols.extend(idxs)
            vals.extend(fv)

        self._fmap = fmap
        n = len(weights)
        X = np.full((n, self.F), np.nan, np.float32)
        if len(cols):
            flat = (np.repeat(np.arange(n, dtype=np.int64), counts)
                    * self.F + np.frombuffer(cols, np.int64))
            # the last occurrence of a (row, column) pair wins, as the
            # sequential stores of the reference's loop do
            last = len(flat) - 1 - np.unique(flat[::-1], return_index=True)[1]
            X.reshape(-1)[flat[last]] = np.frombuffer(vals, np.float64)[last]
        weight = np.asarray(weights, np.float32)
        y = np.asarray(labels_all, np.float32).reshape(
            (n, self.K) if self.K > 1 else (n,))
        return GBDTData(X=X, y=y, weight=weight, n_real=n,
                        feature_names=self._names_from_fmap(fmap))

    def _claim(self, names, idxs, fv, fmap, frozen):
        """A line naming features fmap does not hold: test-only features
        are dropped (frozen), new training features are staged in
        first-seen order, and a column past max_feature_dim raises. Returns
        the line's (columns, values, staged names)."""
        staged: Dict[str, int] = {}
        out_i: List[int] = []
        out_v: List[float] = []
        for name, idx, v in zip(names, idxs, fv):
            if idx is None:
                idx = staged.get(name)
            if idx is None:
                if frozen:
                    continue  # test-only feature: ignored
                idx = len(fmap) + len(staged)
                if idx >= self.F:
                    raise ValueError(
                        f"max_feature_dim({self.F}) smaller than real "
                        f"feature number in data set (feature {name!r})"
                    )
                staged[name] = idx
            out_i.append(idx)
            out_v.append(v)
        return out_i, out_v, staged

    def _names_from_fmap(self, fmap: Dict[str, int]) -> List[str]:
        """index -> name; unclaimed dense columns keep numeric names."""
        names = [str(i) for i in range(self.F)]
        for name, idx in fmap.items():
            names[idx] = name
        return names

    def compute_missing_fill(self, X: np.ndarray) -> np.ndarray:
        """(F,) fill values of the configured strategy (reference:
        ComputeMean.java:71, ComputeQuantile.java:72, ComputeValue):
        `value[@v]` (v, default 0), `mean` (f64 mean of the present
        values, 0 for an empty column), `quantile[@q]` (np.nanquantile,
        q default 0.5, 0 for an empty column)."""
        spec = self.params.missing_value
        base, _, arg = str(spec).partition("@")
        base = base.lower()
        if base == "value":
            v = float(arg) if arg else 0.0
            return np.full((X.shape[1],), v, np.float32)
        from ..parallel.collectives import host_allgather_objects
        from ..parallel.mesh import process_count

        if base == "mean":
            # exact across processes: the sums and counts are gathered
            sums = np.nansum(X, axis=0, dtype=np.float64)
            cnts = np.sum(~np.isnan(X), axis=0, dtype=np.int64)
            merged = host_allgather_objects((sums, cnts))
            tot = np.sum([m[0] for m in merged], axis=0)
            cnt = np.sum([m[1] for m in merged], axis=0)
            with np.errstate(invalid="ignore", divide="ignore"):
                fill = np.where(cnt > 0, tot / np.maximum(cnt, 1), 0.0)
            return fill.astype(np.float32)
        if base == "quantile":
            q = float(arg) if arg else 0.5
            if process_count() == 1:
                with np.errstate(invalid="ignore", all="ignore"):
                    fill = np.nanquantile(X, q, axis=0)
                return np.nan_to_num(fill, nan=0.0).astype(np.float32)
            # local quantile grids merge as weighted sketches (approximate,
            # as the reference's GK summaries are)
            from .binning import merge_quantile_candidates

            grid = np.linspace(0.0, 1.0, 257)
            with np.errstate(invalid="ignore", all="ignore"):
                local = np.nanquantile(X, grid, axis=0)  # (257, F)
            cnts = np.sum(~np.isnan(X), axis=0, dtype=np.int64)
            merged = host_allgather_objects((local, cnts))
            fill = np.zeros((X.shape[1],), np.float32)
            for f in range(X.shape[1]):
                pairs = []
                for m in merged:
                    vals = m[0][:, f]
                    vals = vals[~np.isnan(vals)]
                    mass = float(m[1][f])
                    if len(vals) and mass > 0:
                        pairs.append((vals, mass))
                if not pairs:
                    continue
                cand = merge_quantile_candidates(
                    [pr[0] for pr in pairs], [pr[1] for pr in pairs], 257)
                fill[f] = cand[min(int(q * (len(cand) - 1) + 0.5),
                                   len(cand) - 1)]
            return fill
        raise ValueError(f"unknown missing_value strategy: {spec!r}")

    def _merge_fmap_multihost(self, train: GBDTData) -> GBDTData:
        """The processes' first-seen feature dicts as one sorted name ->
        column map, the local matrix remapped to it (reference data.py:373,
        DataFlow.handleLocalIdx:413-446). One process: as it is."""
        from ..parallel.collectives import host_allgather_objects

        gathered = host_allgather_objects(sorted(self._fmap))
        if len(gathered) == 1:
            return train
        names = sorted(set().union(*[set(g) for g in gathered]))
        if len(names) > self.F:
            raise ValueError(
                f"max_feature_dim({self.F}) smaller than global feature "
                f"number {len(names)}")
        gmap = {n: i for i, n in enumerate(names)}
        X = np.full_like(train.X, np.nan)
        for name, old in self._fmap.items():
            X[:, gmap[name]] = train.X[:, old]
        self._fmap = gmap
        return GBDTData(X=X, y=train.y, weight=train.weight,
                        n_real=train.n_real,
                        feature_names=self._names_from_fmap(gmap))

    def load(self) -> Tuple[GBDTData, Optional[GBDTData]]:
        """(train, test or None): both parsed, filled with the training
        data's fill values."""
        p = self.params
        with obs_span("ingest.parse", split="train", path="gbdt"):
            train = self._parse(p.data.train_paths,
                                p.data.train_max_error_tol)
        obs_inc("ingest.rows", train.n_real)
        from ..parallel.collectives import host_allgather_objects

        # raise on every rank: a lone raise would leave the peers blocked
        # in the next collective
        counts = host_allgather_objects(train.n_real)
        if len(counts) > 1 and min(counts) == 0:
            raise ValueError(
                f"process(es) {[i for i, c in enumerate(counts) if c == 0]} "
                f"got an empty training shard ({p.data.unassigned_mode} over "
                f"{len(p.data.train_paths)} path(s)): use lines_avg sharding "
                "or fewer processes")
        if train.n_real == 0:
            raise ValueError(
                f"empty training data ({len(p.data.train_paths)} path(s))")
        train = self._merge_fmap_multihost(train)
        fill = self.compute_missing_fill(train.X)
        train.missing_fill = fill
        _apply_fill(train.X, fill)
        test = None
        if p.data.test_paths:
            with obs_span("ingest.parse", split="test", path="gbdt"):
                test = self._parse(p.data.test_paths,
                                   p.data.test_max_error_tol,
                                   fmap=self._fmap, frozen=True)
            obs_inc("ingest.rows", test.n_real)
            test.missing_fill = fill
            _apply_fill(test.X, fill)
        return train, test


def _apply_fill(X: np.ndarray, fill: np.ndarray) -> None:
    """In-place NaN -> per-feature fill (reference: FillMissingValue.java:49)."""
    nan_rows, nan_cols = np.where(np.isnan(X))
    X[nan_rows, nan_cols] = fill[nan_cols]


def to_tensor(a: Array, dtype: torch.dtype, device) -> torch.Tensor:
    """numpy array or tensor -> contiguous `dtype` tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        device=device, dtype=dtype).contiguous()
