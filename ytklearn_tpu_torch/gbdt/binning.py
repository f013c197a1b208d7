"""Feature binning on the training device, and the bin-edge sidecar.

The counterpart of the device path of ``ytklearn_tpu/gbdt/binning.py``:

  FeatureBins          per-feature sorted representative values (:45)
  quantile_bins_device sample_by_quantile with one sort per feature (:725)
  build_bins_maybe_device  the single-quantile-spec bin builder (:789)
  bin_matrix_device    value -> nearest-representative bin, (F, n) (:824)
  bin_matrix           the same rule on a host (n, F) matrix (:854)
  efb_candidates       EFB's column filter (:560)
  BundlePlan, plan_bundles, build_bundle_plan, bundle_bin_matrix_t
                       exclusive feature bundling (:479-724): the greedy
                       plan over exact conflict counts, the offset-binned
                       bundle columns and the member range tables
  bin_edges_path, model_text_digest, dump_bin_edges  the `.bins.json`
                       sidecar the trainer writes before the model (:371)
  load_bin_edges       its reader, with the model-digest check (:411),
                       for the binned serving rung

A value maps to the NEAREST representative: i = first index with
values[i] >= v; if i >= 1 and v < midpoint(values[i-1], values[i]) then
i - 1 (a value exactly at a midpoint rounds up); NaN and values above the
last representative go to the last bin. The midpoint compare runs in f32.

Only the single `sample_by_quantile` spec is ported; any other sampler
raises NotImplementedError (ROADMAP.md 1.5, the host samplers).
"""

from __future__ import annotations

import hashlib
import json
import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.params import ApproximateSpec, GBDTParams
from .data import Array, to_tensor
from .engine import ordered_cumsum

log = logging.getLogger(__name__)

#: EFB candidate pre-filter: a column this dense can never bundle usefully
EFB_MAX_DENSITY = 0.5
#: skip EFB planning past this many candidate columns (the conflict matrix
#: is O(C^2))
EFB_MAX_CANDIDATES = 4096
BIN_EDGES_SCHEMA = "ytk-bin-edges"


@dataclass
class FeatureBins:
    """Per-feature sorted representative values, padded to a common width.

    values[f, :counts[f]] are real; padding slots repeat the last value so
    searchsorted stays monotone."""

    values: np.ndarray  # (F, B) f32 sorted per row
    counts: np.ndarray  # (F,) int32
    max_bins: int
    exact: Optional[np.ndarray] = None

    def split_value(self, fid: int, lo: int, hi: Optional[int] = None,
                    split_type: str = "mean") -> float:
        """Split cond for 'bins <= lo go left', where [lo, hi] is the split
        interval (the JAX package's FeatureBins.split_value)."""
        v = self.values[fid]
        cnt = int(self.counts[fid])
        if hi is None:
            hi = lo + 1
        hi = min(hi, cnt - 1)
        if split_type == "median":
            s = lo + hi
            if s % 2 == 0:
                return float(v[s // 2])
            return 0.5 * (float(v[(s - 1) // 2]) + float(v[(s + 1) // 2]))
        return 0.5 * (float(v[lo]) + float(v[hi]))


def _to_feature_bins(per_feature: List[np.ndarray]) -> FeatureBins:
    """Pad per-feature sorted candidate lists to a common width (padding
    repeats the last value so searchsorted stays monotone)."""
    max_bins = max(len(v) for v in per_feature)
    F = len(per_feature)
    values = np.empty((F, max_bins), np.float32)
    counts = np.empty((F,), np.int32)
    for f, v in enumerate(per_feature):
        values[f, : len(v)] = v
        values[f, len(v):] = v[-1]
        counts[f] = len(v)
    return FeatureBins(values=values, counts=counts, max_bins=max_bins)


def _weight_tensor(weight: Optional[Array], device) -> Optional[torch.Tensor]:
    return None if weight is None else to_tensor(weight, torch.float32, device)


def quantile_bins_device(
    X_t: torch.Tensor, weight: Optional[Array], spec: ApproximateSpec,
) -> Tuple[np.ndarray, np.ndarray]:
    """sample_by_quantile on the device: candidates at max_cnt evenly
    spaced weighted ranks of each sorted column.

    X_t: (F, n) f32 tensor. Returns (candidates (F, max_cnt) f32 with
    possible duplicates, distinct counts (F,)) on the host; the caller
    dedupes per feature. NaN sorts last and counts as a distinct value
    each time, as in the reference."""
    F, n = X_t.shape
    mc = spec.max_cnt
    w = _weight_tensor(weight, X_t.device)
    uniform = (
        w is None or spec.alpha == 0.0 or not spec.use_sample_weight
        or bool(w.min() == w.max())
    )
    if uniform:
        # cw[i] = i+1 -> pos = ceil(rank*n) - 1, in float64 on the host
        pos = np.clip(
            np.ceil(np.arange(1, mc + 1) / mc * n).astype(np.int64) - 1,
            0, n - 1)
        sv = torch.sort(X_t, dim=1).values
        cand = sv[:, torch.from_numpy(pos).to(X_t.device)]
    else:
        w_pow = torch.pow(torch.clamp_min(w, 0.0), spec.alpha)
        sv, order = torch.sort(X_t, dim=1, stable=True)
        sw = w_pow[order]
        cw = ordered_cumsum(sw, dim=1)
        total = cw[:, -1:]
        ranks = torch.from_numpy(
            (np.arange(1, mc + 1) / mc).astype(np.float32)).to(X_t.device)
        tgt = ranks[None, :] * total
        # first i with cw[i] >= tgt
        p = torch.searchsorted(cw.contiguous(), tgt.contiguous(), right=False)
        p = torch.clamp(p, 0, n - 1)
        cand = torch.gather(sv, 1, p)
    distinct = (sv[:, 1:] != sv[:, :-1]).sum(dim=1) + 1
    return cand.cpu().numpy(), distinct.cpu().numpy()


def build_bins_maybe_device(
    X_t: torch.Tensor, weight: Optional[Array], params: GBDTParams,
    feature_names: Optional[Sequence[str]] = None,
) -> FeatureBins:
    """Bins for a single sample_by_quantile spec, built on X_t's device.
    Features whose distinct count fits max_cnt keep every distinct value
    (NaNs collapse into one, as np.unique does)."""
    specs = params.approximate
    if len(specs) != 1 or specs[0].type != "sample_by_quantile":
        raise NotImplementedError(
            "only a single feature.approximate spec of type "
            "sample_by_quantile is ported (got "
            f"{[s.type for s in specs]}); the host samplers come with "
            "ROADMAP.md 1.5 (rest of the GBDT trainer)"
        )
    spec = specs[0]
    cand, distinct = quantile_bins_device(X_t, weight, spec)
    per_feature: List[np.ndarray] = []
    for f in range(X_t.shape[0]):
        if distinct[f] <= spec.max_cnt:
            vals = np.unique(X_t[f].cpu().numpy())
        else:
            vals = np.unique(cand[f])
        if len(vals) == 0:
            vals = np.zeros((1,), np.float32)
        per_feature.append(np.sort(vals).astype(np.float32))
    return _to_feature_bins(per_feature)


def bin_matrix_device(X_t: torch.Tensor, bins: FeatureBins) -> torch.Tensor:
    """(F, n) f32 values -> (F, n) int32 bin ids on X_t's device, one
    feature at a time (the temporaries stay O(n))."""
    dev = X_t.device
    values = torch.from_numpy(bins.values).to(dev)  # (F, Bmax)
    # a NaN representative (an unfilled column's top quantiles) is never
    # < a value; +inf is not either, and keeps the binary search monotone
    search = torch.where(torch.isnan(values), float("inf"), values)
    out = torch.empty(X_t.shape, dtype=torch.int32, device=dev)
    for f in range(X_t.shape[0]):
        col = X_t[f]
        v = values[f]
        cnt = int(bins.counts[f])
        last = v[cnt - 1]
        # count of v[i] < col over the whole padded row
        i = torch.searchsorted(search[f].contiguous(), col, right=False)
        over = (col > last) | torch.isnan(col)
        i = torch.clamp(i, 0, cnt - 1)
        prev = v[torch.clamp_min(i - 1, 0)]
        mids = 0.5 * (prev + v[i])
        i = torch.where((i >= 1) & (col < mids) & ~over, i - 1, i)
        out[f] = torch.where(over, cnt - 1, i).to(torch.int32)
    return out


def bin_matrix(X: np.ndarray, bins: FeatureBins) -> np.ndarray:
    """Host (n, F) raw values -> nearest-representative bin ids (the JAX
    package's bin_matrix, :854)."""
    n, F = X.shape
    out = np.empty((n, F), np.int32)
    for f in range(F):
        cnt = int(bins.counts[f])
        v = bins.values[f, :cnt]
        if cnt == 1:
            out[:, f] = 0
            continue
        col = X[:, f]
        i = np.searchsorted(v, col, side="left")
        over = col > v[-1]
        i = np.clip(i, 0, cnt - 1)
        mids = 0.5 * (v[np.maximum(i - 1, 0)] + v[i])
        i = np.where((i >= 1) & (col < mids) & ~over, i - 1, i)
        out[:, f] = np.where(over, cnt - 1, i)
    return out


def efb_candidates(nnz: np.ndarray, mins: np.ndarray, bins: FeatureBins,
                   n_rows: int, max_density: float = EFB_MAX_DENSITY,
                   ) -> np.ndarray:
    """Original fids eligible for bundling: sparse, non-negative, at least
    one nonzero bin, and value 0 IS bin 0."""
    out = []
    for f in range(len(nnz)):
        cnt = int(bins.counts[f])
        if (
            cnt >= 2
            and nnz[f] > 0
            and nnz[f] <= max_density * n_rows
            and mins[f] >= 0
            and float(bins.values[f, 0]) == 0.0
        ):
            out.append(f)
    return np.asarray(out, np.int64)


# ---------------------------------------------------------------------------
# Exclusive feature bundling (EFB, LightGBM section 5)
# ---------------------------------------------------------------------------
#
# A bundle column's bin 0 is the shared default (every member at its zero
# value); member j's nonzero bins 1..B_j-1 land at [lo_j, lo_j + B_j - 2],
# the lo offsets adding up the members' widths. Candidates have min >= 0
# and a lowest representative of exactly 0, so original bin 0 is value 0
# and the encoding inverts. A conflict row (two members nonzero) keeps the
# higher-offset member's bin. With a conflict budget of 0 bundling is
# lossless: split_kernel's `ranges` recover every original feature's
# splits and `unbundle_split` maps a chosen (column, slot) back.


@dataclass
class BundlePlan:
    """Column plan of an EFB-bundled bin matrix: the unbundled original
    features first, in order (`col_fid[c]` = original fid), then one
    column per bundle; `member_lo[b][k]`/`member_hi[b][k]` bound member
    k's nonzero slots in bundle b's column. Plain numpy and lists, so a
    plan read off the JAX package's BundlePlan carries over as is
    (`gbdt.state.bundle_plan_from_fields`)."""

    n_features: int
    col_fid: np.ndarray  # (U,) i32
    bundles: List[List[int]]  # each >= 2 original fids, offset order
    member_lo: List[List[int]]
    member_hi: List[List[int]]

    @property
    def n_cols(self) -> int:
        return len(self.col_fid) + len(self.bundles)

    @property
    def n_bundled_features(self) -> int:
        return sum(len(m) for m in self.bundles)

    def bundle_width(self, b: int) -> int:
        return self.member_hi[b][-1] + 1

    def range_tables(self, B: int, F_pad: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(range_lo, range_hi) (F_pad, B) int32 for split_kernel: plain
        columns get [0, B-1]; a bundle column's slot s gets the member
        range holding s; slots in no member range (bin 0, the tail) keep
        [0, B-1], harmless since they are never a valid boundary."""
        F_pad = F_pad or self.n_cols
        rlo = np.zeros((F_pad, B), np.int32)
        rhi = np.full((F_pad, B), B - 1, np.int32)
        U = len(self.col_fid)
        for b in range(len(self.bundles)):
            for lo, hi in zip(self.member_lo[b], self.member_hi[b]):
                rlo[U + b, lo:hi + 1] = lo
                rhi[U + b, lo:hi + 1] = hi
        return rlo, rhi

    def member_of_slot(self, col: int, slot: int) -> Tuple[int, int]:
        """(original fid, member lo) of the member whose nonzero range
        holds `slot` in bundle column `col`."""
        b = col - len(self.col_fid)
        for fid, lo, hi in zip(self.bundles[b], self.member_lo[b],
                               self.member_hi[b]):
            if lo <= slot <= hi:
                return fid, lo
        raise ValueError(
            f"slot {slot} of bundle column {col} is in no member range")

    def unbundle_split(self, col: int, slot_l: int, slot_r: int
                       ) -> Tuple[int, int, int]:
        """A split (column, boundary interval [slot_l, slot_r]) -> (original
        fid, slot_l, slot_r) of the original feature: slot s of member j
        is original bin s - lo_j + 1, and a slot_l below j's range (the
        lo - 1 default, or bin 0) is the original zero bin 0."""
        U = len(self.col_fid)
        if col < U:
            return int(self.col_fid[col]), slot_l, slot_r
        fid, lo = self.member_of_slot(col, slot_r)
        return fid, (0 if slot_l < lo else slot_l - lo + 1), slot_r - lo + 1

    def summary(self) -> str:
        sizes = ",".join(str(len(m)) for m in self.bundles)
        return (f"{self.n_bundled_features} of {self.n_features} features in "
                f"{len(self.bundles)} bundle(s) [{sizes}]: "
                f"{self.n_features} -> {self.n_cols} columns")


def plan_bundles(cand: np.ndarray, conflicts: np.ndarray,
                 bin_counts: np.ndarray, F: int, max_conflict: int,
                 max_width: int) -> Optional[BundlePlan]:
    """Greedy colouring over the candidates' conflict counts (LightGBM
    Alg. 3): candidates by nonzero count (the diagonal) descending, ties
    by fid, each into the first bundle whose total conflicts stay within
    `max_conflict` and whose width (one shared default bin plus each
    member's nonzero bins) fits `max_width`. One-member bundles stay
    plain. None when nothing bundles."""
    if len(cand) < 2:
        return None
    order = np.argsort(-np.diag(conflicts), kind="stable")
    groups: List[List[int]] = []
    g_conf: List[int] = []
    g_width: List[int] = []
    for ci in order:
        w = int(bin_counts[cand[ci]]) - 1
        for gi, members in enumerate(groups):
            add = int(sum(conflicts[ci, m] for m in members))
            if g_conf[gi] + add <= max_conflict \
                    and g_width[gi] + w <= max_width:
                members.append(int(ci))
                g_conf[gi] += add
                g_width[gi] += w
                break
        else:
            groups.append([int(ci)])
            g_conf.append(0)
            g_width.append(1 + w)
    bundles = sorted(sorted(int(cand[m]) for m in members)
                     for members in groups if len(members) >= 2)
    if not bundles:
        return None
    bundled = {f for members in bundles for f in members}
    col_fid = np.asarray([f for f in range(F) if f not in bundled], np.int32)
    member_lo: List[List[int]] = []
    member_hi: List[List[int]] = []
    for members in bundles:
        lo_list, hi_list, off = [], [], 1  # bin 0: the shared default
        for fid in members:
            w = int(bin_counts[fid]) - 1
            lo_list.append(off)
            hi_list.append(off + w - 1)
            off += w
        member_lo.append(lo_list)
        member_hi.append(hi_list)
    return BundlePlan(n_features=F, col_fid=col_fid, bundles=bundles,
                      member_lo=member_lo, member_hi=member_hi)


def build_bundle_plan(X_t: torch.Tensor, bins: FeatureBins,
                      max_conflict: int, max_width: int
                      ) -> Optional[BundlePlan]:
    """Plan EFB bundles from an (F, n) value tensor, on its device: the
    nonzero counts, minima and the candidates' exact pairwise co-nonzero
    counts (an f32 product over row chunks of at most 2^22, so every
    count is exact: a budget of 0 sees every conflict). None when nothing
    bundles."""
    F, n = X_t.shape
    nnz = (X_t != 0).sum(dim=1).cpu().numpy().astype(np.int64)
    mins = torch.amin(X_t, dim=1).cpu().numpy()
    cand = efb_candidates(nnz, mins, bins, n)
    C = len(cand)
    if C < 2 or C > EFB_MAX_CANDIDATES:
        return None
    Xc = X_t[torch.from_numpy(cand).to(X_t.device)]
    chunk = min(1 << 22, max(8192, (1 << 26) // C))
    conflicts = torch.zeros((C, C), dtype=torch.float64, device=X_t.device)
    for i in range(0, n, chunk):
        Z = (Xc[:, i:i + chunk] != 0).to(torch.float32)
        conflicts += (Z @ Z.t()).to(torch.float64)
    conflicts = np.rint(conflicts.cpu().numpy()).astype(np.int64)
    return plan_bundles(cand, conflicts, bins.counts, F, max_conflict,
                        max_width)


def bundle_bin_matrix_t(bins_t: torch.Tensor, plan: BundlePlan
                        ) -> torch.Tensor:
    """A BundlePlan applied to an (F, n) bin tensor -> (n_cols, n) of its
    dtype: member j's bin b > 0 encodes as lo_j + b - 1, all-default as 0,
    and a conflict row keeps the highest-offset member's code (the
    elementwise max)."""
    parts = []
    if len(plan.col_fid):
        parts.append(bins_t[torch.from_numpy(
            plan.col_fid.astype(np.int64)).to(bins_t.device)])
    for b, members in enumerate(plan.bundles):
        acc = None
        for fid, lo in zip(members, plan.member_lo[b]):
            bf = bins_t[fid].to(torch.int32)
            enc = torch.where(bf > 0, lo + bf - 1, 0)
            acc = enc if acc is None else torch.maximum(acc, enc)
        parts.append(acc[None].to(bins_t.dtype))
    return torch.cat(parts, dim=0)


# ---------------------------------------------------------------------------
# The `.bins.json` sidecar (serve-side binned scoring reads it)
# ---------------------------------------------------------------------------


def bin_edges_path(data_path: str) -> str:
    return data_path + ".bins.json"


def model_text_digest(text: str) -> str:
    """sha256 of the dumped model text, pairing a sidecar with the exact
    ensemble it was trained with."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def dump_bin_edges(fs, path: str, names: Sequence[str], bins: FeatureBins,
                   split_type: str = "mean",
                   model_digest: Optional[str] = None) -> None:
    """Atomically dump per-feature representative values, name-keyed,
    byte for byte as the JAX package writes them."""
    payload = {
        "schema": BIN_EDGES_SCHEMA,
        "version": 1,
        "split_type": split_type,
        "features": {
            str(names[f]): [
                float(v) for v in bins.values[f, : int(bins.counts[f])]
            ]
            for f in range(len(bins.counts))
        },
    }
    if model_digest is not None:
        payload["model_digest"] = model_digest
    with fs.atomic_open(path) as f:
        json.dump(payload, f)


def load_bin_edges(fs, path: str, model_digest: Optional[str] = None
                   ) -> Optional[Dict[str, np.ndarray]]:
    """{feature name: sorted (cnt,) f64 edges}, or None when the sidecar is
    missing or unreadable (serving then derives thresholds from the
    ensemble). With the served model text's digest, a sidecar dumped for a
    different model (the window a crash between the trainer's two writes
    leaves) is rejected too."""
    if not fs.exists(path):
        return None
    try:
        with fs.open(path) as f:
            payload = json.load(f)
        if payload.get("schema") != BIN_EDGES_SCHEMA:
            raise ValueError(f"not a bin-edges sidecar: {path}")
        want = payload.get("model_digest")
        if model_digest is not None and want is not None \
                and want != model_digest:
            log.warning("bin-edges sidecar %s was dumped for a different "
                        "model (digest mismatch); serving falls back to "
                        "ensemble-derived thresholds", path)
            return None
        return {
            str(name): np.asarray(vals, np.float64)
            for name, vals in payload["features"].items()
        }
    except (OSError, ValueError, KeyError, TypeError) as e:
        log.warning("bin-edges sidecar %s unreadable (%s: %s); serving falls "
                    "back to ensemble-derived thresholds", path,
                    type(e).__name__, e)
        return None
