"""Feature binning on the training device, and the bin-edge sidecar.

The counterpart of the device path of ``ytklearn_tpu/gbdt/binning.py``:

  FeatureBins          per-feature sorted representative values (:45)
  quantile_bins_device sample_by_quantile with one sort per feature (:725)
  build_bins_maybe_device  the single-quantile-spec bin builder (:789)
  bin_matrix_device    value -> nearest-representative bin, (F, n) (:824)
  bin_matrix           the same rule on a host (n, F) matrix (:854)
  efb_candidates       EFB's column filter (:560)
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


def check_no_efb_plan(X_t: torch.Tensor, bins: FeatureBins) -> None:
    """EFB bundling is not ported: raise when the reference could plan a
    bundle (two or more candidate columns). On dense data the candidate
    list is shorter and the reference plan is None, as here."""
    nnz = (X_t != 0).sum(dim=1).cpu().numpy().astype(np.int64)
    mins = torch.amin(X_t, dim=1).cpu().numpy()
    cand = efb_candidates(nnz, mins, bins, X_t.shape[1])
    if len(cand) >= 2:
        raise NotImplementedError(
            f"EFB: {len(cand)} sparse columns could bundle (features "
            f"{cand[:8].tolist()}...); bundling is ROADMAP.md 1.3. Pass "
            "efb=False (or YTK_EFB=0) to train unbundled"
        )


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
