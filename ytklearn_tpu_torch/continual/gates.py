"""Promotion gates of the continual-training driver (the JAX package's
``continual/gates.py``).

A retrained candidate replaces the serving incumbent only when it proves
itself twice:

  health gate   no sentinel fired during candidate training (NaN loss,
                divergence, rotten ingest, empty/NaN trees: the
                `health.*` counter deltas over the run), and the
                candidate's held-out loss is finite.
  metric gate   candidate held-out loss <= incumbent held-out loss
                within the configured band (`continual.band`, knob
                `YTK_CONTINUAL_BAND`; 0 = must be no worse), both
                measured now on the same held-out files.

A reject keeps the incumbent serving and records a `continual.rejected`
obs event naming every failed gate.

The held-out rows are scored by CompiledScorer, the serving rungs on the
device (the fused rung's heap-walk kernel for a GBDT under
YTK_SERVE_FUSED=1). Unlike the reference, which falls back to the host row
walk on any scorer exception, the port falls back only when the scorer
refuses the family (`LoweringRefused`): any other error (a kernel that
fails to build or launch) propagates, the retrain fails, and the
incumbent keeps serving.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import knobs
from ..device import resolve_device
from ..obs import inc as obs_inc, snapshot as obs_snapshot, span as obs_span
from ..predict.base import parse_feature_kvs

log = logging.getLogger("ytklearn_tpu_torch.continual")


def health_counters() -> Dict[str, float]:
    """The top-level `health.<kind>` counters (the sentinel totals; the
    one root-counter definition, obs/health.py::root_health_counters)."""
    from ..obs.health import root_health_counters

    return dict(root_health_counters(obs_snapshot()["counters"]))


def health_delta(before: Dict[str, float]) -> Dict[str, float]:
    """Sentinel hits since `before` (a health_counters() snapshot)."""
    after = health_counters()
    out = {}
    for k, v in after.items():
        d = v - before.get(k, 0.0)
        if d > 0:
            out[k] = d
    return out


def _gate_scores(predictor, fmaps: List[dict], compiled: Optional[bool],
                 device) -> np.ndarray:
    """Score the held-out rows. Default: CompiledScorer on `device`, the
    rungs serving runs (only the sizes this eval touches are scored).
    `YTK_GATE_COMPILED=0` (or compiled=False) keeps the host row walk; a
    family the scorer refuses to lower falls back to it loudly
    (`continual.gate_eval_fallback`). Every other error propagates. The
    rows go to the scorer a top rung at a time: its featurized batch is
    dense (rows x vocabulary), so the whole held-out set at once would
    cost its rows times the vocabulary in host memory."""
    if compiled is None:
        compiled = knobs.get_bool("YTK_GATE_COMPILED")
    if compiled:
        from ..serve.scorer import CompiledScorer, LoweringRefused

        try:
            scorer = CompiledScorer(predictor, warmup=False, device=device)
        except LoweringRefused as e:
            obs_inc("continual.gate_eval_fallback")
            log.warning("gate eval: the scorer refused the family (%s); "
                        "falling back to the host row walk", e)
        else:
            step = scorer.ladder[-1]
            return np.concatenate([
                np.asarray(scorer.score_batch(fmaps[i:i + step]), np.float64)
                for i in range(0, len(fmaps), step)])
    return np.asarray(predictor.batch_scores(fmaps), np.float64)


def holdout_loss(
    predictor, paths: Sequence[str], max_error_tol: int = 100,
    compiled: Optional[bool] = None, device=None,
) -> Tuple[float, int]:
    """Weighted average loss of `predictor` over labeled held-out files
    (weight###label###features rows, the training text format). Scoring
    goes through CompiledScorer on `device` (cuda unless the caller passes
    "cpu"; see _gate_scores); the loss runs in one float64 call there.
    Returns (avg_loss, n_rows); (nan, 0) when no labeled rows were
    found."""
    dev = resolve_device(device)
    delim = predictor.params.data.delim
    fs = predictor.fs
    fmaps: List[dict] = []
    weights: List[float] = []
    labels: List[List[float]] = []
    errors = 0
    for path in sorted(fs.recur_get_paths(list(paths))):
        with fs.open(path) as f:
            for line in f:
                line = line.rstrip("\n")
                if not line.strip():
                    continue
                try:
                    xsplits = line.split(delim.x_delim)
                    weight = float(xsplits[0])
                    label = [
                        float(v) for v in xsplits[1].split(delim.y_delim)
                    ]
                    fmap = parse_feature_kvs(xsplits[2], delim)
                except (IndexError, ValueError) as e:
                    errors += 1
                    if errors > max_error_tol:
                        raise ValueError(
                            f"held-out file {path}: more than "
                            f"{max_error_tol} unparseable rows: {e}"
                        ) from e
                    continue
                fmaps.append(fmap)
                weights.append(weight)
                labels.append(label)
    if not fmaps:
        return float("nan"), 0
    with obs_span("continual.holdout_eval", rows=len(fmaps)):
        scores = _gate_scores(predictor, fmaps, compiled, dev)
        k = scores.shape[1] if scores.ndim > 1 else 1
        if k > 1:
            lab = np.zeros((len(labels), k), np.float64)
            for i, li in enumerate(labels):
                if len(li) == k:
                    lab[i] = li
                else:  # single class index -> one-hot
                    lab[i, int(li[0])] = 1.0
        else:
            lab = np.asarray([li[0] for li in labels], np.float64)
        w = np.asarray(weights, np.float64)
        per = predictor.loss.loss(
            torch.as_tensor(scores, device=dev),
            torch.as_tensor(lab, device=dev)).cpu().numpy().reshape(-1)
        loss = float(np.sum(w * per) / max(np.sum(w), 1e-12))
    return loss, len(fmaps)


def drift_advisory(quality_block: Optional[dict]) -> Optional[dict]:
    """Compact the serving layer's `/metrics?quality=1` block into the
    ADVISORY drift record the gate report carries: the worst PSI/KS and
    calibration delta across served models, plus the offending features.
    Advisory by contract: it is recorded next to the gate verdict (and in
    the result JSON and the `continual.drift_advisory` event) but never
    passes or fails a candidate."""
    if not quality_block:
        return None
    # replica payloads carry {"models": ...}; the fleet front's merged
    # payload carries {"fleet": ...} — accept both
    models = quality_block.get("models") or quality_block.get("fleet") or {}
    if not models:
        return None
    out = {
        "psi_max": 0.0,
        "ks_max": 0.0,
        "calibration_delta": None,
        "worst_model": None,
        "worst_features": [],
        "rows_sampled": 0,
        "models_no_baseline": 0,
    }
    for key, m in models.items():
        if m.get("no_baseline"):
            out["models_no_baseline"] += 1
            continue
        out["rows_sampled"] += int(m.get("rows_sampled") or 0)
        psi = float(m.get("psi_max") or 0.0)
        if psi >= out["psi_max"]:
            out["psi_max"] = psi
            out["worst_model"] = key
            out["worst_features"] = list(m.get("worst_features") or [])
        out["ks_max"] = max(out["ks_max"], float(m.get("ks_max") or 0.0))
        cal = (m.get("score") or {}).get("calibration_delta")
        if cal is not None:
            prev = out["calibration_delta"]
            out["calibration_delta"] = (
                cal if prev is None else max(prev, float(cal))
            )
    return out


@dataclass
class GateReport:
    """Outcome of the promotion gates for one retrain candidate."""

    passed: bool
    reasons: List[str] = field(default_factory=list)
    candidate_loss: Optional[float] = None
    incumbent_loss: Optional[float] = None
    band: float = 0.0
    holdout_rows: int = 0
    health: Dict[str, float] = field(default_factory=dict)
    # serve-side drift snapshot at gate time (drift_advisory): recorded,
    # never a pass/fail input
    advisory: Optional[dict] = None


def evaluate_gates(
    candidate_loss: Optional[float],
    incumbent_loss: Optional[float],
    band: float,
    health_hits: Dict[str, float],
    holdout_rows: int = 0,
    advisory: Optional[dict] = None,
) -> GateReport:
    """Combine the health + metric gates into one report. `None` losses
    mean "not measurable" (no held-out data / no incumbent): the metric
    gate then passes vacuously — the health gate always applies.
    `advisory` (the serve-side drift snapshot) is recorded verbatim and
    never contributes a reason."""
    reasons: List[str] = []
    if health_hits:
        hits = ", ".join(f"{k}={v:g}" for k, v in sorted(health_hits.items()))
        reasons.append(f"health sentinels fired during training: {hits}")
    if candidate_loss is not None and not math.isfinite(candidate_loss):
        reasons.append(
            f"candidate held-out loss is non-finite ({candidate_loss!r})"
        )
    elif candidate_loss is not None and incumbent_loss is not None:
        if math.isfinite(incumbent_loss):
            limit = incumbent_loss + band * abs(incumbent_loss)
            if candidate_loss > limit:
                reasons.append(
                    f"candidate held-out loss {candidate_loss:.6f} outside "
                    f"the band vs incumbent {incumbent_loss:.6f} "
                    f"(limit {limit:.6f}, band {band:g})"
                )
        else:
            log.warning(
                "incumbent held-out loss is non-finite (%r); metric gate "
                "passes on the candidate's finiteness alone", incumbent_loss,
            )
    return GateReport(
        passed=not reasons,
        reasons=reasons,
        candidate_loss=candidate_loss,
        incumbent_loss=incumbent_loss,
        band=band,
        holdout_rows=holdout_rows,
        health=dict(health_hits),
        advisory=advisory,
    )
