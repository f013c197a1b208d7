"""Continual training (the JAX package's ``continual/``): the subsystem
that closes the train -> serve loop. `cli serve`'s registry swaps a new
model in under live traffic; this package produces those models:

  retrain()        warm-start a candidate on new data in a shadow path on
                   the card (GBDT: +extra_rounds boosting rounds on the
                   loaded ensemble; GBST: more trees; convex: L-BFGS from
                   the checkpoint weights, or an FTRL-proximal online
                   pass), gate it on the health sentinels and a held-out
                   metric band versus the incumbent, and promote it
                   atomically only on a pass; a reject keeps the incumbent
                   serving and records a `continual.rejected` obs event
  rollback()       restore the newest archived incumbent over the live
                   path (the disk-level undo; `ModelRegistry.rollback()`
                   is the in-memory twin)
  gates            health/metric gate evaluation and held-out loss scoring
  ftrl_update_convex  the streaming FTRL arm (optimize/ftrl.py)

CLI: `python -m ytklearn_tpu_torch.cli retrain <model> <conf>`. Knobs:
YTK_CONTINUAL_BAND / _KEEP / _STRICT / _DRIFT_URL, YTK_GATE_COMPILED,
YTK_RETRAIN_LOCK_TTL_S.
"""

from __future__ import annotations

from .driver import (  # noqa: F401
    RetrainLock,
    RetrainRejected,
    RetrainResult,
    read_version,
    retrain,
    rollback,
)
from .gates import (  # noqa: F401
    GateReport,
    evaluate_gates,
    health_counters,
    health_delta,
    holdout_loss,
)
from .online import ftrl_update_convex  # noqa: F401

__all__ = [
    "GateReport",
    "RetrainLock",
    "RetrainRejected",
    "RetrainResult",
    "evaluate_gates",
    "ftrl_update_convex",
    "health_counters",
    "health_delta",
    "holdout_loss",
    "read_version",
    "retrain",
    "rollback",
]
