"""The convex families' online update: one FTRL-proximal pass over fresh
rows (the JAX package's ``continual/online.py``).

The `mode=ftrl` arm of the retrain driver: instead of a full L-BFGS refit,
stream the new data once through the FTRL-proximal update
(optimize/ftrl.py) from the incumbent's weights, then dump the updated
model. Deterministic by construction (fixed row order, no random draws,
no float atomics): two passes over the same stream give the same bits.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np
import torch

from ..obs import health, span as obs_span
from ..optimize.ftrl import FTRLConfig, ftrl_pass

log = logging.getLogger("ytklearn_tpu_torch.continual")


def ftrl_update_convex(trainer, p) -> Dict[str, float]:
    """The FTRL pass for a HoagTrainer's setup: ingest the (new) train data,
    warm-start from the dumped model when `model.continue_train` is set,
    stream `continual.batch_rows`-row minibatches on the trainer's device,
    and dump the updated weights over `model.data_path`. Returns the
    summary metrics of the driver's result JSON."""
    cp = p.continual
    with obs_span("continual.ftrl_load"):
        ingest = trainer._ingest()
    model = trainer._make_model(ingest)
    w0 = None
    if p.model.continue_train or p.loss.just_evaluate:
        w0 = model.load_model(trainer.fs, ingest.feature_map)
        if w0 is not None:
            log.info("ftrl: warm start from the incumbent checkpoint")
    if w0 is None:
        w0 = model.init_weights()

    cfg = FTRLConfig(alpha=cp.ftrl_alpha, beta=cp.ftrl_beta, l1=cp.ftrl_l1,
                     l2=cp.ftrl_l2)
    batch = model.device_batch(ingest.train)
    state = ftrl_pass(model, w0, batch, cfg, batch_rows=cp.batch_rows)

    # the final weighted-average train loss: the health sentinel's NaN
    # check, and the number an operator compares across retrains
    g_weight = float(np.sum(ingest.train.weight))
    with torch.no_grad():
        avg_loss = float(model.pure_loss(state.w, *batch)) / max(g_weight,
                                                                 1e-12)
    health.check_loss("continual.ftrl", avg_loss)

    w = state.w.cpu().numpy()
    model.dump_model(trainer.fs, w, None, ingest.feature_map)
    nnz = int(np.sum(np.abs(w) > 0))
    log.info("ftrl pass done: %d rows, avg loss %.6f, %d/%d nonzero weights",
             ingest.train.n_real, avg_loss, nnz, w.shape[0])
    return {"avg_loss": avg_loss, "rows": float(ingest.train.n_real),
            "nnz": float(nnz)}
