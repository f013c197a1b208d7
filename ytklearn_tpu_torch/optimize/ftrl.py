"""FTRL-Proximal, the streaming update of the convex families (the JAX
package's ``optimize/ftrl.py``; McMahan et al., "Ad Click Prediction: a
View from the Trenches", KDD 2013).

Per-coordinate adaptive learning rates with L1-induced sparsity: the cheap
freshness path of `cli retrain --mode ftrl` when only a delta of new rows
arrived. Per coordinate i, after observing gradient g_i:

    n_i  += g_i^2
    sigma = (sqrt(n_i) - sqrt(n_i - g_i^2)) / alpha
    z_i  += g_i - sigma * w_i
    w_i   = 0                                      if |z_i| <= l1_i
          = -(z_i - sign(z_i) l1_i) / ((beta + sqrt(n_i))/alpha + l2_i)

A minibatch step is the gradient of the model's weighted loss (autograd,
normalised by the minibatch weight) and elementwise tensor ops; the state
and the whole stream stay on the model's device, so a pass over k
minibatches reads nothing back to the host. The sparse gradient's scatter
is the embedding backward of `models/base.py::gather_rows` (sorted
segments, no float atomics): the pass is bit-stable on a fixed stream.

Warm start: `ftrl_init(w0, ...)` inverts the closed form, so the first
weight solve reproduces the checkpoint exactly (z0 chosen with n0 = 0).
L1/L2 arrive as per-coordinate vectors (the models' `reg_vectors`), so the
bias rides unregularized as in the L-BFGS path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

from ..obs import inc as obs_inc, span as obs_span


@dataclass(frozen=True)
class FTRLConfig:
    """Hyperparameters (the paper's alpha, beta, lambda1, lambda2); l1 and
    l2 are scalars broadcast through the model's reg_vectors."""

    alpha: float = 0.1
    beta: float = 1.0
    l1: float = 0.0
    l2: float = 0.0


class FTRLState(NamedTuple):
    w: torch.Tensor  # current weights (the closed-form solve of z, n)
    z: torch.Tensor  # accumulated (gradient - sigma * w) sums
    n: torch.Tensor  # accumulated squared gradients


def ftrl_init(w0, cfg: FTRLConfig, l1_vec: Optional[torch.Tensor] = None,
              l2_vec: Optional[torch.Tensor] = None) -> FTRLState:
    """The state whose closed-form solve gives back `w0` bit for bit at
    n = 0: z0 = -w0 (beta/alpha + l2) - sign(w0) l1 (a zero weight gets
    z0 = 0, which the solve keeps at exactly 0 whenever l1 >= 0). The
    state lives on the reg vectors' device, else on w0's."""
    dev = l1_vec.device if l1_vec is not None else None
    w0 = torch.as_tensor(w0, dtype=torch.float32, device=dev)
    l1v = torch.zeros_like(w0) if l1_vec is None else l1_vec.to(w0)
    l2v = torch.zeros_like(w0) if l2_vec is None else l2_vec.to(w0)
    denom = cfg.beta / cfg.alpha + l2v
    z0 = torch.where(w0 != 0.0, -w0 * denom - torch.sign(w0) * l1v,
                     torch.zeros_like(w0))
    return FTRLState(w=w0, z=z0, n=torch.zeros_like(w0))


def make_ftrl_step(grad_fn: Callable, cfg: FTRLConfig) -> Callable:
    """The minibatch update step(state, l1_vec, l2_vec, *batch) ->
    FTRLState; grad_fn(w, *batch) is the gradient of the weight-normalised
    minibatch loss."""
    alpha, beta = cfg.alpha, cfg.beta

    def step(state: FTRLState, l1_vec, l2_vec, *batch) -> FTRLState:
        g = grad_fn(state.w, *batch)
        n_new = state.n + g * g
        sigma = (torch.sqrt(n_new) - torch.sqrt(state.n)) / alpha
        z_new = state.z + g - sigma * state.w
        denom = (beta + torch.sqrt(n_new)) / alpha + l2_vec
        w_new = torch.where(torch.abs(z_new) <= l1_vec,
                            torch.zeros_like(z_new),
                            -(z_new - torch.sign(z_new) * l1_vec) / denom)
        return FTRLState(w=w_new, z=z_new, n=n_new)

    return step


def ftrl_pass(model, w0, batch: tuple, cfg: FTRLConfig,
              batch_rows: int = 8192,
              n_real: Optional[int] = None) -> FTRLState:
    """One deterministic pass of FTRL minibatch updates over `batch` (the
    model's batch arrays, rows first; moved to the model's device once).

    Rows are consumed in order, `batch_rows` at a time: for a freshness
    delta the stream is the new data, so one pass is the intended use.
    `n_real` clips trailing padding rows; the weight column (last) both
    weights the loss and normalises each minibatch's gradient.
    """
    l1_vec, l2_vec = model.reg_vectors(cfg.l1, cfg.l2)
    dev = l1_vec.device
    batch = tuple(torch.as_tensor(a).to(dev) for a in batch)

    def grad_fn(w, *b):
        total = torch.clamp_min(torch.sum(b[-1]), 1e-12)
        w = w.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(model.pure_loss(w, *b), w)
        return g / total

    step = make_ftrl_step(grad_fn, cfg)
    state = ftrl_init(w0, cfg, l1_vec, l2_vec)
    n = int(batch[0].shape[0]) if n_real is None else int(n_real)
    n_steps = 0
    with obs_span("continual.ftrl_pass", rows=n, batch_rows=batch_rows):
        for lo in range(0, n, batch_rows):
            hi = min(lo + batch_rows, n)
            state = step(state, l1_vec, l2_vec, *(a[lo:hi] for a in batch))
            n_steps += 1
    obs_inc("continual.ftrl_steps", n_steps)
    obs_inc("continual.ftrl_rows", n)
    return state
