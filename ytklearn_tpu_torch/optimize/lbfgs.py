"""L-BFGS with OWL-QN and the reference's three line-search modes
(``ytklearn_tpu/optimize/lbfgs.py``; reference
optimizer/HoagOptimizer.java:306-1201).

The JAX package runs one jitted program an iteration, its line search a
`lax.while_loop` on the device. Here an iteration is a host loop over
device tensors: every trial evaluates the loss and gradient on the device
and reads one small vector back (the trial's loss, its directional
derivatives and norms), so a trial costs one host sync and nothing more.
The step and the tests on it run on the host in float32, the arithmetic
the reference's program does on the device.

Kept from the reference:
  - weighted-sum loss bookkeeping, the regularization scaled by the total
    train weight (calcLossAndGrad:985-1006)
  - the OWL-QN pseudo-gradient from partPos/partNeg (:1040-1062)
  - the orthant projection of each trial (:1089-1103)
  - the direction constraint p = 0 where p * g >= 0 on L1 slots (:697-705)
  - the curvature guard ys < 1e-60 -> 0.01 yy on the float32 ys (:678-681;
    1e-60 is 0 in float32, in both packages)
  - convergence ||g|| / max(||w||, 1) <= eps (:534)
  - line-search statuses -1/-2/-3 and the revert to the previous point
    (:1150-1175)
  - the history as a fixed (m, dim) ring with a cursor, read newest first
    in the two-loop recursion (Hv:904-929)
  - the profiling plane's phases `lbfgs.first_eval` and `lbfgs.iterations`
    (capture=True) and one `lbfgs.iteration` span an iteration, each under
    a build-ledger label of its name
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..obs import health, inc as obs_inc, profiler, span as obs_span
from .blocked import make_value_and_grad

_MODES = {"sufficient_decrease": 0, "wolfe": 1, "strong_wolfe": 2}
_f32 = np.float32


@dataclass(frozen=True)
class LBFGSConfig:
    """param/LineSearchParams.java:43."""

    m: int = 8
    max_iter: int = 60
    eps: float = 1e-3
    mode: str = "wolfe"
    c1: float = 1e-4
    c2: float = 0.9
    step_decr: float = 0.5
    step_incr: float = 2.1
    ls_max_iter: int = 55
    min_step: float = 1e-16
    max_step: float = 1e18

    @classmethod
    def from_params(cls, lsp) -> "LBFGSConfig":
        return cls(m=lsp.lbfgs_m, max_iter=lsp.lbfgs_max_iter,
                   eps=lsp.lbfgs_eps, mode=lsp.mode, c1=lsp.c1, c2=lsp.c2,
                   step_decr=lsp.step_decr, step_incr=lsp.step_incr,
                   ls_max_iter=lsp.max_iter, min_step=lsp.min_step,
                   max_step=lsp.max_step)


@dataclass
class LBFGSState:
    w: torch.Tensor
    g: torch.Tensor  # (pseudo-)gradient at w
    loss: float  # regularized weighted-sum loss (a float32 value)
    pure_loss: float
    step: float  # the next line search's first step (a float32 value)
    S: torch.Tensor  # (m, dim) s history
    Y: torch.Tensor  # (m, dim) y history
    ys: torch.Tensor  # (m,)
    cursor: int  # the next slot to write
    hist_len: int
    ls_status: int  # > 0 accepted after that many trials, < 0 failed
    wnorm: float
    gnorm: float


@dataclass
class LBFGSResult:
    w: torch.Tensor
    loss: float
    pure_loss: float
    n_iter: int
    status: str
    converged: bool
    state: Optional[LBFGSState] = None  # curvature history for HOAG


@dataclass
class Reg:
    l1_vec: torch.Tensor  # (dim,), zeros without L1
    l2_vec: torch.Tensor  # (dim,)
    g_weight: torch.Tensor  # 0-dim: the total train weight


def two_loop(g, S, Y, ys, cursor: int, hist_len: int, m: int):
    """-H^-1 g by the two-loop recursion over the ring, newest pair first
    (reference: HoagOptimizer.Hv:904-929); hist_len > 0."""
    p = -g
    alphas = {}
    for i in range(hist_len):
        idx = (cursor - 1 - i) % m
        alpha = torch.dot(S[idx], p) / ys[idx]
        p = p - alpha * Y[idx]
        alphas[idx] = alpha
    newest = (cursor - 1) % m
    p = p * ys[newest] / torch.dot(Y[newest], Y[newest])
    for i in range(hist_len - 1, -1, -1):  # oldest first
        idx = (cursor - 1 - i) % m
        beta = torch.dot(Y[idx], p) / ys[idx]
        p = p + (alphas[idx] - beta) * S[idx]
    return p


def inv_hessian_vp(state: LBFGSState, v, m: int):
    """H^-1 v from a finished run's curvature history, the Hv HOAG uses on
    the test gradient (reference: HoagOptimizer.hyperHoagOptimization:
    822-826); the identity without history."""
    if state.hist_len == 0:
        return v
    return -two_loop(v, state.S, state.Y, state.ys, state.cursor,
                     state.hist_len, m)


def curvature_guard(ys, yy):
    """The reference's `jnp.where(ys < 1e-60, 0.01 * yy, ys)` (lbfgs.py:
    333) on float32 ys: JAX compares in float32, where 1e-60 is 0, so the
    threshold is cast first (torch compares a Python scalar in float64 and
    would replace ys = 0)."""
    eps = torch.tensor(1e-60, dtype=ys.dtype, device=ys.device)
    return torch.where(ys < eps, 0.01 * yy, ys)


def loss_grad(vg_fn, has_l1: bool, w, reg: Reg, batch):
    """calcLossAndGrad (reference: HoagOptimizer.java:978-1066):
    -> (pure loss, regularized loss, (pseudo-)gradient), on the device."""
    pure, G = vg_fn(w, *batch)
    gw = reg.g_weight
    all_loss = pure + 0.5 * gw * torch.sum(reg.l2_vec * w * w)
    G = G + gw * reg.l2_vec * w
    if has_l1:
        l1v = reg.l1_vec
        all_loss = all_loss + gw * torch.sum(l1v * torch.abs(w))
        sign_or_pos = torch.where(w != 0.0, torch.sign(w), 1.0)
        gpos = G + gw * l1v * sign_or_pos
        gneg = torch.where(w != 0.0, gpos, gpos - 2.0 * gw * l1v)
        pg = torch.where(gneg > 0.0, gneg,
                         torch.where(gpos < 0.0, gpos, 0.0))
        G = torch.where(l1v > 0.0, pg, G)
    return pure, all_loss, G


class _Solver:
    """One run's line search and iteration on fixed data."""

    def __init__(self, vg_fn, config: LBFGSConfig, has_l1: bool, reg: Reg,
                 batch):
        self.vg_fn, self.config, self.has_l1 = vg_fn, config, has_l1
        self.reg, self.batch = reg, batch
        self.mode = _MODES[config.mode]

    def loss_grad(self, w):
        return loss_grad(self.vg_fn, self.has_l1, w, self.reg, self.batch)

    def orthant_project(self, w_try, wprev, gprev):
        """reference: lineSearch's orthant block :1089-1103."""
        if not self.has_l1:
            return w_try
        zero_cross = torch.where(wprev != 0.0, w_try * wprev <= 0.0,
                                 w_try * gprev >= 0.0)
        return torch.where((self.reg.l1_vec > 0.0) & zero_cross, 0.0, w_try)

    def line_search(self, wprev, gprev, p, step0, loss0, pure0):
        """reference: HoagOptimizer.lineSearch:1068-1201 -> (w, g, loss,
        pure, status, wnorm, gnorm), or None for the norms on failure
        (the point reverts to the previous one)."""
        c = self.config
        dginit = torch.dot(gprev, p)
        f_loss0 = _f32(loss0)
        step, ls_iter = _f32(step0), 0
        while True:
            w_try = self.orthant_project(wprev + float(step) * p, wprev,
                                         gprev)
            pure, loss, g = self.loss_grad(w_try)
            ls_iter += 1
            # the trial's one host read
            vals = torch.stack([
                loss, pure, torch.dot(w_try - wprev, gprev), torch.dot(p, g),
                dginit, torch.linalg.norm(w_try), torch.linalg.norm(g),
            ]).cpu().numpy()
            f_loss, dgtest, dg, f_dginit = vals[0], vals[2], vals[3], vals[4]
            suff_ok = f_loss <= f_loss0 + _f32(c.c1) * dgtest
            wolfe_ok = dg >= _f32(c.c2) * f_dginit
            strong_ok = dg <= _f32(-c.c2) * f_dginit
            if self.mode == 0:
                ok, factor = suff_ok, c.step_decr
            elif self.mode == 1:
                ok = suff_ok and wolfe_ok
                factor = c.step_decr if not suff_ok else c.step_incr
            else:
                ok = suff_ok and wolfe_ok and strong_ok
                factor = (c.step_decr if not suff_ok else
                          c.step_incr if not wolfe_ok else c.step_decr)
            if ok:
                status = ls_iter
            elif step < _f32(c.min_step):
                status = -1
            elif step > _f32(c.max_step):
                status = -2
            elif ls_iter >= c.ls_max_iter:
                status = -3
            else:
                status = 0
            step = _f32(step * _f32(factor))
            if status > 0:
                return (w_try, g, float(vals[0]), float(vals[1]), status,
                        float(vals[5]), float(vals[6]))
            if status < 0:
                # back to the previous point (reference :585-589)
                return wprev, gprev, loss0, pure0, status, None, None

    def iteration(self, st: LBFGSState) -> LBFGSState:
        """Direction from the history, line search, history update
        (reference main loop :566-715)."""
        m = self.config.m
        wprev, gprev = st.w, st.g
        if st.hist_len > 0:
            p = two_loop(gprev, st.S, st.Y, st.ys, st.cursor, st.hist_len, m)
        else:
            p = -gprev
        if self.has_l1:
            # constrain the search direction (reference :697-705)
            p = torch.where((self.reg.l1_vec > 0.0) & (p * gprev >= 0.0),
                            0.0, p)
        w, g, loss, pure, status, wnorm, gnorm = self.line_search(
            wprev, gprev, p, st.step, st.loss, st.pure_loss)
        cursor, hist_len = st.cursor, st.hist_len
        if status > 0:
            s, y = w - wprev, g - gprev
            st.S[cursor] = s
            st.Y[cursor] = y
            st.ys[cursor] = curvature_guard(torch.dot(y, s), torch.dot(y, y))
            cursor = (cursor + 1) % m
            hist_len = min(hist_len + 1, m)
        else:
            wnorm, gnorm = st.wnorm, st.gnorm
        return LBFGSState(
            w=w, g=g, loss=loss, pure_loss=pure,
            step=1.0,  # step 1 after the first iteration (:707)
            S=st.S, Y=st.Y, ys=st.ys, cursor=cursor, hist_len=hist_len,
            ls_status=status, wnorm=wnorm, gnorm=gnorm)


def minimize_lbfgs(
    pure_loss_fn: Callable,
    w0,
    config: LBFGSConfig,
    batch: Tuple = (),
    l1_vec: Optional[torch.Tensor] = None,
    l2_vec: Optional[torch.Tensor] = None,
    g_weight: float = 1.0,
    callback: Optional[Callable[[int, LBFGSState], bool]] = None,
    row_chunk: Optional[int] = None,
    row_mask: Optional[Tuple[bool, ...]] = None,
    mesh=None,
) -> LBFGSResult:
    """L-BFGS/OWL-QN from w0 (a float32 tensor on the device the batch is
    on) to convergence, max_iter, a failed line search or a non-finite
    loss.

    pure_loss_fn(w, *batch) returns the weighted-sum data loss. row_chunk
    evaluates loss and gradient over row chunks of that size
    (optimize/blocked.py); row_mask marks the batch entries that are
    row-aligned (the others go whole into every chunk). callback(it,
    state) runs on the host once an iteration (and with it = 0 before the
    first); returning True stops.

    With `mesh` the batch is this rank's rows and w is replicated: each
    loss and gradient is the rank's sum psummed over the ranks
    (blocked.make_value_and_grad), so the line search, the orthant
    projection and every stop test see the same numbers on every rank and
    every rank runs the same trials. The callback runs on every rank.
    """
    w0 = torch.as_tensor(w0)
    dim, dtype, dev = w0.shape[0], w0.dtype, w0.device
    zeros = torch.zeros((dim,), dtype=dtype, device=dev)
    has_l1 = l1_vec is not None and bool(torch.any(l1_vec > 0))
    reg = Reg(l1_vec=zeros if l1_vec is None else l1_vec.to(dev, dtype),
              l2_vec=zeros if l2_vec is None else l2_vec.to(dev, dtype),
              g_weight=torch.tensor(g_weight, dtype=dtype, device=dev))
    solver = _Solver(make_value_and_grad(pure_loss_fn, row_chunk, row_mask,
                                         mesh),
                     config, has_l1, reg, batch)
    obs_inc("lbfgs.runs")
    # phase + ledger label: the first evaluation takes the run's first
    # launches, so the build ledger names any build it pays, and the wall
    # decomposition separates it from the steady iterations
    with profiler.phase("lbfgs.first_eval", dim=dim), profiler.LEDGER.program(
            "lbfgs.first_eval",
            sig_fn=lambda: profiler.abstract_signature(w0, reg, batch)):
        pure, loss, g = solver.loss_grad(w0)
        vals = torch.stack([pure, loss, torch.linalg.norm(w0),
                            torch.linalg.norm(g)]).cpu().numpy()
    gnorm, wnorm = float(vals[3]), float(vals[2])
    state = LBFGSState(
        w=w0, g=g, loss=float(vals[1]), pure_loss=float(vals[0]),
        step=float(_f32(1.0 / max(gnorm, 1e-300))),
        S=torch.zeros((config.m, dim), dtype=dtype, device=dev),
        Y=torch.zeros((config.m, dim), dtype=dtype, device=dev),
        ys=torch.ones((config.m,), dtype=dtype, device=dev),
        cursor=0, hist_len=0, ls_status=1, wnorm=wnorm, gnorm=gnorm)
    if callback is not None and callback(0, state):
        return _result(state, 0, "callback_stop")
    if gnorm / max(wnorm, 1.0) <= config.eps:
        return _result(state, 0, "converged_at_init", converged=True)

    it = 0
    status = "max_iter"
    converged = False
    # the sentinels read the loss the iteration already brought to the
    # host; YTK_HEALTH=0 drops them (one attribute load)
    health_on = health.enabled()
    guard = health.ProgressGuard("lbfgs", window=10) if health_on else None
    # the iterations run inside one ytkprof phase (opt-in capture: the
    # kernel table of the solve comes from here); each iteration reads its
    # loss to the host, so the span's duration is device-settled
    with profiler.phase("lbfgs.iterations", capture=True):
        for it in range(1, config.max_iter + 1):
            with obs_span("lbfgs.iteration", it=it), \
                    profiler.LEDGER.program(
                        "lbfgs.iteration",
                        sig_fn=lambda: profiler.abstract_signature(
                            state, reg, batch)):
                state = solver.iteration(state)
            obs_inc("lbfgs.iterations")
            if health_on:
                if not health.check_loss("lbfgs.loss", state.loss, it=it):
                    status = "nan_loss"
                    break
                guard.update(state.loss, it=it)
            if not math.isfinite(state.loss):
                status = "nan_loss"
                break
            if state.ls_status < 0:
                status = f"line_search_failed({state.ls_status})"
                break
            if callback is not None and callback(it, state):
                status = "callback_stop"
                break
            if state.gnorm / max(state.wnorm, 1.0) <= config.eps:
                status = "converged"
                converged = True
                break
    return _result(state, it, status, converged)


def _result(state, n_iter, status, converged=False) -> LBFGSResult:
    return LBFGSResult(w=state.w, loss=state.loss,
                       pure_loss=state.pure_loss, n_iter=n_iter,
                       status=status, converged=converged, state=state)
