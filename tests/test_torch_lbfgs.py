"""The port's L-BFGS/OWL-QN (ytklearn_tpu_torch/optimize/lbfgs.py) against
the JAX package's (ytklearn_tpu/optimize/lbfgs.py), the JAX side in
float32 (`jax.enable_x64(False)`).

- The two-loop direction and inv_hessian_vp from the same (m, dim) ring
  (partly filled, full, wrapped) at rtol 1e-5.
- The curvature guard on float32 ys, bit for bit: 1e-40 (a denormal), 0
  and -0 are kept, a negative ys becomes 0.01 yy, as the reference's
  `jnp.where(ys < 1e-60, 0.01 * yy, ys)` (lbfgs.py:333) decides in
  float32 (where 1e-60 is 0).
- Each line-search mode, and each failure status (-1 step below min_step,
  -2 above max_step, -3 out of trials), on a sparse logistic regression:
  the status (the trial count when > 0) of each of the first 5
  iterations equal, the losses at rtol 1e-5.
- OWL-QN with L1: the set of weights at exactly 0 equal to the
  reference's except where the reference's |w| < 1e-6, the loss at rtol
  1e-4 after 15 iterations.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.config.params import CommonParams as JParams
from ytklearn_tpu.models.linear import LinearModel as JLinear
from ytklearn_tpu.optimize import lbfgs as jlb
from ytklearn_tpu_torch.config.params import CommonParams as PParams
from ytklearn_tpu_torch.io.reader import DataIngest
from ytklearn_tpu_torch.models import LinearModel
from ytklearn_tpu_torch.optimize import lbfgs as plb
from ytklearn_tpu_torch.scripts.convex_synth import write_convex_case


def _close(got, want, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _history(m, dim, hist_len, cursor, seed=0):
    rng = np.random.RandomState(seed)
    S = np.zeros((m, dim), np.float32)
    Y = np.zeros((m, dim), np.float32)
    ys = np.ones(m, np.float32)
    for i in range(hist_len):
        idx = (cursor - 1 - i) % m
        s = rng.randn(dim).astype(np.float32)
        y = (s * rng.uniform(0.5, 2.0, dim) + 0.1 * rng.randn(dim)
             ).astype(np.float32)
        S[idx], Y[idx], ys[idx] = s, y, np.dot(y, s)
    return S, Y, ys


@pytest.mark.parametrize("hist_len,cursor", [(1, 1), (3, 3), (5, 5),
                                             (5, 2), (5, 0)])
def test_two_loop_and_inv_hessian_vp(hist_len, cursor):
    m, dim = 5, 64
    S, Y, ys = _history(m, dim, hist_len, cursor)
    g = np.random.RandomState(9).randn(dim).astype(np.float32)
    with jax.enable_x64(False):
        want = np.asarray(jlb._two_loop_core(
            jnp.asarray(g), jnp.asarray(S), jnp.asarray(Y), jnp.asarray(ys),
            jnp.asarray(cursor, jnp.int32), jnp.asarray(hist_len, jnp.int32),
            m))
        jstate = jlb.LBFGSState(
            w=None, g=None, loss=None, pure_loss=None, step=None,
            S=jnp.asarray(S), Y=jnp.asarray(Y), ys=jnp.asarray(ys),
            cursor=jnp.asarray(cursor, jnp.int32),
            hist_len=jnp.asarray(hist_len, jnp.int32), ls_status=None)
        want_h = np.asarray(jlb.inv_hessian_vp(jstate, jnp.asarray(g), m))
    T = torch.from_numpy
    got = plb.two_loop(T(g), T(S), T(Y), T(ys), cursor, hist_len, m)
    _close(got.numpy(), want, 1e-5)
    pstate = plb.LBFGSState(
        w=None, g=None, loss=0.0, pure_loss=0.0, step=1.0, S=T(S), Y=T(Y),
        ys=T(ys), cursor=cursor, hist_len=hist_len, ls_status=1, wnorm=0.0,
        gnorm=0.0)
    _close(plb.inv_hessian_vp(pstate, T(g), m).numpy(), want_h, 1e-5)
    pstate.hist_len = 0
    assert torch.equal(plb.inv_hessian_vp(pstate, T(g), m), T(g))


@pytest.mark.parametrize("ys", [1e-40, 0.0, -0.0, -3.0, 2.5])
def test_curvature_guard_on_float32_ys(ys):
    ys32, yy32 = np.float32(ys), np.float32(10.0)
    with jax.enable_x64(False):
        jys, jyy = jnp.asarray(ys32), jnp.asarray(yy32)
        want = np.asarray(jnp.where(jys < 1e-60, 0.01 * jyy, jys))  # :333
    got = plb.curvature_guard(torch.tensor(ys32), torch.tensor(yy32))
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()
    replaced = np.float32(np.float32(0.01) * yy32)
    assert float(got) == (replaced if ys < 0 else ys32)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    """A sparse logistic regression: the port's batch and both models."""
    d = str(tmp_path_factory.mktemp("lbfgs"))
    cfg = write_convex_case(d, "linear", 1500, 10, 21, vocab=400, nnz=10)
    pp = PParams.from_config(cfg)
    ing = DataIngest(pp).load()
    jm = JLinear(JParams.from_config(copy.deepcopy(cfg)), ing.train.dim,
                 dense=False)
    pm = LinearModel(pp, ing.train.dim, dense=False, device="cpu")
    return jm, pm, ing


def _run(problem, cfg_kw, l1=0.0, l2=0.0, iters=5):
    """(jax, port) lists of (loss, status) per iteration, and final w."""
    jm, pm, ing = problem
    g_weight = float(np.sum(ing.train.weight))
    out = []
    with jax.enable_x64(False):
        rec = []
        l1v, l2v = jm.reg_vectors(l1, l2)
        res = jlb.minimize_lbfgs(
            jm.pure_loss, jnp.asarray(jm.init_weights()),
            jlb.LBFGSConfig(max_iter=iters, **cfg_kw),
            batch=tuple(jnp.asarray(a) for a in jm.make_batch(ing.train)),
            l1_vec=l1v, l2_vec=l2v, g_weight=g_weight,
            callback=lambda it, st: rec.append(
                (float(st.loss), int(st.ls_status))) and False)
        out.append((rec, res.status, np.asarray(res.w)))
    rec = []
    l1v, l2v = pm.reg_vectors(l1, l2)
    res = plb.minimize_lbfgs(
        pm.pure_loss, torch.from_numpy(pm.init_weights()),
        plb.LBFGSConfig(max_iter=iters, **cfg_kw),
        batch=pm.device_batch(ing.train), l1_vec=l1v, l2_vec=l2v,
        g_weight=g_weight,
        callback=lambda it, st: rec.append((st.loss, st.ls_status)) and False)
    out.append((rec, res.status, res.w.numpy()))
    return out


LS_CASES = [
    ("sufficient_decrease", {"mode": "sufficient_decrease", "c1": 0.45}),
    ("wolfe", {"mode": "wolfe"}),
    ("wolfe_c2", {"mode": "wolfe", "c2": 0.05}),
    ("strong_wolfe", {"mode": "strong_wolfe", "c2": 0.1}),
    ("strong_wolfe_incr", {"mode": "strong_wolfe", "c2": 0.5,
                           "step_incr": 1.3}),
    # c1 = 10: no trial decreases enough; c2 = -10: no trial is Wolfe
    ("min_step", {"mode": "sufficient_decrease", "c1": 10.0,
                  "min_step": 1e3}),
    ("max_step", {"mode": "wolfe", "c2": -10.0, "max_step": 1e-9}),
    ("out_of_trials", {"mode": "wolfe", "c1": 10.0, "ls_max_iter": 3}),
]


@pytest.mark.parametrize("name,kw", LS_CASES, ids=[c[0] for c in LS_CASES])
def test_line_search_statuses_match(name, kw, problem):
    (jrec, jstatus, jw), (prec, pstatus, pw) = _run(problem, kw, l2=0.01)
    assert [s for _, s in prec[:6]] == [s for _, s in jrec[:6]]
    assert pstatus == jstatus
    _close([l for l, _ in prec[:6]], [l for l, _ in jrec[:6]], 1e-5)
    want = {"min_step": "line_search_failed(-1)",
            "max_step": "line_search_failed(-2)",
            "out_of_trials": "line_search_failed(-3)"}.get(name, "max_iter")
    assert pstatus == want
    if want != "max_iter":  # reverted to the start
        assert np.array_equal(pw, jw) and len(prec) == 1
    elif name != "wolfe":  # a line search of more than one trial
        assert max(s for _, s in prec) > 1


def test_owlqn_zero_set_matches(problem):
    (jrec, jstatus, jw), (prec, pstatus, pw) = _run(
        problem, {"mode": "wolfe"}, l1=0.02, l2=0.001, iters=15)
    assert jstatus == pstatus
    _close(prec[-1][0], jrec[-1][0], 1e-4)
    jz, pz = jw == 0.0, pw == 0.0
    assert jz.sum() > 100  # L1 zeroes a good share of the weights
    differ = jz != pz
    assert np.all(np.abs(jw[differ]) < 1e-6), np.flatnonzero(differ)
