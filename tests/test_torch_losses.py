"""The port's losses (ytklearn_tpu_torch/losses.py) against the JAX
package's (ytklearn_tpu/losses.py) on the same seeded float32 inputs.

Every loss: loss, predict, first and second derivative and grad_hess at
rtol 1e-6 (atol 1e-6 of the largest |value| of that output, for entries
that cancel to about 0: torch and XLA round elementwise functions such as
exp and sigmoid differently in the last ulp), with the JAX side run in
float32 (`jax.enable_x64(False)`), as the CLI and bench.py run it.
Multiclass losses at K = 4 (hsoftmax's complete tree) on one-hot labels.
The factory's names and aliases and `pure_classification` equal the
reference's.
"""

import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu import losses as jl
from ytklearn_tpu_torch import losses as pl

RTOL = 1e-6
SCALAR = ["sigmoid", "l2", "l1", "huber", "huber@0.3", "poisson", "mape",
          "inv_mape", "smape", "hinge", "l2_hinge", "smooth_hinge",
          "exponential"]
MULTI = ["softmax", "hsoftmax", "multiclass_hinge", "multiclass_l2_hinge",
         "multiclass_smooth_hinge"]
FNS = ["loss", "predict", "first_derivative", "second_derivative",
       "grad_hess"]
N, K = 257, 4


def _inputs(name):
    rng = np.random.RandomState(zlib.crc32(name.encode()))
    if name in MULTI:
        s = (rng.randn(N, K - 1 if name == "hsoftmax" else K) * 2
             ).astype(np.float32)
        y = np.eye(K, dtype=np.float32)[rng.randint(0, K, N)]
        return s, y
    s = (rng.randn(N) * 3).astype(np.float32)
    if name in ("mape", "inv_mape", "smape"):
        s = np.abs(s) + 0.5
        y = (rng.rand(N) * 4 + 0.5).astype(np.float32)
    elif name == "poisson":
        y = rng.poisson(2.0, N).astype(np.float32)
    elif name in ("l2", "l1") or name.startswith("huber"):
        y = (rng.randn(N) * 3).astype(np.float32)
    else:
        y = rng.randint(0, 2, N).astype(np.float32)
    return s, y


def _call(loss, fn, s, y):
    if fn == "predict":
        return [loss.predict(s)]
    if fn == "grad_hess":
        p = loss.predict(s)
        if loss.name == "hsoftmax":
            return None  # its grad_hess would take pred2score of K leaves
        return list(loss.grad_hess(p, y))
    return [getattr(loss, fn)(s, y)]


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.fixture(scope="module")
def jax_values():
    out = {}
    with jax.enable_x64(False):
        for name in SCALAR + MULTI:
            s, y = _inputs(name)
            loss = jl.create_loss(name)
            for fn in FNS:
                r = _call(loss, fn, jnp.asarray(s), jnp.asarray(y))
                out[name, fn] = None if r is None else [np.asarray(v)
                                                        for v in r]
    return out


@pytest.mark.parametrize("fn", FNS)
@pytest.mark.parametrize("name", SCALAR + MULTI)
def test_loss_functions_match_jax(name, fn, jax_values):
    s, y = _inputs(name)
    got = _call(pl.create_loss(name), fn, torch.from_numpy(s),
                torch.from_numpy(y))
    want = jax_values[name, fn]
    if want is None:
        assert got is None
        return
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g.numpy(), w)


def test_sigmoid_zmax_caps_the_hessian():
    rng = np.random.RandomState(3)
    p = rng.rand(64).astype(np.float32)
    y = rng.randint(0, 2, 64).astype(np.float32)
    with jax.enable_x64(False):
        want = jl.create_loss("sigmoid", {"sigmoid_zmax": 1.5}).grad_hess(
            jnp.asarray(p), jnp.asarray(y))
        want = [np.asarray(v) for v in want]
    got = pl.create_loss("sigmoid", {"sigmoid_zmax": 1.5}).grad_hess(
        torch.from_numpy(p), torch.from_numpy(y))
    for g, w in zip(got, want):
        _close(g.numpy(), w)


@pytest.mark.parametrize("name", SCALAR + MULTI + [
    "sigmoid_cross_entropy", "softmax_cross_entropy",
    "hsoftmax_cross_entropy", "l2_cross_entropy", "nope"])
def test_factory_names_and_pure_classification(name):
    assert pl.pure_classification(name) == jl.pure_classification(name)
    try:
        want = jl.create_loss(name)
    except ValueError:
        with pytest.raises(ValueError, match="unsupported loss"):
            pl.create_loss(name)
        return
    got = pl.create_loss(name)
    assert got.name == want.name
    assert got.is_multiclass == want.is_multiclass
    assert getattr(got, "delta", None) == getattr(want, "delta", None)


def test_pred2score_of_a_host_float_stays_a_float():
    assert pl.create_loss("sigmoid").pred2score(0.5) == 0.0
    assert isinstance(pl.create_loss("l2").pred2score(0.25), float)
