"""The port's K8 (`hist_q_u8`, its plain version on the CPU) against the
reference's own `hist_q_u8`, the tuning variant nested in
scripts/tune_hist_kernel.py::main.

The reference function is taken from the script's source with `ast` (the
script is not edited) and run as the JAX package's tests run Pallas on the
CPU: its `pl.pallas_call` bound to `interpret=True`. It is also held
against the dense int32 einsum `_hist_dense_q` and against K2's port
(`hist_wave_q`) in K8's layout. Int32 sums do not depend on order, so every
comparison is exact (np.array_equal).
"""

import ast
import functools
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.gbdt import hist as jhist
from ytklearn_tpu_torch.gbdt import hist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "tune_hist_kernel.py")


@functools.lru_cache(maxsize=None)
def _reference_hist_q_u8():
    """scripts/tune_hist_kernel.py's nested hist_q_u8, compiled from its
    own source with pallas_call under the interpreter."""
    with open(SCRIPT, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=SCRIPT)
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    fn = next(n for n in main.body
              if isinstance(n, ast.FunctionDef) and n.name == "hist_q_u8")
    module = ast.fix_missing_locations(ast.Module(body=[fn], type_ignores=[]))
    interp_pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id, when=pl.when)
    scope = {"jax": jax, "jnp": jnp, "pl": interp_pl, "pltpu": pltpu}
    exec(compile(module, SCRIPT, "exec"), scope)
    return scope["hist_q_u8"]


def _case(N, F, B, n, seed, dup):
    """Bins over all 256 byte values (bins >= B fall outside the
    histogram), positions over 2N+3 nodes with dead rows, quantized grads
    touching +-127, N wave ids; `dup`: one id twice and a -2 pad."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, min(256, B + 4), size=(F, n)).astype(np.uint8)
    M = 2 * N + 3
    pos = rng.randint(-1, M, size=n).astype(np.int32)
    gq = rng.randint(-127, 128, size=n).astype(np.float32)
    hq = rng.randint(0, 128, size=n).astype(np.float32)
    gq[:4] = [127, -127, 127, -127]
    ids = rng.choice(M, size=N, replace=False).astype(np.int32)
    if dup:
        ids[N - 1] = ids[1]
        ids[0] = -2
    return bins, pos, gq, hq, ids, M


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("N,F,B,fg,dup", [
    (1, 4, 16, 1, False), (1, 28, 256, 7, False),
    (5, 4, 256, 2, True), (5, 28, 16, 4, True),
    (32, 4, 16, 4, False), (32, 28, 256, 14, True),
])
def test_hist_q_u8_matches_the_reference_exact(N, F, B, fg, dup):
    bm, nblk = 512, 2
    n = bm * nblk
    bins, pos, gq, hq, ids, M = _case(N, F, B, n, 31 * N + F + B, dup)
    ref = _reference_hist_q_u8()
    want = np.asarray(ref(
        jnp.asarray(bins.reshape(F, nblk, 1, bm)), jnp.asarray(pos),
        jnp.asarray(gq), jnp.asarray(hq), jnp.asarray(ids), B=B, bm=bm,
        fg=fg))
    dense = np.asarray(jhist._hist_dense_q(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(pos), jnp.asarray(gq),
        jnp.asarray(hq), jnp.asarray(ids), B))
    np.testing.assert_array_equal(want, dense)
    before = hist.hist_q_u8.launches
    got = hist.hist_q_u8(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                         fg=fg)
    assert hist.hist_q_u8.launches == before  # CPU: the plain version
    assert got.dtype == torch.int32 and got.shape == (F, 3 * N, B)
    np.testing.assert_array_equal(got.numpy(), want)
    if dup:  # the duplicated id's two slots, in each channel
        for c in range(3):
            np.testing.assert_array_equal(want[:, c * N + 1],
                                          want[:, c * N + N - 1])
        assert want[:, 2 * N + 1].any() and not want[:, 2 * N].any()


@pytest.mark.parametrize("N,B,n", [(1, 256, 3001), (7, 64, 777),
                                   (64, 256, 5000)])
def test_hist_q_u8_is_k2_permuted(N, B, n):
    """K8's (F, 3N, B) rows [g*N | h*N | c*N] are K2's (N, F, B, 3) sums;
    n need not be a multiple of any block."""
    bins, pos, gq, hq, ids, M = _case(N, 6, B, n, N + n, N > 2)
    got = hist.hist_q_u8(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B)
    k2 = hist.hist_wave_q(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), B,
                          max_nodes=M)
    assert torch.equal(got, k2.permute(1, 3, 0, 2).reshape(6, 3 * N, B))
    assert torch.equal(got, hist.hist_q_u8_plain(_t(bins), _t(pos), _t(gq),
                                                 _t(hq), _t(ids), B))


def test_hist_q_u8_refuses_bad_inputs():
    bins, pos, gq, hq, ids, _ = _case(5, 3, 16, 600, 1, False)
    with pytest.raises(ValueError, match="uint8"):
        hist.hist_q_u8(_t(bins.astype(np.int32)), _t(pos), _t(gq), _t(hq),
                       _t(ids), 16)
    with pytest.raises(ValueError, match="256"):
        hist.hist_q_u8(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 257)
    with pytest.raises(ValueError, match="pos must have shape"):
        hist.hist_q_u8(_t(bins), _t(pos[:500]), _t(gq), _t(hq), _t(ids), 16)
    with pytest.raises(ValueError, match="fg"):
        hist.hist_q_u8(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 16,
                       fg=17)
    with pytest.raises(ValueError, match="rows_per_block"):
        hist.hist_q_u8(_t(bins), _t(pos), _t(gq), _t(hq), _t(ids), 16,
                       rows_per_block=0)


@pytest.mark.parametrize("N,B,fg", [(1, 256, None), (32, 256, None),
                                    (32, 256, 7), (64, 256, None),
                                    (100, 64, 3), (600, 256, 1)])
def test_u8_plan_covers_and_fits(N, B, fg):
    """Every feature's n-tiles (W rows of PV each) cover its 3N PV rows and
    its m-groups its B bins; fg's feature groups cover F and the chunks the
    rows; the ring fits SMEM_MAX and the accumulators U8_REGS; a persistent
    grid of at most one block an SM. A wave past 256 PV rows (N = 600) is
    cut into n-tiles rather than refused."""
    F, n = 28, 1280 * 8192
    p = hist.u8_plan(N, F, B, n, 132, fg)
    assert p["W"] in hist.U8_WIDTHS
    assert p["W"] * p["n_ntiles"] >= 3 * N > p["W"] * (p["n_ntiles"] - 1)
    assert 64 * p["mtw"] * p["n_mgroups"] >= B
    assert p["fg"] * p["n_fgroups"] >= F
    assert p["fg"] == (fg or p["fg"])
    assert p["threads"] == hist.U8_THREADS
    assert p["mtw"] * p["W"] // 2 + 16 * p["mtw"] <= hist.U8_REGS
    assert p["smem"] <= hist.SMEM_MAX
    assert p["rows_per_block"] * p["n_chunks"] >= n
    assert p["items"] == p["n_fgroups"] * p["n_chunks"]
    assert p["blocks"] == min(p["items"], 132)
    assert hist.check_u8_plan(dict(p), N, F, B, n) == p
    if N == 600:
        assert p["n_ntiles"] == 8 and p["regions"] == 2
