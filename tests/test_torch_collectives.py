"""The port's collective verbs (ytklearn_tpu_torch/parallel/collectives.py)
on N gloo ranks on the CPU, held against the JAX package's verbs on the
same inputs over an N-device slice of the 8-device CPU mesh
(tests/test_collectives.py's cases at N = 2 and 4): integer results and
pargmax_tuple exactly, float sums at rtol 1e-6. Also the host verbs
(host_allgather_objects, load_on_rank0, equal_row_target), the census and
the `collective.host` chaos seam, and the metrics across ranks
(EvalSet(mesh=...): each rank's accumulators psummed, weight-0 padding
rows on the last rank): the psummed AUC histogram is the one-rank
histogram exactly for unit and integer weights, so the AUC is the
one-rank AUC; the pointwise metrics and the confusion accuracy within
rtol 1e-5 (f32 sums in another order); pointwise_sums and
pointwise_finalize against the JAX package's, padding rows included. The
ranks run once a world size (tests/torch_mp_worker.py)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu.parallel import DATA_AXIS, collectives as jcoll, make_mesh
from ytklearn_tpu.parallel.mesh import shard_map_compat

from torch_mp_worker import EVAL_METRICS, coll_inputs, eval_inputs, \
    run_ranks

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = {}
    for w in WORLDS:
        d = tmp_path_factory.mktemp(f"coll{w}")
        out[w] = run_ranks("collectives", w, str(d))
    return out


def _jax(world, fn, *arrays):
    """fn over the (world, ...) stacked per-rank inputs, each rank's output
    stacked the same way."""
    mesh = make_mesh(world)

    def body(*xs):
        res = fn(*(x[0] for x in xs))
        return jax.tree_util.tree_map(lambda r: jnp.asarray(r)[None], res)

    f = shard_map_compat(body, mesh=mesh,
                         in_specs=tuple(P(DATA_AXIS) for _ in arrays),
                         out_specs=P(DATA_AXIS), check_vma=False)
    out = jax.jit(f)(*(jnp.asarray(a) for a in arrays))
    return jax.tree_util.tree_map(np.asarray, out)


def _rank_stack(res, key):
    return np.stack([r[key] for r in res])


def _close_sum(got, want, mag):
    """Float sums in another order: within rtol 1e-6 of the operands'
    summed magnitude `mag` (a relative bound on the sum itself fails where
    the operands cancel)."""
    assert got.shape == want.shape
    assert (np.abs(got - want) <= 1e-6 * mag).all(), np.abs(got - want).max()


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("verb,key,src", [
    ("psum", "psum_f", "f"), ("psum", "psum_i", "i"),
    ("pmax", "pmax_f", "f"), ("pmin", "pmin_i", "i"),
])
def test_reductions_match_jax(ranks, world, verb, key, src):
    inp = coll_inputs(world)[src]
    want = _jax(world, getattr(jcoll, verb), inp)
    got = _rank_stack(ranks[world], key)
    assert got.dtype == want.dtype
    if np.issubdtype(got.dtype, np.integer) or verb != "psum":
        np.testing.assert_array_equal(got, want)
    else:
        _close_sum(got, want, np.abs(inp).sum(axis=0))


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("key,src,dim", [
    ("scatter0", "sc0", 0), ("scatter1", "sc1", 1), ("scatter1f", "sc1f", 1),
])
def test_psum_scatter_matches_jax(ranks, world, key, src, dim):
    """Each rank keeps its contiguous slice of dim `dim` of the global sum
    (the engine scatters node histograms over dim 1, the features); int32
    sums exact."""
    inp = coll_inputs(world)[src]
    want = _jax(world, lambda x: jcoll.psum_scatter(
        x, scatter_dimension=dim), inp)
    got = _rank_stack(ranks[world], key)
    assert got.shape == want.shape
    if np.issubdtype(got.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        mag = np.abs(inp).sum(axis=0)  # (... k * world along dim ...)
        k = mag.shape[dim] // world
        mag = np.stack([np.take(mag, np.arange(r * k, (r + 1) * k),
                                axis=dim) for r in range(world)])
        _close_sum(got, want, mag)


@pytest.mark.parametrize("world", WORLDS)
def test_all_gather_matches_jax(ranks, world):
    inp = coll_inputs(world)["ag"]
    want = _jax(world, jcoll.all_gather, inp)
    np.testing.assert_array_equal(_rank_stack(ranks[world], "gather"), want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["tie", "nan_all", "nan_part"])
def test_pargmax_tuple_matches_jax(ranks, world, case):
    """The tie goes to the lowest rank, a NaN score never wins, all-NaN
    nodes fall to rank 0 with -inf; payloads of both dtypes come through
    exactly and replicated."""
    inp = coll_inputs(world)
    want = _jax(world, lambda s, pf, pi: jcoll.pargmax_tuple(
        s, (pf, pi)), inp[case], inp["pay_f"], inp["pay_i"])
    wbest, (wpf, wpi) = want
    for r, res in enumerate(ranks[world]):
        best, pf, pi = res[f"pargmax_{case}"]
        np.testing.assert_array_equal(best, wbest[r])
        np.testing.assert_array_equal(pf, wpf[r])
        np.testing.assert_array_equal(pi, wpi[r])
    if case == "tie":
        # ranks 1 and 3 hold the max 5.0: rank 1 wins
        np.testing.assert_array_equal(ranks[world][0]["pargmax_tie"][1],
                                      inp["pay_f"][1])
    if case == "nan_all":
        assert np.isneginf(ranks[world][0]["pargmax_nan_all"][0]).all()
        np.testing.assert_array_equal(ranks[world][0]["pargmax_nan_all"][1],
                                      inp["pay_f"][0])


@pytest.mark.parametrize("world", WORLDS)
def test_pargmax_inf_payload_on_loser(ranks, world):
    """A losing rank's -inf payload never poisons the winner's value."""
    inp = coll_inputs(world)
    want = _jax(world, lambda s, p: jcoll.pargmax_tuple(s, (p,)),
                inp["inf_score"], inp["inf_pay"])
    for r, res in enumerate(ranks[world]):
        best, pf = res["pargmax_inf"]
        np.testing.assert_array_equal(best, want[0][r])
        np.testing.assert_array_equal(pf, want[1][0][r])
        assert (pf == 42.0).all()


@pytest.mark.parametrize("world", WORLDS)
def test_host_verbs_and_chaos_seam(ranks, world):
    for r, res in enumerate(ranks[world]):
        assert res["allgather_objects"] == [
            {"rank": i, "s": "x" * i} for i in range(world)]
        assert res["load_on_rank0"] == "read by 0"
        # the largest count (100 + 37 (world - 1)) padded to 8; one ingest:
        # the global count padded to world x 8
        top = 100 + 37 * (world - 1)
        assert res["equal_row_target"] == -(-top // 8) * 8
        assert res["equal_row_target_shared"] == -(-1000 // (8 * world)) \
            * 8 * world
        # the seam fires before any byte moves: fatal, named by its site
        assert res["chaos"] is not None and "collective.host" in res["chaos"]


@pytest.mark.parametrize("world", WORLDS)
def test_census_counts_every_call(ranks, world):
    """Every executed call counts with its operand bytes (4 bytes a lane
    here): psum 2 calls, psum_scatter 3, pargmax 4 (score and payloads)."""
    c = ranks[world][0]["census"]
    inp = coll_inputs(world)
    assert c["psum"]["calls"] == 2
    assert c["psum"]["bytes"] == 2 * inp["f"][0].nbytes
    assert c["psum_scatter"]["calls"] == 3
    assert c["psum_scatter"]["bytes"] == (inp["sc0"][0].nbytes
                                          + inp["sc1"][0].nbytes
                                          + inp["sc1f"][0].nbytes)
    assert c["all_gather"] == {"calls": 1, "bytes": inp["ag"][0].nbytes,
                               "staged": 0}
    assert c["pargmax"]["calls"] == 4
    assert c["pargmax"]["bytes"] == 3 * 3 * 16 + 2 * 16
    assert all(v["staged"] == 0 for v in c.values())
    assert "host_allgather" not in c


@pytest.mark.parametrize("world", WORLDS)
def test_census_counts_host_allgather(ranks, world):
    """host_allgather_objects counts in the same census as the tensor
    verbs: two calls (the gather and load_on_rank0's), their pickled bytes,
    none staged."""
    import pickle

    for r, res in enumerate(ranks[world]):
        want = (len(pickle.dumps({"rank": r, "s": "x" * r}))
                + len(pickle.dumps("read by 0" if r == 0 else None)))
        assert res["census_host"] == {"calls": 2, "bytes": want,
                                      "staged": 0}


def _one_rank_eval():
    import torch

    from ytklearn_tpu_torch.eval import EvalSet

    t = {k: torch.from_numpy(v) for k, v in eval_inputs().items()}
    ev = EvalSet(EVAL_METRICS)
    return {
        "eval_binary": ev.evaluate(t["pred"], t["y"], t["w_int"]),
        "eval_reg": ev.evaluate(t["pred"], t["y_reg"], t["w_unit"]),
        "eval_multi": EvalSet(["auc", "confusion_matrix"], K=5).evaluate(
            t["prob"], t["onehot"], t["w_int"]),
    }


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("w", ["w_unit", "w_int"])
def test_psummed_auc_histogram_is_one_rank_histogram(ranks, world, w):
    from ytklearn_tpu_torch.eval import auc_histogram
    import torch

    inp = eval_inputs()
    want = auc_histogram(*(torch.from_numpy(inp[k])
                           for k in ("pred", "y", w))).numpy()
    for rec in ranks[world]:
        np.testing.assert_array_equal(rec[f"auc_hist_{w}"], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", ["eval_binary", "eval_reg", "eval_multi"])
def test_evalset_over_ranks_is_one_rank(ranks, world, case):
    want = _one_rank_eval()[case]
    for rec in ranks[world]:
        got = rec[case]
        assert got == ranks[world][0][case]  # the same bits on every rank
        assert set(got) == set(want)
        for k, v in want.items():
            if k == "auc":
                assert got[k] == v
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5)
            # mape divides by the label: binary labels' zeros make it
            # inf on one rank too; the padding rows never do
            assert np.isfinite(got[k]) == np.isfinite(v)


@pytest.mark.parametrize("kind", ["rmse", "mae", "mape", "smape"])
def test_pointwise_sums_match_jax(kind):
    """Padding rows (weight 0, label 0) contribute nothing, also to mape
    and smape, which divide by the label."""
    import torch

    from ytklearn_tpu.eval import metrics as jm
    from ytklearn_tpu_torch.eval import pointwise_finalize, pointwise_sums

    inp = eval_inputs()
    pad = 5
    pred = np.concatenate([inp["pred"], np.zeros(pad, np.float32)])
    y = np.concatenate([inp["y_reg"], np.zeros(pad, np.float32)])
    w = np.concatenate([inp["w_int"], np.zeros(pad, np.float32)])
    got = pointwise_sums(torch.from_numpy(pred), torch.from_numpy(y),
                         torch.from_numpy(w), kind)
    with jax.enable_x64(False):
        want = jm.pointwise_sums(jnp.asarray(pred), jnp.asarray(y),
                                 jnp.asarray(w), kind)
        want_fin = float(jm.pointwise_finalize(want, kind))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(float(pointwise_finalize(got, kind)),
                               want_fin, rtol=1e-5)
