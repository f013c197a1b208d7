"""The port's convex families on N gloo ranks on the CPU
(HoagTrainer(mesh=...)), held against the port's one-rank trainer and the
JAX package's HoagTrainer on a mesh of N devices, on the same seeded
convex_synth text (tests/test_torch_hoag_train.py's cases, cut to a few
iterations; the cases and tolerances in tests/torch_mesh_cases.py).

Each rank sees every row and trains on its contiguous block (the
reference's one-process mesh, `cli train --devices N`); the rows (1201
train, 301 test) split unevenly, so the last rank holds weight-0 padding
rows. The runs: linear with L-BFGS and with OWL-QN (l1 > 0),
multiclass_linear (softmax, K = 5), FM, FFM, a grid of three l2 rounds and
three HOAG rounds; each at a fixed max_iter gives the same iterations and
status, the average train loss and the test loss within rtol 1e-4 and
each metric (AUC, rmse; the confusion accuracy) within 1e-4 (float32
sums in another order), and every rank reports the same numbers. A
SIGTERM that reaches one rank stops every rank after the same iteration,
rank 0 dumping. The ranks run once a world size (tests/torch_mp_worker.py)."""

import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from torch_mesh_cases import CONVEX_NAMES, WORLDS, Runs, agree, \
    check_preempted, convex_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = convex_cases(tmp_path_factory.mktemp("convex_data"))
    return Runs(cases, tmp_path_factory, "convex")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONVEX_NAMES)
def test_ranks_equal_one_rank(runs, name, world):
    want = runs.one(name)
    for rec in runs.ranks[world]:
        agree(rec[name], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONVEX_NAMES)
def test_ranks_equal_jax_mesh(runs, name, world):
    agree(runs.ranks[world][0][name], runs.jax(name, world))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same_numbers(runs, world):
    """Every loss and metric is a psum: the ranks report the same bits."""
    for rec in runs.ranks[world][1:]:
        for name in CONVEX_NAMES:
            assert rec[name] == runs.ranks[world][0][name]


@pytest.mark.parametrize("world", WORLDS)
def test_preemption_is_agreed_by_every_rank(runs, world):
    """A SIGTERM that reaches the last rank alone: every rank agrees (a
    pmax of the guard's flag) and stops after iteration 2 with the
    signal's exit code; rank 0 dumps the checkpoint, no other rank does."""
    check_preempted(runs, world, "linear", "iteration=2")


@pytest.mark.parametrize("world", WORLDS)
def test_linear_dump_holds_the_one_rank_weights_and_precision(runs, world):
    """Rank 0's linear text: every feature of the one-rank text, its
    weight and its Laplace precision (each rank's curvature sum, psummed,
    the l2 term added once) within rtol 1e-4 of the one-rank values (the
    text keeps 6 decimals)."""
    import os

    import numpy as np

    runs.one("linear")

    def read(path):
        out = {}
        with open(os.path.join(path, "model-00000")) as f:
            for line in f:
                name, w, prec = line.strip().split(",")
                out[name] = (float(w), None if prec == "null"
                             else float(prec))
        return out

    want = read(runs.one_paths["linear"])
    got = read(runs.dirs[world] / f"linear.w{world}.r0" / "model")
    assert set(got) == set(want)
    for name, (w, prec) in want.items():
        np.testing.assert_allclose(got[name][0], w, rtol=1e-4, atol=2e-6)
        if prec is None:
            assert got[name][1] is None
        else:
            np.testing.assert_allclose(got[name][1], prec, rtol=1e-4,
                                       atol=2e-6)


def test_only_rank0_dumps(runs):
    """Rank 0 dumps each model text; every other rank, pointed at a path
    of its own, writes nothing."""
    for w in WORLDS:
        base = runs.dirs[w]
        assert (base / f"linear.w{w}.r0" / "model" / "model-00000").exists()
        for r in range(1, w):
            for name in CONVEX_NAMES:
                assert not (base / f"{name}.w{w}.r{r}").exists()
