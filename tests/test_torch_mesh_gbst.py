"""The port's GBST on N gloo ranks on the CPU (GBSTTrainer(mesh=...)),
held against the port's one-rank trainer and the JAX package's
GBSTTrainer on a mesh of N devices, on the same seeded convex_synth text
(tests/test_torch_gbst.py's cases; the cases and tolerances in
tests/torch_mesh_cases.py).

Every variant (gbhsdt as a random_forest), two trees of GBST_HELD_ITERS =
6 L-BFGS iterations (past about six the fits part in f32 sum order), 0.8
instance and feature rates: the same tree count, the train and test
losses within rtol 1e-4 and test AUC within 1e-4; every rank reports the
same numbers. GBST trains on 1200 rows: the instance stream draws one
value a row of the padded rows, as the reference's mesh does, so with
padding the second tree's draws would not be the one-rank run's. A
SIGTERM that reaches one rank stops every rank at the same tree, rank 0
having dumped the finished trees. The ranks run once a world size
(tests/torch_mp_worker.py)."""

import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from torch_mesh_cases import GBST_VARIANTS, WORLDS, Runs, agree, \
    check_preempted, gbst_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = gbst_cases(tmp_path_factory.mktemp("gbst_data"))
    return Runs(cases, tmp_path_factory, "gbst")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", GBST_VARIANTS)
def test_ranks_equal_one_rank(runs, name, world):
    want = runs.one(name)
    for rec in runs.ranks[world]:
        agree(rec[name], want)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", GBST_VARIANTS)
def test_ranks_equal_jax_mesh(runs, name, world):
    agree(runs.ranks[world][0][name], runs.jax(name, world))


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_reports_the_same_numbers(runs, world):
    for rec in runs.ranks[world][1:]:
        for name in GBST_VARIANTS:
            assert rec[name] == runs.ranks[world][0][name]


@pytest.mark.parametrize("world", WORLDS)
def test_preemption_is_agreed_by_every_rank(runs, world):
    """A SIGTERM that reaches the last rank alone after tree 0: every rank
    stops before tree 1 (the tree boundary's pmax) with the signal's exit
    code; rank 0 has dumped tree 0, no other rank dumps."""
    check_preempted(runs, world, "gbmlr", "trees=1")


def test_only_rank0_dumps(runs):
    for w in WORLDS:
        base = runs.dirs[w]
        assert (base / f"gbmlr.w{w}.r0" / "model" / "tree-info").exists()
        for r in range(1, w):
            for name in GBST_VARIANTS:
                assert not (base / f"{name}.w{w}.r{r}").exists()
