"""The port's cross-check (ytklearn_tpu_torch/scripts/cross_check.py)
against the golden tree the JAX package recorded on a TPU
(tests/data/crosscheck_tree.json): the sharded engine on 8 gloo ranks on
the CPU re-derives it (structure exact, leaves to 2e-6, as
tests/test_crosscheck.py holds the JAX package's 8-shard program), and so
do the card arm's three rungs (full scan, partitioned, fused partitioned)
run here on the kernels' plain versions."""

import json

import pytest

import torch_threads  # noqa: F401 (one torch thread a test process)
from ytklearn_tpu_torch.scripts import cross_check


@pytest.fixture(scope="module")
def golden():
    with open(cross_check.GOLDEN) as f:
        return json.load(f)


def test_eight_ranks_match_the_recorded_tree(golden):
    sigs = cross_check.ranks_arm(8)
    assert set(sigs) == {"sharded", "sharded_partitioned"}
    for name, sig in sigs.items():
        assert sig["n_nodes"] == golden["n_nodes"] == 31, name
        assert cross_check.matches(sig, golden), name


def test_card_arm_rungs_on_the_plain_versions(capsys):
    assert cross_check.main(["--arm", "card", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out == {"ok": True, "n_nodes": 31, "ranks": None,
                   "full_scan": True, "partitioned": True,
                   "fused_partitioned": True}
