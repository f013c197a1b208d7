"""The kernels <-> ranks cross-check against the recorded golden tree
(the JAX package's ``scripts/cross_check.py``, its sharded arm).

The JAX package recorded, on a TPU, the tree its Pallas growth program
grew on one deterministic case (full scan, leaf-partitioned and fused
partitioned alike) after asserting that its 8-shard program grew the same:
``tests/data/crosscheck_tree.json``. int8 histograms make the equality
exact (order-independent int32 sums). This script grows that case with
the port's engine:

  card   on one card: the full-scan K2, the partitioned rungs (rows
         gathered, then K2) and the fused gathered rungs (K4), K5 routing;
  ranks  on N gloo ranks on the CPU (default 8): the sharded engine
         (psum_scatter over the feature axis, pargmax_tuple), each rank's
         rows through the kernels' plain versions;

and holds every tree to the golden one (structure exact, leaves to 2e-6,
as the JAX package's test does). It prints one JSON line and exits 0 when
every arm it ran matched.

    python -m ytklearn_tpu_torch.scripts.cross_check [--arm card|ranks|all]
        [--ranks 8] [--device cuda]

The ranks arm needs no card; the card arm needs one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from typing import Dict, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
GOLDEN = os.path.join(REPO, "tests", "data", "crosscheck_tree.json")
LEAF_ATOL = 2e-6


def make_case():
    """The JAX script's case: exact bins (few distinct values) and f32
    gradients, so every backend sees bit-identical inputs."""
    rng = np.random.RandomState(42)
    n, F, B = 32768, 8, 64
    bins = rng.randint(0, B, size=(n, F)).astype(np.int32)
    logit = (0.08 * bins[:, 0] - 0.05 * bins[:, 1]
             + 0.3 * ((bins[:, 2] > 32) & (bins[:, 3] < 16)))
    y = (logit + rng.randn(n) > 1.0).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-(logit - 1.0))).astype(np.float32)
    g = (p - y).astype(np.float32)
    h = np.maximum(p * (1 - p), 1e-6).astype(np.float32)
    return bins, g, h, n, F, B


def spec_for(F: int, B: int, partition: bool, fused: bool = False):
    from ..gbdt.engine import GrowSpec

    return GrowSpec(
        F=F, B=B, max_nodes=31, wave=4, policy="loss", max_depth=20,
        max_leaves=16, lr=0.1, l1=0.0, l2=1.0, min_h=1.0, max_abs=0.0,
        min_split_loss=0.0, min_split_samples=0.0, hist_mode="int8",
        partition=partition, fused=fused, bm=4096, bm_g=1024,
        fused_max_rows=1 << 18,
    )


def tree_sig(tr) -> Dict:
    return {
        "feat": tr.feat.cpu().tolist(),
        "slot": tr.slot.cpu().tolist(),
        "left": tr.left.cpu().tolist(),
        "right": tr.right.cpu().tolist(),
        "leaf": [round(float(v), 6) for v in tr.leaf.cpu().numpy()],
        "n_nodes": int(tr.n_nodes),
    }


def grow_case(device, partition: bool, fused: bool = False, mesh=None):
    """The case's tree on `device` (this rank's rows under `mesh`)."""
    import torch

    from ..gbdt.engine import grow

    bins, g, h, n, F, B = make_case()
    lo, hi = 0, n
    if mesh is not None:
        k = n // mesh.world
        lo, hi = mesh.rank * k, (mesh.rank + 1) * k
    dev = torch.device(device)
    bins_t = torch.from_numpy(np.ascontiguousarray(bins[lo:hi].T)).to(dev)
    tr, _pos, _aux, _wlog = grow(
        spec_for(F, B, partition, fused), bins_t.to(torch.uint8),
        torch.ones(hi - lo, dtype=torch.bool, device=dev),
        torch.from_numpy(g[lo:hi]).to(dev), torch.from_numpy(h[lo:hi]).to(dev),
        torch.ones(F, dtype=torch.bool, device=dev), mesh=mesh)
    return tree_sig(tr)


def matches(sig: Dict, golden: Dict) -> bool:
    """Structure exact, leaves within LEAF_ATOL."""
    if any(sig[k] != golden[k] for k in ("n_nodes", "feat", "slot", "left",
                                         "right")):
        return False
    return bool(np.allclose(sig["leaf"], golden["leaf"], rtol=0.0,
                            atol=LEAF_ATOL))


def card_arm(device: str = "cuda") -> Dict[str, Dict]:
    """The three rungs' trees on one card."""
    return {
        "full_scan": grow_case(device, partition=False),
        "partitioned": grow_case(device, partition=True, fused=False),
        "fused_partitioned": grow_case(device, partition=True, fused=True),
    }


def _rank_main(rank: int, world: int, addr: str, out: str) -> None:
    from ..parallel.mesh import distributed_initialize_if_needed, \
        make_mesh, release_mesh

    distributed_initialize_if_needed(coordinator=addr, world_size=world,
                                     rank=rank, device="cpu",
                                     backend="gloo")
    try:
        mesh = make_mesh("cpu", shared_ingest=True)
        sigs = {
            "sharded": grow_case("cpu", partition=False, mesh=mesh),
            "sharded_partitioned": grow_case("cpu", partition=True,
                                             fused=True, mesh=mesh),
        }
        if rank == 0:
            with open(out, "w") as f:
                json.dump(sigs, f)
    finally:
        release_mesh()


def ranks_arm(world: int = 8) -> Dict[str, Dict]:
    """The sharded engine on `world` gloo ranks on the CPU."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="ytk_cross_") as d:
        out = os.path.join(d, "sigs.json")
        rdv = f"file://{os.path.join(d, 'rendezvous')}"
        mp.start_processes(_rank_main, args=(world, rdv, out), nprocs=world,
                           join=True, start_method="spawn")
        with open(out) as f:
            return json.load(f)


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arm", choices=("card", "ranks", "all"), default="all")
    ap.add_argument("--ranks", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with open(GOLDEN) as f:
        golden = json.load(f)
    sigs: Dict[str, Dict] = {}
    if args.arm in ("card", "all"):
        import torch

        if args.device.startswith("cuda") and not torch.cuda.is_available():
            print("the card arm needs a CUDA device", file=sys.stderr)
            return 2
        sigs.update(card_arm(args.device))
    if args.arm in ("ranks", "all"):
        sigs.update(ranks_arm(args.ranks))
    result = {k: matches(v, golden) for k, v in sigs.items()}
    out = {"ok": all(result.values()), "n_nodes": golden["n_nodes"],
           "ranks": args.ranks if args.arm != "card" else None, **result}
    print(json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
