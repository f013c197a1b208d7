"""Ranks of a multi-device run (``ytklearn_tpu/parallel/mesh.py``).

The reference's world is a `jax.sharding.Mesh`: devices are the ranks and
`jax.distributed.initialize` is the rendezvous of a multi-host run. Here
one rank is one process and one device, joined by `torch.distributed`:

  Mesh                  this process's rank, the world size, its device,
                        the backend, and whether the ranks share one
                        ingest (`shared_ingest`)
  choose_backend        NCCL when every rank has a GPU of its own, gloo on
                        the CPU and when ranks share a card; chosen before
                        the group exists, never switched
  distributed_initialize_if_needed  init_process_group from a coordinator
                        `host:port` (or YTKLEARN_TPU_DISTRIBUTED=1 and
                        torch's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK),
                        with a finite timeout (TIMEOUT_S)
  make_mesh             the Mesh of the initialized group, registered as
                        this process's mesh
  process_count, process_index  the reference's jax.process_count/index:
                        the ranks that ingest a shard of their own
  equal_row_target, pad_rows_to_multiple, put_row_sharded, put_col_sharded
                        row padding and "take this rank's contiguous slice"

The two modes keep the reference's semantics. `shared_ingest=True` is its
one-process mesh of N devices (`cli train --devices N`): one launcher
parses and bins the whole data once, every rank takes its contiguous row
shard of the global rows, and process_count() is 1. `shared_ingest=False`
is its multi-process run (`--coordinator`): each process ingests its own
line shard (io/reader.py::shard_plan) and process_count() is the world.
"""

from __future__ import annotations

import datetime
import logging
import os
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
#: seconds a collective waits for its peers before the group fails the run
#: (a desync fails loudly instead of hanging)
TIMEOUT_S = 600.0

log = logging.getLogger("ytklearn_tpu_torch.parallel")


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the run."""

    rank: int
    world: int
    device: torch.device
    backend: str  # "nccl" | "gloo"
    shared_ingest: bool  # True: --devices (one ingest); False: --coordinator
    axis_name: str = DATA_AXIS

    @property
    def staged(self) -> bool:
        """gloo on a card: every verb stages its tensor through host
        memory (decided by the backend up front, never on an error)."""
        return self.backend == "gloo" and self.device.type == "cuda"


_CURRENT: Optional[Mesh] = None


def process_count() -> int:
    """Processes that ingest a shard of their own (jax.process_count):
    the world under --coordinator, else 1."""
    m = _CURRENT
    return 1 if m is None or m.shared_ingest else m.world


def process_index() -> int:
    """This process's index among process_count() (jax.process_index)."""
    m = _CURRENT
    return 0 if m is None or m.shared_ingest else m.rank


def choose_backend(devices: Sequence[torch.device]) -> str:
    """The backend for ranks on `devices`: NCCL when every rank has a GPU
    of its own, gloo on the CPU and when two ranks share a card (NCCL
    cannot join two ranks on one device)."""
    devs = [torch.device(d) for d in devices]
    if not devs or any(d.type != "cuda" for d in devs):
        return "gloo"
    idx = [d.index if d.index is not None else 0 for d in devs]
    if len(set(idx)) < len(idx):
        return "gloo"
    return "nccl" if torch.distributed.is_nccl_available() else "gloo"


def rank_device(device, rank: int, world: int) -> torch.device:
    """The device of rank `rank` under --coordinator on one host: cuda ->
    cuda:(rank mod the GPUs here), cpu -> cpu."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return torch.device("cpu")
    if dev.index is not None:
        return dev
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device is available; pass --device cpu")
    return torch.device("cuda", rank % n)


def coordinator_backend(device: torch.device, world: int) -> str:
    """--coordinator ranks cannot see each other's devices before the group
    exists: on one host, world ranks over torch.cuda.device_count() GPUs
    share a card exactly when world exceeds the count."""
    if device.type != "cuda":
        return choose_backend([device])
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", r % max(n, 1)) for r in range(world)]
    return choose_backend(devs)


def _timeout() -> datetime.timedelta:
    return datetime.timedelta(seconds=TIMEOUT_S)


def distributed_initialize_if_needed(coordinator: str = "",
                                     world_size: int = 0, rank: int = -1,
                                     device=None,
                                     backend: Optional[str] = None) -> bool:
    """The rendezvous (the reference's CommMaster, jax.distributed.initialize):
    init_process_group over `tcp://<coordinator>` (`host:port`; a URL such
    as `file:///path`, a rendezvous file for ranks on one host, passes as
    it is) with a finite timeout.
    Without a coordinator it runs only when YTKLEARN_TPU_DISTRIBUTED=1,
    then from torch's env:// variables. The backend is chosen before the
    group exists (coordinator_backend) and logged; NCCL ranks bind their
    card first (torch.cuda.set_device). Returns whether a group exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if not coordinator and os.environ.get("YTKLEARN_TPU_DISTRIBUTED",
                                          "0") != "1":
        return False
    if coordinator:
        init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        if world_size <= 0 or rank < 0:
            raise ValueError("--coordinator needs --num-processes and "
                             "--process-id")
    else:
        init = "env://"
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
    dev = rank_device("cpu" if device is None else device, rank, world_size)
    if backend is None:
        backend = coordinator_backend(dev, world_size)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    log.info("process group: rank %d of %d on %s, backend %s (%s)", rank,
             world_size, dev, backend, init)
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=world_size, rank=rank,
                            timeout=_timeout())
    return True


def make_mesh(device, shared_ingest: bool) -> Mesh:
    """The Mesh of the initialized process group on `device`, registered as
    this process's mesh (process_count, shard_plan and the host merges read
    it)."""
    global _CURRENT
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(distributed_initialize_if_needed)")
    m = Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
             device=torch.device(device), backend=dist.get_backend(),
             shared_ingest=bool(shared_ingest))
    _CURRENT = m
    return m


def release_mesh() -> None:
    """Forget this process's mesh and destroy its process group."""
    global _CURRENT
    import torch.distributed as dist

    _CURRENT = None
    if dist.is_initialized():
        dist.destroy_process_group()


def pad_rows_to_multiple(n: int, k: int) -> int:
    """Rows pad to a multiple of k for even sharding; the reference allowed
    ragged per-worker counts (dataflow/DataFlow.java:391-410), padding plus
    weight-masking is the static-shape equivalent."""
    return (n + k - 1) // k * k


def equal_row_target(n_local: int, mesh: Mesh, multiple: int = 1) -> int:
    """Rows this rank's ingest pads to so the global row axis splits evenly
    (reference mesh.py:78). Shared ingest: `n_local` is the global count,
    padded to a multiple of (world x multiple). Own ingest: the largest
    count over the ranks, padded to a multiple of `multiple`."""
    if mesh.shared_ingest:
        ld = mesh.world * max(multiple, 1)
        return max(ld, pad_rows_to_multiple(n_local, ld))
    from .collectives import host_allgather_objects

    ld = max(multiple, 1)
    counts = host_allgather_objects(int(n_local))
    return max(ld, pad_rows_to_multiple(max(counts), ld))


def local_rows(n_total: int, mesh: Mesh) -> Tuple[int, int]:
    """This rank's contiguous [lo, hi) of n_total shared-ingest rows
    (n_total divisible by the world)."""
    if n_total % mesh.world:
        raise ValueError(
            f"{n_total} rows do not split over {mesh.world} ranks")
    k = n_total // mesh.world
    return mesh.rank * k, (mesh.rank + 1) * k


def _slice(arr, dim: int, mesh: Mesh):
    if not mesh.shared_ingest:
        return arr  # already this rank's shard
    lo, hi = local_rows(arr.shape[dim], mesh)
    if isinstance(arr, np.ndarray):
        return np.take(arr, np.arange(lo, hi), axis=dim)
    return arr.narrow(dim, lo, hi - lo)


def put_row_sharded(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of dim 0, on its device. Own ingest:
    `arr` is this rank's shard already (make_array_from_process_local_data)."""
    t = _slice(arr, 0, mesh)
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(t))
    return t.to(mesh.device).contiguous()


def put_col_sharded(arr, mesh: Mesh) -> torch.Tensor:
    """This rank's contiguous slice of dim 1 (the sample axis of a
    transposed matrix), on its device."""
    t = _slice(arr, 1, mesh)
    t = t if isinstance(t, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(t))
    return t.to(mesh.device).contiguous()
