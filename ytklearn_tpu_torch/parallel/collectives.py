"""The mp4j collective surface on torch.distributed
(``ytklearn_tpu/parallel/collectives.py``).

| mp4j verb (reference call site)                         | here               |
|---------------------------------------------------------|--------------------|
| allreduce scalar/array  (HoagOptimizer.java:1038)       | psum / pmax / pmin |
| reduceScatterArray      (HistogramBuilder.java:95)      | psum_scatter       |
| allgatherArray          (HoagOptimizer.java:916,928)    | all_gather         |
| object argmax allreduce (DataParallelTreeMaker.java:642)| pargmax_tuple      |
| allreduceMap (GK summaries, CoreData.java:628)          | host_allgather_    |
|                                                         | objects            |

Every verb takes the rank's `Mesh` (parallel/mesh.py) where the reference
names an axis, runs eagerly on the rank's tensors and returns new tensors
(its input is left as it was). Under NCCL the tensors stay on the card.
Under gloo with a CUDA tensor (ranks that share a card) every verb stages
its tensor through host memory: the backend decides that up front
(`Mesh.staged`), never an error, and the census counts it. gloo's
reduce-scatter support differs between torch builds, so under gloo
psum_scatter is an all_reduce followed by the rank's slice (the same sums;
integer sums exact either way).

The census: every verb calls obs.record_collective, whose always-on
counters `collectives.<verb>.{calls,bytes,staged}` are the one record of
calls, operand bytes and staged calls per verb; obs.collective_census
reads them for a rank's report beside its kernel launch counts.
"""

from __future__ import annotations

import pickle
from typing import Dict, Sequence, Tuple

import torch

from ..obs import record_collective
from .mesh import DATA_AXIS, Mesh, process_count, process_index


def _count(verb: str, tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    nbytes = sum(int(t.numel()) * t.element_size() for t in tensors)
    record_collective(verb, nbytes, mesh.axis_name, staged=mesh.staged)


def _dist():
    import torch.distributed as dist

    return dist


def _all_reduce(x: torch.Tensor, mesh: Mesh, op) -> torch.Tensor:
    """All-reduce into a new tensor on x's device (a one-rank group runs
    it too: NCCL at world size 1 is a real path)."""
    if mesh.staged:
        t = x.detach().to("cpu", copy=True)
        _dist().all_reduce(t, op=op)
        return t.to(x.device)
    t = x.detach().clone()
    _dist().all_reduce(t, op=op)
    return t


def psum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    _count("psum", [x], mesh)
    return _all_reduce(x, mesh, _dist().ReduceOp.SUM)


def pmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    _count("pmax", [x], mesh)
    return _all_reduce(x, mesh, _dist().ReduceOp.MAX)


def pmin(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    _count("pmin", [x], mesh)
    return _all_reduce(x, mesh, _dist().ReduceOp.MIN)


def psum_scatter(x: torch.Tensor, mesh: Mesh,
                 scatter_dimension: int = 0) -> torch.Tensor:
    """reduceScatterArray, tiled: the global sum, of which each rank keeps
    its contiguous slice of dim `scatter_dimension` (input (k * world, ...)
    along it, output (k, ...)); the GBDT engine scatters node histograms
    over the feature axis, dimension 1. The collectives scatter dim 0 of a
    contiguous tensor, so the dim moves to the front and back."""
    _count("psum_scatter", [x], mesh)
    d = scatter_dimension
    if x.shape[d] % mesh.world:
        raise ValueError(f"psum_scatter: dim {d} of {tuple(x.shape)} does "
                         f"not split over {mesh.world} ranks")
    k = x.shape[d] // mesh.world
    front = x.movedim(d, 0).contiguous()
    dist = _dist()
    if mesh.backend == "gloo":
        summed = _all_reduce(front, mesh, dist.ReduceOp.SUM)
        out = summed[mesh.rank * k:(mesh.rank + 1) * k]
    else:
        out = torch.empty((k,) + tuple(front.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.reduce_scatter_tensor(out, front, op=dist.ReduceOp.SUM)
    return out.movedim(0, d).contiguous()


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """allgatherArray, tiled: every rank's x, concatenated along dim 0 in
    rank order."""
    _count("all_gather", [x], mesh)
    src = x.detach().contiguous()
    if mesh.staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(mesh.world)]
    _dist().all_gather(parts, src)
    return torch.cat(parts, 0).to(x.device)


def pargmax_tuple(score: torch.Tensor, payload: Sequence[torch.Tensor],
                  mesh: Mesh) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Global argmax with a deterministic tie-break, elementwise over the
    score's shape (reference :80-111; SplitInfo.needReplace: the higher
    score wins, a tie goes to the lower rank).

    A NaN score counts as -inf, so it never wins and never poisons the max;
    all ranks -inf or NaN gives rank 0 with -inf. The payload is
    select-then-sum: the winner contributes its value, every other rank
    the additive identity (-0.0 for floats, so even a -0.0 or an inf comes
    through bit for bit, and a loser's +-inf or NaN never enters). The
    payload goes in one sum per dtype. Returns (best score, payload)
    replicated on every rank."""
    payload = tuple(payload)
    _count("pargmax", [score, *payload], mesh)
    dist = _dist()
    score = torch.where(torch.isnan(score),
                        torch.full_like(score, float("-inf")), score)
    best = _all_reduce(score, mesh, dist.ReduceOp.MAX)
    vote = torch.where(score >= best, mesh.rank, mesh.world).to(torch.int32)
    winner = _all_reduce(vote, mesh, dist.ReduceOp.MIN)
    is_w = winner == mesh.rank
    out = [None] * len(payload)
    groups: Dict[torch.dtype, list] = {}
    for i, leaf in enumerate(payload):
        groups.setdefault(leaf.dtype, []).append(i)
    for dt, idx in groups.items():
        zero = -0.0 if dt.is_floating_point else 0
        stacked = torch.stack([
            torch.where(is_w, payload[i], torch.full_like(payload[i], zero))
            for i in idx])
        summed = _all_reduce(stacked, mesh, dist.ReduceOp.SUM)
        for j, i in enumerate(idx):
            out[i] = summed[j]
    return best, tuple(out)


def from_rank0(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Rank 0's x on every rank: a psum to which the other ranks add the
    identity (-0.0 for floats), so the value comes through bit for bit."""
    zero = -0.0 if x.dtype.is_floating_point else 0
    return psum(x if mesh.rank == 0 else torch.full_like(x, zero), mesh)


def any_rank(flag: bool, mesh: Mesh) -> bool:
    """True on every rank when `flag` is True on any (a pmax): a signal
    that reached one rank stops them all at the same boundary."""
    t = torch.tensor([int(bool(flag))], dtype=torch.int32,
                     device=mesh.device)
    return bool(pmax(t, mesh).item())


def axis_index(mesh: Mesh) -> int:
    return mesh.rank


def axis_size(mesh: Mesh) -> int:
    return mesh.world


# ---------------------------------------------------------------------------
# Host-side (load-time) small-object merges: allreduceMap /
# allreduceMapSetUnion for feature dicts and sketches across processes
# ---------------------------------------------------------------------------


def load_on_rank0(fn):
    """Run `fn()` on process 0 and hand its value to every process (a
    rank-0-only dump must not diverge on storage that is not shared). One
    process: just `fn()`. Every process MUST call it at the same point:
    it is a collective."""
    obj = fn() if process_index() == 0 else None
    if process_count() == 1:
        return obj
    return host_allgather_objects(obj)[0]


def host_allgather_objects(obj):
    """A small python object from every process, as a list in rank order
    (one process: [obj]); pickled, through all_gather_object. Load time
    only, never the hot path.

    The `collective.host` fault site sits here: the host verbs are the
    ones a flaky network or a dying peer breaks. No retry: a rank that
    re-entered a collective alone would desync the group, so a fault here
    is fatal by design and the flight event names it."""
    from ..obs import span as obs_span
    from ..resilience import chaos_point

    chaos_point("collective.host")
    if process_count() == 1:
        return [obj]
    nbytes = len(pickle.dumps(obj))
    with obs_span("collectives.host_allgather", bytes=nbytes):
        record_collective("host_allgather", nbytes, DATA_AXIS)
        out = [None] * process_count()
        _dist().all_gather_object(out, obj)
        return out
