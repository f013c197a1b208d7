"""Blocked (row-chunked) loss, gradient and score evaluation
(``ytklearn_tpu/optimize/blocked.py``).

The reference never holds a whole partition's per-sample intermediates at
once: CoreData is blocked storage (dataflow/CoreData.java:51-52) and every
convex optimizer walks its blocks. Here the loss and its gradient are row
sums, so a loop over row chunks adds them up with peak memory O(chunk x
per-row cost); chunking changes only the f32 sum order. A chunk is never
padded: the last one is shorter. Batch entries that are not row-aligned
(GBST's per-feature gate mask) pass whole into every chunk, as
`row_mask` marks them.

The mesh variants run on a rank's own rows with w replicated: the local
chunk loop (or one pass when there is no chunk), then one psum of the
loss and the gradient over the ranks (parallel/collectives.py), the
reference's gradient allreduce (HoagOptimizer.java:1038). Every rank gets
the same bits back, so the host's decisions on them agree. Per-row
outputs stay on their rank (`mesh_blocked_rows`, no collective).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch

from ..config import knobs


def value_and_grad(fn: Callable) -> Callable:
    """(w, *batch) -> (fn(w, *batch), its gradient with respect to w),
    by autograd; w itself is not touched."""

    def run(w, *batch):
        with torch.enable_grad():
            wv = w.detach().requires_grad_(True)
            loss = fn(wv, *batch)
            (g,) = torch.autograd.grad(loss, wv)
        return loss.detach(), g

    return run


def _chunks(batch, chunk: int, row_mask: Optional[Sequence[bool]] = None):
    """Row chunks of `batch`; entries that `row_mask` marks False (not
    row-aligned) go whole into every chunk."""
    mask = (True,) * len(batch) if row_mask is None else tuple(row_mask)
    n = next(a for a, r in zip(batch, mask) if r).shape[0]
    for s in range(0, n, chunk):
        yield tuple(a[s:s + chunk] if r else a for a, r in zip(batch, mask))


def chunked_value_and_grad(fn: Callable, chunk: int,
                           row_mask: Optional[Sequence[bool]] = None
                           ) -> Callable:
    """(w, *batch) -> (sum loss, sum grad) over row chunks; `fn` returns a
    weighted sum (not a mean), so chunk sums compose."""
    vg = value_and_grad(fn)

    def run(w, *batch):
        loss = torch.zeros((), dtype=w.dtype, device=w.device)
        grad = torch.zeros_like(w)
        for ch in _chunks(batch, chunk, row_mask):
            l, g = vg(w, *ch)
            loss = loss + l
            grad = grad + g
        return loss, grad

    return run


def chunked_sum(fn: Callable, chunk: int,
                row_mask: Optional[Sequence[bool]] = None) -> Callable:
    """(w, *batch) -> sum loss over row chunks, no gradient."""

    def run(w, *batch):
        loss = torch.zeros((), dtype=w.dtype, device=w.device)
        with torch.no_grad():
            for ch in _chunks(batch, chunk, row_mask):
                loss = loss + fn(w, *ch)
        return loss

    return run


def blocked_rows(fn: Callable, chunk: int,
                 row_mask: Optional[Sequence[bool]] = None) -> Callable:
    """Per-row outputs fn(w, *batch) -> (n, ...) over row chunks,
    concatenated."""

    def run(w, *batch):
        with torch.no_grad():
            return torch.cat([fn(w, *ch)
                              for ch in _chunks(batch, chunk, row_mask)])

    return run


def _no_grad(fn: Callable) -> Callable:
    def run(w, *batch):
        with torch.no_grad():
            return fn(w, *batch)

    return run


def _local_value_and_grad(fn, chunk=None, row_mask=None):
    return value_and_grad(fn) if chunk is None \
        else chunked_value_and_grad(fn, chunk, row_mask)


def _local_sum(fn, chunk=None, row_mask=None):
    return _no_grad(fn) if chunk is None else chunked_sum(fn, chunk, row_mask)


def _local_rows(fn, chunk=None, row_mask=None):
    return _no_grad(fn) if chunk is None \
        else blocked_rows(fn, chunk, row_mask)


def mesh_chunked_value_and_grad(fn: Callable, chunk: Optional[int],
                                row_mask: Optional[Sequence[bool]],
                                mesh) -> Callable:
    """(w, *local rows) -> (global sum loss, global sum grad): the rank's
    chunk loop, then one psum of the gradient with the loss appended."""
    from ..parallel.collectives import psum

    vg = _local_value_and_grad(fn, chunk, row_mask)

    def run(w, *batch):
        loss, grad = vg(w, *batch)
        both = psum(torch.cat([grad.reshape(-1), loss.reshape(1)]), mesh)
        return both[-1], both[:-1].reshape(grad.shape)

    return run


def mesh_chunked_sum(fn: Callable, chunk: Optional[int],
                     row_mask: Optional[Sequence[bool]], mesh) -> Callable:
    """(w, *local rows) -> the global sum loss (the rank's chunks, then a
    psum)."""
    from ..parallel.collectives import psum

    cs = _local_sum(fn, chunk, row_mask)

    def run(w, *batch):
        return psum(cs(w, *batch), mesh)

    return run


def mesh_blocked_rows(fn: Callable, chunk: Optional[int],
                      row_mask: Optional[Sequence[bool]], mesh) -> Callable:
    """Per-row outputs of the rank's own rows: they stay on the rank (the
    reference's out_specs P(axis)), no collective."""
    del mesh
    return _local_rows(fn, chunk, row_mask)


# the one place of the (unchunked | chunked) x (one device | mesh) choice,
# so every call site (L-BFGS, the trainers' evaluation, HOAG's test
# gradient) stays in step


def make_value_and_grad(fn, chunk=None, row_mask=None, mesh=None):
    if mesh is not None:
        return mesh_chunked_value_and_grad(fn, chunk, row_mask, mesh)
    return _local_value_and_grad(fn, chunk, row_mask)


def make_sum(fn, chunk=None, row_mask=None, mesh=None):
    if mesh is not None:
        return mesh_chunked_sum(fn, chunk, row_mask, mesh)
    return _local_sum(fn, chunk, row_mask)


def make_rows(fn, chunk=None, row_mask=None, mesh=None):
    if mesh is not None:
        return mesh_blocked_rows(fn, chunk, row_mask, mesh)
    return _local_rows(fn, chunk, row_mask)


def pow2_floor(x: int) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


def suggest_chunk(n_rows: int, bytes_per_row: int,
                  budget_bytes: Optional[int] = None,
                  min_chunk: int = 4096, n_shards: int = 1) -> Optional[int]:
    """A power-of-two row chunk that keeps the score intermediates under
    `budget_bytes` (default YTK_CHUNK_BUDGET_MB), or None when the whole
    batch fits. Every decision is on a shard's rows (`n_rows` is the
    global count, each of `n_shards` ranks scans its own). YTK_ROW_CHUNK
    fixes the chunk; a shard of at most `min_chunk` rows never chunks."""
    local_rows = -(-n_rows // max(n_shards, 1))
    if budget_bytes is None:
        budget_bytes = knobs.get_int("YTK_CHUNK_BUDGET_MB") << 20
    env = knobs.get_int("YTK_ROW_CHUNK")
    if env is not None:
        return env if 0 < env < local_rows else None
    if local_rows <= min_chunk:
        return None
    if local_rows * bytes_per_row <= budget_bytes:
        return None
    chunk = max(min_chunk, pow2_floor(budget_bytes // max(bytes_per_row, 1)))
    return chunk if chunk < local_rows else None
