"""Blocked (row-chunked) loss, gradient and score evaluation
(``ytklearn_tpu/optimize/blocked.py``, its single-device half).

The reference never holds a whole partition's per-sample intermediates at
once: CoreData is blocked storage (dataflow/CoreData.java:51-52) and every
convex optimizer walks its blocks. Here the loss and its gradient are row
sums, so a loop over row chunks adds them up with peak memory O(chunk x
per-row cost); chunking changes only the f32 sum order. A chunk is never
padded: the last one is shorter. The mesh variants come with multi-GPU
training (ROADMAP.md 1.7).
"""

from __future__ import annotations

from typing import Callable, Optional

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


def _chunks(batch, chunk: int):
    n = batch[0].shape[0]
    for s in range(0, n, chunk):
        yield tuple(a[s:s + chunk] for a in batch)


def chunked_value_and_grad(fn: Callable, chunk: int) -> Callable:
    """(w, *batch) -> (sum loss, sum grad) over row chunks; `fn` returns a
    weighted sum (not a mean), so chunk sums compose."""
    vg = value_and_grad(fn)

    def run(w, *batch):
        loss = torch.zeros((), dtype=w.dtype, device=w.device)
        grad = torch.zeros_like(w)
        for ch in _chunks(batch, chunk):
            l, g = vg(w, *ch)
            loss = loss + l
            grad = grad + g
        return loss, grad

    return run


def chunked_sum(fn: Callable, chunk: int) -> Callable:
    """(w, *batch) -> sum loss over row chunks, no gradient."""

    def run(w, *batch):
        loss = torch.zeros((), dtype=w.dtype, device=w.device)
        with torch.no_grad():
            for ch in _chunks(batch, chunk):
                loss = loss + fn(w, *ch)
        return loss

    return run


def blocked_rows(fn: Callable, chunk: int) -> Callable:
    """Per-row outputs fn(w, *batch) -> (n, ...) over row chunks,
    concatenated."""

    def run(w, *batch):
        with torch.no_grad():
            return torch.cat([fn(w, *ch) for ch in _chunks(batch, chunk)])

    return run


def _no_grad(fn: Callable) -> Callable:
    def run(w, *batch):
        with torch.no_grad():
            return fn(w, *batch)

    return run


def make_value_and_grad(fn, chunk=None):
    return value_and_grad(fn) if chunk is None \
        else chunked_value_and_grad(fn, chunk)


def make_sum(fn, chunk=None):
    return _no_grad(fn) if chunk is None else chunked_sum(fn, chunk)


def make_rows(fn, chunk=None):
    return _no_grad(fn) if chunk is None else blocked_rows(fn, chunk)


def pow2_floor(x: int) -> int:
    return 1 << max(int(x).bit_length() - 1, 0)


def suggest_chunk(n_rows: int, bytes_per_row: int,
                  budget_bytes: Optional[int] = None,
                  min_chunk: int = 4096) -> Optional[int]:
    """A power-of-two row chunk that keeps the score intermediates under
    `budget_bytes` (default YTK_CHUNK_BUDGET_MB), or None when the whole
    batch fits. YTK_ROW_CHUNK fixes the chunk; a batch of at most
    `min_chunk` rows never chunks."""
    if budget_bytes is None:
        budget_bytes = knobs.get_int("YTK_CHUNK_BUDGET_MB") << 20
    env = knobs.get_int("YTK_ROW_CHUNK")
    if env is not None:
        return env if 0 < env < n_rows else None
    if n_rows <= min_chunk:
        return None
    if n_rows * bytes_per_row <= budget_bytes:
        return None
    chunk = max(min_chunk, pow2_floor(budget_bytes // max(bytes_per_row, 1)))
    return chunk if chunk < n_rows else None
