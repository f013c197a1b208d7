"""GBDT histograms: the wrappers of kernels K1-K4 and K8, their plain
versions, and the row compaction of the leaf-partitioned waves.

  hist_wave         (N, F, B, 3) f32 histograms of f32 or bf16-rounded
                    grads over all rows: kernel K1 (csrc/hist_float.cu),
                    replacing ytklearn_tpu/gbdt/hist.py::_hist_pallas (:51)
  hist_wave_q       (N, F, B, 3) int32 histograms of int8-quantized grads
                    over all rows: kernel K2 (csrc/hist.cu), replacing
                    ytklearn_tpu/gbdt/hist.py::_hist_pallas_q (:113)
  hist_wave_gather  the same over a compacted row list, gathering each
                    row's bins in the kernel: mode "int8" runs K4 (int32
                    sums, replacing _hist_gather_pallas_q :434), mode "mxu"
                    hist_wave_gather_mxu, kernel K3 (csrc/hist_float.cu, f32
                    sums, replacing _hist_gather_pallas :371)
  hist_q_u8         K2's sums in the (F, 3N, B) layout of the reference's
                    tuning variant, computed as an int8 one-hot matrix
                    product on the tensor cores: kernel K8 (csrc/hist_u8.cu),
                    replacing scripts/tune_hist_kernel.py::hist_q_u8 (:71)
  tile_plan,        K2/K4's launch shape (csrc/hist.cu) and an explicit one,
  check_plan        checked and completed (the tuning tools pass one; the
                    engine never does)
  float_plan,       the same for K1/K3 (csrc/hist_float.cu): a shared-memory
  check_float_plan  tile, one vector atomic a row and feature, or K1's
                    "auto", which picks one of the two on the device by the
                    wave's share of the rows
  compact_indices   order-preserving mask -> static (R,) index buffer
  pad_inputs        host transpose + row padding of a bin matrix

The plain versions (`*_plain`) compute the same sums with one `index_add_`
per feature on flattened (slot, feature, bin) keys: int64 values for the
exact int8 sums, f32 values for the float ones, with g and h rounded by
`.to(torch.bfloat16).float()` first in bf16 mode. The reference rounds
each row's g and h after the node mask and the gather (hist.py:74-76,
:408-409) and never the sums; so do the kernels and the plain versions.
Float sums depend on their order: the plain versions, the kernels (whose
atomics add in an order that changes from run to run) and the reference's
MXU agree to a tolerance, and counts exactly. The wrappers take the plain
versions only for tensors on the CPU; on a CUDA tensor they launch the
kernel or raise. `<wrapper>.launches` counts the kernel launches.

Node ids: a row belongs to every wave slot s with node_ids[s] == pos[row],
as the reference's one-hot P = (node_ids == pos) has it: a duplicated id
feeds each of its slots the same sums. Negative ids are pads and match
nothing, pos = -1 rows are dead. For K1-K4 every id must be < `max_nodes`
(the tree's node capacity, the kernel's lookup-table size), which every
caller passes; K8 compares ids with positions and takes no capacity. The
kernels K1-K4 keep the node lookup and one histogram tile in shared
memory: on CUDA, a tree of more nodes than fit there (about 57k at 256
bins) raises NotImplementedError (ROADMAP.md 1.8).
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..cuda_build import KernelLibrary

#: rows are padded to a multiple of this (the reference's Pallas sample
#: block; the int8 scale's qmax counts the padded rows)
BM_DEFAULT = 16384
#: gathered-row unit of the fused budget rungs (R is a multiple of it)
BMG_DEFAULT = 1024

_NOT_PORTED_TILE = (
    "K1-K4 keep the node lookup and one slot x feature histogram tile in "
    "shared memory; a lookup in global memory for larger trees is not "
    "ported yet (ROADMAP.md 1.8, K1-K4 for trees past shared memory)"
)
#: shared memory one block of K1-K4 may use: two blocks per SM
SMEM_PER_BLOCK = 112 * 1024
SMEM_MAX = 227 * 1024
#: an SM's shared memory, of which each resident block takes 1 KB besides
SMEM_PER_SM = 228 * 1024
THREADS = 512


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def node_slots(pos: torch.Tensor, node_ids: torch.Tensor,
               max_nodes: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot per row as int64, bool mask of rows in the wave): each row's
    lowest slot of its id, the lookup K1-K4 build in shared memory. Ids
    and positions at or past `max_nodes` match nothing; with max_nodes None
    (K8's rule) every id >= 0 may match."""
    N = node_ids.shape[0]
    dev = pos.device
    ids = node_ids.long()
    p = pos.long()
    if max_nodes is None:
        if N == 0:
            return torch.zeros_like(p), torch.zeros_like(p, dtype=torch.bool)
        # a stable sort keeps equal ids in slot order: the leftmost match
        # of a position is its id's lowest slot
        key = torch.where(ids >= 0, ids, torch.iinfo(torch.int64).max)
        skey, order = torch.sort(key, stable=True)
        j = torch.searchsorted(skey, p).clamp_(max=N - 1)
        return order[j], (p >= 0) & (skey[j] == p)
    in_range = (ids >= 0) & (ids < max_nodes)
    lut = torch.full((max_nodes + 1,), N, dtype=torch.long, device=dev)
    lut.scatter_reduce_(0, torch.where(in_range, ids, max_nodes),
                        torch.arange(N, device=dev), reduce="amin")
    lut[max_nodes] = N
    ok = (p >= 0) & (p < max_nodes)
    slot = lut[torch.where(ok, p, max_nodes)]
    return slot, ok & (slot < N)


def _first_slots(node_ids: torch.Tensor) -> torch.Tensor:
    """(N,) int64: the lowest slot holding each slot's id (the slot itself
    for an id seen first there). No host sync."""
    ids = node_ids.long()
    if ids.numel() == 0:
        return ids
    return (ids[:, None] == ids[None, :]).to(torch.int32).argmax(dim=1)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> nearest bf16 (ties to even) -> f32: jnp.astype(bfloat16)'s
    rounding, and the kernels' __float2bfloat16_rn."""
    return x.to(torch.bfloat16).float()


def _hist_plain(bin_of, pos, g, h, node_ids, F: int, B: int,
                max_nodes: Optional[int], mode: str) -> torch.Tensor:
    """Shared body: `bin_of(f, rows)` -> int64 bins of feature f. mode
    "q": g/h are f32 integers summed exactly (int32 out); "f32" / "bf16":
    f32 sums of g/h as given / rounded to bf16 (f32 out). Each row adds
    into its id's lowest slot; every later slot of the same id then takes
    a copy of that slot's sums."""
    N = node_ids.shape[0]
    slot, ok = node_slots(pos, node_ids, max_nodes)
    rows = torch.nonzero(ok).flatten()
    s = slot[rows]
    if mode == "q":
        dt = torch.long
        gv, hv = g[rows].to(torch.int32).long(), h[rows].to(torch.int32).long()
    else:
        dt = torch.float32
        gv, hv = g[rows].float(), h[rows].float()
        if mode == "bf16":
            gv, hv = round_bf16(gv), round_bf16(hv)
    vals = torch.stack([gv, hv, torch.ones_like(gv)], dim=1)
    flat = torch.zeros((N * F * B, 3), dtype=dt, device=pos.device)
    for f in range(F):
        b = bin_of(f, rows)
        keep = (b >= 0) & (b < B)
        key = (s * F + f) * B + b
        flat.index_add_(0, key[keep], vals[keep])
    out = flat.to(torch.int32) if mode == "q" else flat
    return out.view(N, F, B, 3)[_first_slots(node_ids)]


def _val_mode(use_bf16: bool) -> str:
    return "bf16" if use_bf16 else "f32"


def hist_wave_plain(bins_t, pos, g, h, node_ids, B: int, max_nodes: int,
                    use_bf16: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of K1: bins_t (F, n) u8|i32, pos (n,) i32, g/h
    (n,) f32 -> (N, F, B, 3) f32 (g/h rounded to bf16 when use_bf16)."""
    return _hist_plain(lambda f, rows: bins_t[f, rows].long(), pos, g, h,
                       node_ids, bins_t.shape[0], B, max_nodes,
                       _val_mode(use_bf16))


def hist_gather_plain(rows, idx, pos_g, g, h, node_ids, B: int,
                      max_nodes: int, use_bf16: bool = True) -> torch.Tensor:
    """Plain PyTorch twin of K3: hist_gather_q_plain's inputs with raw f32
    g/h -> (N, F, B, 3) f32 (g/h rounded to bf16 when use_bf16)."""
    return _hist_plain(lambda f, r: rows[idx[r].long(), f].long(), pos_g, g,
                       h, node_ids, rows.shape[1], B, max_nodes,
                       _val_mode(use_bf16))


def hist_wave_q_plain(bins_t, pos, gq, hq, node_ids, B: int,
                      max_nodes: int) -> torch.Tensor:
    """Plain PyTorch twin of K2: bins_t (F, n) u8|i32, pos (n,) i32,
    gq/hq (n,) f32 integers -> (N, F, B, 3) int32."""
    return _hist_plain(lambda f, rows: bins_t[f, rows].long(), pos, gq, hq,
                       node_ids, bins_t.shape[0], B, max_nodes, "q")


def hist_gather_q_plain(rows, idx, pos_g, gq, hq, node_ids, B: int,
                        max_nodes: int) -> torch.Tensor:
    """Plain PyTorch twin of K4: rows (n_rows, F) u8|i32 row-major, idx
    (R,) i32 row ids, pos_g/gq/hq (R,) per gathered row (pos_g = -1 is a
    dead slot) -> (N, F, B, 3) int32."""
    return _hist_plain(lambda f, r: rows[idx[r].long(), f].long(), pos_g,
                       gq, hq, node_ids, rows.shape[1], B, max_nodes, "q")


def hist_q_u8_plain(bins_t, pos, gq, hq, node_ids, B: int) -> torch.Tensor:
    """Plain PyTorch twin of K8: bins_t (F, n) u8, pos (n,) i32, gq/hq (n,)
    f32 integers -> (F, 3N, B) int32 with rows [g*N | h*N | c*N], the
    reference's layout; any id >= 0 matches (no node capacity)."""
    F, N = bins_t.shape[0], node_ids.shape[0]
    out = _hist_plain(lambda f, rows: bins_t[f, rows].long(), pos, gq, hq,
                      node_ids, F, B, None, "q")
    return out.permute(1, 3, 0, 2).reshape(F, 3 * N, B)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _lut_bytes(max_nodes: int, N: int) -> int:
    """Shared bytes of K1-K4's node lookup; after the row pass the same
    space holds each slot's next duplicate (N entries)."""
    return _pad_to(max(max_nodes, N), 4) * 4


def tile_bytes(N: int, ng: int, fg: int, B: int, max_nodes: int) -> int:
    """Shared bytes of a K1-K4 block: the node lookup and a tile of `ng`
    slots x `fg` features x B bins of three 4-byte counters."""
    return _lut_bytes(max_nodes, N) + ng * fg * B * 3 * 4


def check_tile_fits(B: int, max_nodes: int, N: int = 0) -> None:
    """Raise NotImplementedError when the lookup over `max_nodes` tree
    node ids and one slot x one feature of B bins do not fit one block's
    shared memory (at B = 256: more than 57,344 nodes)."""
    need = tile_bytes(N, 1, 1, B, max_nodes)
    if need > SMEM_MAX:
        raise NotImplementedError(
            f"a histogram tile of B={B} bins with a {max_nodes}-node lookup "
            f"needs {need} bytes of shared memory, more than {SMEM_MAX}: "
            + _NOT_PORTED_TILE
        )


def tile_plan(N: int, F: int, B: int, max_nodes: int, n: int, sm_count: int
              ) -> dict:
    """Launch shape of K1-K4. A block owns `ng` slots x `fg` features of
    the histogram in shared memory and scans one chunk of rows. Slots come
    first: a tile holding every slot of the wave uses every row it reads,
    where a tile of one slot in 64 would skip 63 rows in 64. A tile that
    fits half an SM's shared memory runs two blocks of 512 threads per SM;
    a larger one (64 slots of 256 bins: 196 KB) one block of 1024."""
    check_tile_fits(B, max_nodes, N)
    lut_bytes = _lut_bytes(max_nodes, N)
    pair = B * 3 * 4
    most = (SMEM_MAX - lut_bytes) // pair
    pairs = (SMEM_PER_BLOCK - lut_bytes) // pair
    if pairs >= 1 and pairs >= min(N, most):
        threads, per_sm = THREADS, 2
    else:
        pairs, threads, per_sm = most, 2 * THREADS, 1
    ng = min(N, pairs)
    fg = min(F, max(1, pairs // ng))
    n_ftiles = -(-F // fg)
    n_tiles = n_ftiles * -(-N // ng)
    # about two waves of resident blocks; a chunk at least as long as two
    # rows per counter of a slot's feature, so the flush stays small
    target = 2 * per_sm * sm_count
    min_rows = max(2048, 2 * ng * B)
    n_chunks = max(1, min(-(-target // n_tiles), -(-n // min_rows), 65535))
    rows_per_chunk = max(1, -(-n // n_chunks))
    n_chunks = max(1, -(-n // rows_per_chunk))
    return {
        "fg": fg, "ng": ng, "n_ftiles": n_ftiles, "n_tiles": n_tiles,
        "n_chunks": n_chunks, "rows_per_chunk": rows_per_chunk,
        "smem": tile_bytes(N, ng, fg, B, max_nodes), "threads": threads,
    }


_PLAN_KEYS = ("fg", "ng", "threads", "rows_per_chunk", "n_chunks",
              "n_ftiles", "n_tiles", "smem")


def check_plan(plan: dict, N: int, F: int, B: int, max_nodes: int, n: int
               ) -> dict:
    """An explicit launch shape of K1-K4, checked before any launch and
    completed: `plan` names `fg` and `ng` (features and slots of a block's
    tile), `threads`, and `rows_per_chunk` or `n_chunks`. The fields that
    tile_plan derives (n_ftiles, n_tiles, smem and the other of the two
    chunk fields) may be given too, and must then be the ones the tile
    implies, so tile_plan's output passes. Raises ValueError when the plan
    does not cover the (N, F, B) histogram over n rows, or its tile needs
    more shared memory than SMEM_MAX, or its threads do not make a block;
    NotImplementedError as tile_plan when no tile fits at all."""
    check_tile_fits(B, max_nodes, N)
    unknown = sorted(set(plan) - set(_PLAN_KEYS))
    if unknown:
        raise ValueError(f"plan: unknown fields {unknown}; a plan names "
                         f"{', '.join(_PLAN_KEYS)}")
    fg, ng = int(plan.get("fg", 0)), int(plan.get("ng", 0))
    threads = int(plan.get("threads", THREADS))
    if fg < 1 or ng < 1:
        raise ValueError(f"plan: fg ({fg}) and ng ({ng}) must be >= 1")
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"plan: threads ({threads}) must be a multiple of "
                         "32 in [32, 1024]")
    rpc, chunks = plan.get("rows_per_chunk"), plan.get("n_chunks")
    if rpc is None and chunks is None:
        raise ValueError("plan: give rows_per_chunk or n_chunks")
    if rpc is None:
        rpc = max(1, -(-n // max(1, int(chunks))))
    rpc = int(rpc)
    if rpc < 1:
        raise ValueError(f"plan: rows_per_chunk ({rpc}) must be >= 1")
    chunks = max(1, -(-n // rpc)) if chunks is None else int(chunks)
    if chunks * rpc < n:
        raise ValueError(f"plan does not cover the rows: {chunks} chunks of "
                         f"{rpc} rows < n = {n}")
    if not 1 <= chunks <= 65535:
        raise ValueError(f"plan: {chunks} chunks, not in [1, 65535]")
    n_ftiles = -(-F // fg)
    n_tiles = n_ftiles * -(-N // ng)
    for name, want in (("n_ftiles", n_ftiles), ("n_tiles", n_tiles)):
        if name in plan and int(plan[name]) != want:
            raise ValueError(
                f"plan does not cover the histogram: {name} = {plan[name]}, "
                f"but fg = {fg}, ng = {ng} over (N, F) = ({N}, {F}) make "
                f"{want}")
    smem = tile_bytes(N, ng, fg, B, max_nodes)
    if smem > SMEM_MAX:
        raise ValueError(
            f"plan's tile of {ng} slots x {fg} features x {B} bins needs "
            f"{smem} bytes of shared memory, more than {SMEM_MAX}")
    if int(plan.get("smem", smem)) < smem:
        raise ValueError(f"plan: smem {plan['smem']} < the {smem} bytes "
                         "its tile needs")
    return {"fg": fg, "ng": ng, "n_ftiles": n_ftiles, "n_tiles": n_tiles,
            "n_chunks": chunks, "rows_per_chunk": rpc, "smem": smem,
            "threads": threads}


# ---------------------------------------------------------------------------
# K1/K3 launch shapes
# ---------------------------------------------------------------------------

#: K1/K3's kinds of launch (csrc/hist_float.cu): "tile", a block's ng slots
#: x fg features in shared memory (K1 only); "red", one 16-byte vector
#: atomic a row and feature into an L2-resident scratch, every row read
#: once; "auto" (K1 only), a tile plan whose launch counts the wave's rows
#: on the device and runs the tile or, when the wave holds few rows, red
FLOAT_KINDS = ("tile", "red", "auto")
#: the auto kind runs red when the wave's rows x F x RED_WEIGHT < n x the
#: tiles: a tile pass over n rows costs about what RED_WEIGHT vector
#: atomics a row and feature do (fitted on the card, PERF.md section 6)
RED_WEIGHT = 1.7
#: K1's tile plan: chunks of about TILE_ROWS rows (at least a wave of
#: resident blocks), rounded to whole waves
TILE_ROWS = 131072
#: the red kind: one wave of resident blocks, at least RED_MIN_ROWS rows a
#: block
RED_MIN_ROWS = 512
_FLOAT_PLAN_KEYS = ("kind",) + _PLAN_KEYS


def _float_tile(N: int, F: int, B: int, max_nodes: int) -> Tuple[int, int]:
    """(ng, fg) of K1's tile beside the lookup in SMEM_MAX: as many of the
    wave's slots as fit with one feature (a slot tile skips the rows of
    the other slots; measured dearer than a feature tile), then as many
    features as fit, the tiles evenly filled."""
    budget = SMEM_MAX - _lut_bytes(max_nodes, N)
    pair = B * 3 * 4
    st = -(-N // max(1, budget // pair))
    ng = -(-N // st)
    ft = -(-F // max(1, min(F, budget // (ng * pair))))
    return ng, -(-F // ft)


def _red_shape(N: int, max_nodes: int, n: int, sm_count: int
               ) -> Tuple[int, int, int, int]:
    """(chunks, rows a chunk, threads, shared bytes) of a red launch: one
    wave of resident blocks of THREADS threads, the lookup their only
    shared memory."""
    smem = _lut_bytes(max_nodes, N)
    per_sm = max(1, min(2048 // THREADS, SMEM_PER_SM // (smem + 1024)))
    chunks = max(1, min(per_sm * sm_count, -(-n // RED_MIN_ROWS), 65535))
    rpc = _pad_to(max(1, -(-n // chunks)), 4)
    return max(1, -(-n // rpc)), rpc, THREADS, smem


@lru_cache(maxsize=512)
def _float_plan(N: int, F: int, B: int, max_nodes: int, n: int,
                sm_count: int, gather: bool) -> Tuple[Tuple[str, object], ...]:
    check_tile_fits(B, max_nodes, N)
    ng, fg = _float_tile(N, F, B, max_nodes)
    n_ftiles = -(-F // fg)
    n_tiles = n_ftiles * -(-N // ng)
    if gather or n_tiles >= F * RED_WEIGHT:  # red at any share of rows
        chunks, rpc, threads, smem = _red_shape(N, max_nodes, n, sm_count)
        return tuple({
            "kind": "red", "fg": F, "ng": N, "n_ftiles": 1, "n_tiles": 1,
            "n_chunks": chunks, "rows_per_chunk": rpc, "smem": smem,
            "threads": threads}.items())
    smem = tile_bytes(N, ng, fg, B, max_nodes)
    threads, per_sm = ((THREADS, 2) if smem <= SMEM_PER_BLOCK
                       else (2 * THREADS, 1))
    resident = per_sm * sm_count
    chunks = max(1, min(max(-(-n // TILE_ROWS), -(-resident // n_tiles)),
                        -(-n // RED_MIN_ROWS), 65535))
    if chunks * n_tiles > resident:  # whole waves of blocks
        chunks = max(1, chunks * n_tiles // resident * resident // n_tiles)
    rpc = _pad_to(max(1, -(-n // chunks)), 4)
    return tuple({
        "kind": "tile" if n_tiles == 1 else "auto", "fg": fg, "ng": ng,
        "n_ftiles": n_ftiles, "n_tiles": n_tiles,
        "n_chunks": max(1, -(-n // rpc)), "rows_per_chunk": rpc,
        "smem": smem, "threads": threads}.items())


def float_plan(N: int, F: int, B: int, max_nodes: int, n: int,
               sm_count: int, gather: bool = False) -> dict:
    """Launch shape of K1 (gather False: n rows scanned) or K3 (gather
    True: n = R gathered rows). A K1 tile: a block owns `ng` slots x `fg`
    features of the histogram in shared memory over a chunk of
    `rows_per_chunk` rows (about TILE_ROWS, whole waves of blocks); the
    tile holds the whole wave where it can. "tile" when one tile holds the
    whole histogram (every row read once); "auto" when it takes more: the
    launch picks tile or red on the device by the wave's rows; "red" when
    the tiles are so many that red wins whatever the wave holds, and for
    every K3 launch: no tile, one vector atomic a row and feature, one wave
    of blocks. Raises NotImplementedError as check_tile_fits."""
    return dict(_float_plan(N, F, B, max_nodes, n, sm_count, bool(gather)))


def check_float_plan(plan: dict, N: int, F: int, B: int, max_nodes: int,
                     n: int, gather: bool = False) -> dict:
    """An explicit launch shape of K1 (gather False) or K3 (gather True),
    checked before any launch and completed: `kind` ("tile", the default
    for K1, "auto", or "red", K3's only kind), `threads`, and
    `rows_per_chunk` or `n_chunks`; a tile or auto plan names `fg` and
    `ng` (check_plan checks it; auto's red launch takes float_plan's red
    shape). Derived fields (n_ftiles, n_tiles, smem, the other chunk
    field) may be given and must then be the ones the plan implies, so
    float_plan's output passes; a red plan adds every slot and feature, so
    its fg and ng, if given, are F and N and its tile counts 1. Raises
    ValueError when the plan does not cover the (N, F, B) histogram over n
    rows, or needs more shared memory than SMEM_MAX, or its threads do not
    make a block; NotImplementedError as check_tile_fits past the lookup's
    cap."""
    check_tile_fits(B, max_nodes, N)
    unknown = sorted(set(plan) - set(_FLOAT_PLAN_KEYS))
    if unknown:
        raise ValueError(f"plan: unknown fields {unknown}; a plan names "
                         f"{', '.join(_FLOAT_PLAN_KEYS)}")
    kind = plan.get("kind", "red" if gather else "tile")
    kinds = ("red",) if gather else FLOAT_KINDS
    if kind not in kinds:
        raise ValueError(f"plan: kind must be one of {kinds}, got {kind!r}")
    rest = {k: v for k, v in plan.items() if k != "kind"}
    if kind != "red":
        return dict(check_plan(rest, N, F, B, max_nodes, n), kind=kind)
    for name, want in (("fg", F), ("ng", N), ("n_ftiles", 1),
                       ("n_tiles", 1)):
        if name in rest and int(rest[name]) != want:
            raise ValueError(f"plan does not cover the histogram: a red "
                             f"plan adds every slot and feature, so {name} "
                             f"is {want}, not {rest[name]}")
    threads = int(rest.get("threads", THREADS))
    if threads % 32 or not 32 <= threads <= 1024:
        raise ValueError(f"plan: threads ({threads}) must be a multiple of "
                         "32 in [32, 1024]")
    rpc, chunks = rest.get("rows_per_chunk"), rest.get("n_chunks")
    if rpc is None and chunks is None:
        raise ValueError("plan: give rows_per_chunk or n_chunks")
    rpc = max(1, -(-n // max(1, int(chunks)))) if rpc is None else int(rpc)
    if rpc < 1:
        raise ValueError(f"plan: rows_per_chunk ({rpc}) must be >= 1")
    chunks = max(1, -(-n // rpc)) if chunks is None else int(chunks)
    if chunks * rpc < n:
        raise ValueError(f"plan does not cover the rows: {chunks} chunks of "
                         f"{rpc} rows < n = {n}")
    if not 1 <= chunks <= 65535:
        raise ValueError(f"plan: {chunks} chunks, not in [1, 65535]")
    smem = _lut_bytes(max_nodes, N)
    if int(rest.get("smem", smem)) < smem:
        raise ValueError(f"plan: smem {rest['smem']} < the {smem} bytes of "
                         "its node lookup")
    return {"kind": "red", "fg": F, "ng": N, "n_ftiles": 1, "n_tiles": 1,
            "n_chunks": chunks, "rows_per_chunk": rpc, "smem": smem,
            "threads": threads}


def _bind(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    tail = [ci, ci, ci, ci, ci, ci, ci, ci, ci, ll, ci, ci, vp, vp]
    lib.ytk_hist_q.restype = ctypes.c_int
    lib.ytk_hist_q.argtypes = [ci, ci, vp, ll, vp, vp, vp, vp, ll, vp] + tail


def _bind_float(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.ytk_hist_float.restype = ctypes.c_int
    lib.ytk_hist_float.argtypes = (
        [ci] * 6 + [vp, ll, vp, vp, vp, vp, ll, vp] + [ci] * 9
        + [ll, ci, ci, ci, ll, ci, ci, ll, vp, vp, vp])


_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LIBRARY = KernelLibrary(os.path.join(_CSRC, "hist.cu"), _bind)
#: compile csrc/hist.cu (K2, K4) now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_FLOAT_LIBRARY = KernelLibrary(os.path.join(_CSRC, "hist_float.cu"),
                               _bind_float)
#: compile csrc/hist_float.cu (K1, K3) now: {cmd, seconds, log}; raises on
#: failure
build_float_kernel = _FLOAT_LIBRARY.build
_count_lock = threading.Lock()


@lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, t, dtypes, shape, dev):
    if t.device != dev or t.dtype not in dtypes or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous {'|'.join(map(str, dtypes))} "
            f"{shape} tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device}"
        )


def _check_inputs(gather: bool, grad: str, bins, idx, pos, g, h, node_ids
                  ) -> None:
    dev, n, N = pos.device, pos.shape[0], node_ids.shape[0]
    for name, t, dtypes, shape in (
        ("pos", pos, (torch.int32,), (n,)),
        (grad, g, (torch.float32,), (n,)),
        ("h" if grad == "g" else "hq", h, (torch.float32,), (n,)),
        ("node_ids", node_ids, (torch.int32,), (N,)),
        ("bins", bins, (torch.uint8, torch.int32), tuple(bins.shape)),
    ):
        _check(name, t, dtypes, shape, dev)
    if gather:
        _check("idx", idx, (torch.int32,), (n,), dev)


def _launch(gather: bool, bins, n_bins_rows: int, idx, pos, gq, hq,
            node_ids, B: int, max_nodes: int,
            plan: Optional[dict] = None) -> torch.Tensor:
    """One launch of K2 (full scan) or K4 (gather): int32 sums; `plan` a
    launch shape from check_plan, else tile_plan's."""
    dev = pos.device
    n = pos.shape[0]
    F = bins.shape[0] if not gather else bins.shape[1]
    N = node_ids.shape[0]
    _check_inputs(gather, "gq", bins, idx, pos, gq, hq, node_ids)
    out = torch.zeros((N, F, B, 3), dtype=torch.int32, device=dev)
    if n == 0 or N == 0 or F == 0:
        return out
    if plan is None:
        plan = tile_plan(N, F, B, max_nodes, n, _sm_count(dev.index))
    lib = _LIBRARY.load()
    args = [
        bins.element_size(), int(gather), bins.data_ptr(), n_bins_rows,
        idx.data_ptr() if gather else None, pos.data_ptr(), gq.data_ptr(),
        hq.data_ptr(), n, node_ids.data_ptr(), N, max_nodes, F, B,
        plan["fg"], plan["ng"], plan["n_ftiles"], plan["n_tiles"],
        plan["n_chunks"], plan["rows_per_chunk"], plan["threads"],
        plan["smem"], out.data_ptr(),
    ]
    with torch.cuda.device(dev):
        rc = lib.ytk_hist_q(*args, torch.cuda.current_stream().cuda_stream)
    _LIBRARY.check(rc, "hist_gather_q" if gather else "hist_q")
    return out


def _aligned(t: torch.Tensor, m: int) -> bool:
    return t.data_ptr() % m == 0


def _launch_float(wrapper, gather: bool, bins, n_bins_rows: int, idx, pos,
                  g, h, node_ids, B: int, max_nodes: int, use_bf16: bool,
                  plan: Optional[dict] = None) -> torch.Tensor:
    """One launch of K1 (full scan) or K3 (gather), counted on `wrapper`:
    f32 sums of g/h (rounded to bf16 first when use_bf16); `plan` from
    check_float_plan, else float_plan's. Rows go four at a time when
    pos/g/h (and idx) are 16-byte aligned and the chunks are multiples of
    four rows, and, for the full scan, every feature's row of bins starts
    on a four-row boundary; otherwise one at a time."""
    dev = pos.device
    n = pos.shape[0]
    F = bins.shape[1] if gather else bins.shape[0]
    N = node_ids.shape[0]
    _check_inputs(gather, "g", bins, idx, pos, g, h, node_ids)
    if n == 0 or N == 0 or F == 0:
        return torch.zeros((N, F, B, 3), dtype=torch.float32, device=dev)
    if plan is None:
        plan = float_plan(N, F, B, max_nodes, n, _sm_count(dev.index),
                          gather)
    eb = bins.element_size()
    vec = plan["rows_per_chunk"] % 4 == 0 and all(
        _aligned(t, 16) for t in ((pos, g, h, idx) if gather
                                  else (pos, g, h)))
    if not gather:
        vec = vec and n % 4 == 0 and _aligned(bins, 4 * eb)
    words = gather and eb == 1 and F % 4 == 0 and _aligned(bins, 4)
    kind = plan["kind"]
    # the kernels' scratch, zeroed by the launcher: (g, h, count, unused) a
    # bin, 16-byte aligned, then the auto kind's count of the wave's rows
    scratch = torch.empty(N * F * B * 4 + 4, dtype=torch.float32, device=dev)
    out = torch.empty((N, F, B, 3), dtype=torch.float32, device=dev)
    red_shape = _red_shape(N, max_nodes, n, _sm_count(dev.index))
    # auto: red below this many rows of the wave (see RED_WEIGHT)
    red_rows = int(n * plan["n_tiles"] // (F * RED_WEIGHT))
    lib = _FLOAT_LIBRARY.load()
    args = [
        FLOAT_KINDS.index(kind), eb, int(gather), int(vec), int(use_bf16),
        int(words), bins.data_ptr(), n_bins_rows,
        idx.data_ptr() if gather else None, pos.data_ptr(), g.data_ptr(),
        h.data_ptr(), n, node_ids.data_ptr(), N, max_nodes, F, B,
        plan["fg"], plan["ng"], plan["n_ftiles"], plan["n_tiles"],
        plan["n_chunks"], plan["rows_per_chunk"], plan["threads"],
        plan["smem"], *red_shape, red_rows, out.data_ptr(),
        scratch.data_ptr(),
    ]
    if dev.index == torch.cuda.current_device():
        rc = lib.ytk_hist_float(*args,
                                torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(dev):
            rc = lib.ytk_hist_float(*args,
                                    torch.cuda.current_stream().cuda_stream)
    _FLOAT_LIBRARY.check(rc, "hist_gather" if gather else "hist")
    _count(wrapper)
    return out


def _check_lengths(what: str, n_rows: int, B: int, max_nodes: int,
                   **per_row) -> None:
    """Every per-row array holds `n_rows` entries; B and max_nodes >= 1."""
    for name, t in per_row.items():
        if t.shape != (n_rows,):
            raise ValueError(f"{what}: {name} must have shape ({n_rows},), "
                             f"got {tuple(t.shape)}")
    if B < 1 or max_nodes < 1:
        raise ValueError(f"{what}: B ({B}) and max_nodes ({max_nodes}) "
                         "must be >= 1")


def _check_gather(what, rows, idx, pos_g, g, h, B, max_nodes) -> None:
    if rows.dim() != 2:
        raise ValueError(f"{what}: rows must be (n_rows, F), got "
                         f"{tuple(rows.shape)}")
    _check_lengths(what, idx.shape[0], B, max_nodes, pos_g=pos_g, g=g, h=h)


def _count(wrapper) -> None:
    with _count_lock:
        wrapper.launches += 1


def _plan_of(plan, node_ids, F: int, B: int, max_nodes: int, n: int,
             check=check_plan, **kw):
    """An explicit plan checked before any launch (on the CPU too), or
    None for the planner's."""
    return None if plan is None else check(
        plan, node_ids.shape[0], F, B, max_nodes, n, **kw)


def hist_wave(bins_t, pos, g, h, node_ids, B: int, *, max_nodes: int,
              use_bf16: bool = True, plan: Optional[dict] = None
              ) -> torch.Tensor:
    """(N, F, B, 3) f32 histograms for the nodes listed in `node_ids`.

    bins_t   (F, n) u8|i32 — transposed bin matrix
    pos      (n,) i32      — tree-node id per row (-1 = skip)
    g, h     (n,) f32      — weighted grad / hess, rounded to bf16 per row
                             when use_bf16 (the sums stay f32)
    node_ids (N,) i32      — node ids to histogram (-2 pads)
    max_nodes              — the tree's node capacity: every id < it
    plan                   — a launch shape for check_float_plan (tuning
                             tools)
    On the CPU: the plain version; on CUDA: kernel K1."""
    if bins_t.dim() != 2:
        raise ValueError(f"hist_wave: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    _check_lengths("hist_wave", bins_t.shape[1], B, max_nodes, pos=pos, g=g,
                   h=h)
    plan = _plan_of(plan, node_ids, bins_t.shape[0], B, max_nodes,
                    bins_t.shape[1], check_float_plan)
    if pos.device.type == "cpu":
        return hist_wave_plain(bins_t, pos, g, h, node_ids, B, max_nodes,
                               use_bf16)
    return _launch_float(hist_wave, False, bins_t, bins_t.shape[1], None,
                         pos, g, h, node_ids, B, max_nodes, use_bf16, plan)


hist_wave.launches = 0


def hist_wave_q(bins_t, pos, gq, hq, node_ids, B: int, *, max_nodes: int,
                plan: Optional[dict] = None) -> torch.Tensor:
    """(N, F, B, 3) int32 histograms from int8-quantized grads.

    bins_t   (F, n) u8|i32 — transposed bin matrix
    pos      (n,) i32      — tree-node id per row (-1 = skip)
    gq, hq   (n,) f32      — quantized grad / hess, integers in [-127, 127]
    node_ids (N,) i32      — node ids to histogram (-2 pads)
    max_nodes              — the tree's node capacity: every id < it
    plan                   — a launch shape for check_plan (tuning tools)
    On the CPU: the plain version; on CUDA: kernel K2."""
    if bins_t.dim() != 2:
        raise ValueError(f"hist_wave_q: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    _check_lengths("hist_wave_q", bins_t.shape[1], B, max_nodes, pos=pos,
                   gq=gq, hq=hq)
    plan = _plan_of(plan, node_ids, bins_t.shape[0], B, max_nodes,
                    bins_t.shape[1])
    if pos.device.type == "cpu":
        return hist_wave_q_plain(bins_t, pos, gq, hq, node_ids, B, max_nodes)
    out = _launch(False, bins_t, bins_t.shape[1], None, pos, gq, hq,
                  node_ids, B, max_nodes, plan)
    _count(hist_wave_q)
    return out


hist_wave_q.launches = 0


def hist_wave_gather(rows, idx, pos_g, g, h, node_ids, B: int,
                     mode: str = "int8", *, max_nodes: int,
                     use_bf16: bool = True, plan: Optional[dict] = None
                     ) -> torch.Tensor:
    """(N, F, B, 3) partial histograms over a compacted row subset:
    rows (n_rows, F) u8|i32 row-major, idx (R,) i32 row ids, pos_g (R,)
    i32 node per gathered row (-1 = dead slot), g/h (R,) f32 per gathered
    row. mode "int8": g/h quantized, int32 sums (kernel K4 on CUDA); mode
    "mxu": hist_wave_gather_mxu (K3). `plan`: a launch shape for
    check_plan (int8) or check_float_plan (mxu). On the CPU: the plain
    versions."""
    if mode == "mxu":
        return hist_wave_gather_mxu(rows, idx, pos_g, g, h, node_ids, B,
                                    max_nodes=max_nodes, use_bf16=use_bf16,
                                    plan=plan)
    if mode != "int8":
        raise ValueError(f"hist_wave_gather: mode must be int8|mxu, got "
                         f"{mode!r}")
    _check_gather("hist_wave_gather", rows, idx, pos_g, g, h, B, max_nodes)
    plan = _plan_of(plan, node_ids, rows.shape[1], B, max_nodes,
                    idx.shape[0])
    if pos_g.device.type == "cpu":
        return hist_gather_q_plain(rows, idx, pos_g, g, h, node_ids, B,
                                   max_nodes)
    out = _launch(True, rows, rows.shape[0], idx, pos_g, g, h, node_ids, B,
                  max_nodes, plan)
    _count(hist_wave_gather)
    return out


hist_wave_gather.launches = 0


def hist_wave_gather_mxu(rows, idx, pos_g, g, h, node_ids, B: int, *,
                         max_nodes: int, use_bf16: bool = True,
                         plan: Optional[dict] = None) -> torch.Tensor:
    """(N, F, B, 3) f32 partial histograms over a compacted row subset
    (hist_wave_gather's inputs) with raw f32 g/h, rounded to bf16 per row
    when use_bf16; `plan` a launch shape for check_float_plan. On the CPU:
    the plain version; on CUDA: kernel K3."""
    _check_gather("hist_wave_gather_mxu", rows, idx, pos_g, g, h, B,
                  max_nodes)
    plan = _plan_of(plan, node_ids, rows.shape[1], B, max_nodes,
                    idx.shape[0], check_float_plan, gather=True)
    if pos_g.device.type == "cpu":
        return hist_gather_plain(rows, idx, pos_g, g, h, node_ids, B,
                                 max_nodes, use_bf16)
    return _launch_float(hist_wave_gather_mxu, True, rows, rows.shape[0],
                         idx, pos_g, g, h, node_ids, B, max_nodes, use_bf16,
                         plan)


hist_wave_gather_mxu.launches = 0


# ---------------------------------------------------------------------------
# K8: the histogram as an int8 one-hot matrix product
# ---------------------------------------------------------------------------

#: K8's launch shape: a block stages U8_KT rows at a time (four 32-row
#: steps of the m16n8k32 product), runs at most U8_WARPS warps, and each
#: warp holds U8_TILES 16 x 8 int32 accumulator tiles in registers
U8_KT = 128
U8_WARPS = 16
U8_TILES = 16
#: rows at least in a block's chunk when the plan picks the chunk length
U8_MIN_ROWS = 8192


def _u8_warp_shape(MT: int) -> Tuple[int, int]:
    """(m-tiles, n-tiles) of one warp's accumulator, the kernel's template
    instances: a short PV column whole, else eight of its m-tiles."""
    mtw = 1 if MT == 1 else 2 if MT == 2 else 4 if MT <= 4 else 8
    return mtw, U8_TILES // mtw


def u8_plan(N: int, F: int, B: int, n: int, sm_count: int,
            fg: Optional[int] = None,
            rows_per_block: Optional[int] = None) -> dict:
    """Launch shape of K8. The (3N, B) product of one feature is MT x NT
    tiles of 16 x 8 (MT = ceil(3N/16), NT = ceil(B/8)); a warp's task is
    `mtw` x `ntw` of them, a feature has `tpf` tasks. A block runs `fg`
    features x `tps` tasks (one warp each) over `rows_per_block` rows; a
    feature's tasks that do not fit one block go to `n_slices` blocks.
    fg None: as many whole features as fill U8_WARPS warps; rows_per_block
    None: about four blocks per SM, each at least U8_MIN_ROWS rows. Raises
    ValueError for an fg outside [1, U8_WARPS], a staging tile past
    SMEM_MAX, or more than 65535 row chunks."""
    MT, NT = max(1, -(-3 * N // 16)), -(-B // 8)
    mtw, ntw = _u8_warp_shape(MT)
    tpf = -(-MT // mtw) * -(-NT // ntw)
    if fg is None:
        fg = max(1, min(F, U8_WARPS // tpf))
    fg = int(fg)
    if not 1 <= fg <= U8_WARPS:
        raise ValueError(f"hist_q_u8: fg ({fg}) must be in [1, {U8_WARPS}]: "
                         f"a block runs a warp per feature at least and "
                         f"{U8_WARPS} warps at most")
    tps = min(tpf, max(1, U8_WARPS // fg))
    n_slices = -(-tpf // tps)
    n_fgroups = -(-F // fg)
    smem = 4 * MT * 32 * 16 + U8_KT * 6 + _pad_to(4 * N, 16) + fg * U8_KT
    if smem > SMEM_MAX:
        raise ValueError(f"hist_q_u8: the PV fragments of {N} slots and the "
                         f"bins of {fg} features need {smem} bytes of shared "
                         f"memory, more than {SMEM_MAX}")
    nx = n_fgroups * n_slices
    if rows_per_block is None:
        n_chunks = max(1, min(-(-4 * sm_count // nx),
                              -(-n // U8_MIN_ROWS), 65535))
        rows_per_block = _pad_to(max(1, -(-n // n_chunks)), U8_KT)
    rows_per_block = int(rows_per_block)
    if rows_per_block < 1:
        raise ValueError(f"hist_q_u8: rows_per_block ({rows_per_block}) "
                         "must be >= 1")
    n_chunks = max(1, -(-n // rows_per_block))
    if n_chunks > 65535:
        raise ValueError(f"hist_q_u8: {n_chunks} row chunks of "
                         f"{rows_per_block} rows, more than 65535")
    return {"fg": fg, "tps": tps, "mtw": mtw, "ntw": ntw, "tpf": tpf,
            "n_slices": n_slices, "n_fgroups": n_fgroups,
            "threads": 32 * fg * tps, "smem": smem,
            "rows_per_block": rows_per_block, "n_chunks": n_chunks,
            "grid": (nx, n_chunks)}


def _bind_u8(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.ytk_hist_q_u8.restype = ctypes.c_int
    lib.ytk_hist_q_u8.argtypes = [vp, ll, vp, vp, vp, vp] + [ci] * 11 + [
        ll, vp, vp]


_U8_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "hist_u8.cu"),
    _bind_u8,
)
#: compile csrc/hist_u8.cu now: {cmd, seconds, log}; raises on failure
build_u8_kernel = _U8_LIBRARY.build


def hist_q_u8(bins_t, pos, gq, hq, node_ids, B: int, *,
              fg: Optional[int] = None,
              rows_per_block: Optional[int] = None) -> torch.Tensor:
    """(F, 3N, B) int32 histograms with rows [g*N | h*N | c*N], the layout
    of the reference's scripts/tune_hist_kernel.py::hist_q_u8; the same sums
    as hist_wave_q, whose (N, F, B, 3) output is this one permuted.

    bins_t   (F, n) u8 — transposed bin matrix (B <= 256: the reference
                         compares bins with a uint8 iota, which wraps past
                         255)
    pos      (n,) i32  — tree-node id per row (-1 = skip)
    gq, hq   (n,) f32  — quantized grad / hess, integers in [-127, 127]
    node_ids (N,) i32  — node ids to histogram (negative = pad)
    fg, rows_per_block — K8's launch shape (u8_plan; None: its default),
                         checked on the CPU too
    On the CPU: the plain version; on CUDA: kernel K8."""
    if bins_t.dim() != 2 or bins_t.dtype != torch.uint8:
        raise ValueError(f"hist_q_u8: bins_t must be an (F, n) uint8 tensor, "
                         f"got {bins_t.dtype} {tuple(bins_t.shape)}")
    if not 1 <= B <= 256:
        raise ValueError(f"hist_q_u8: B ({B}) must be in [1, 256]: the "
                         "reference's uint8 one-hot compare wraps past 255")
    F, n = bins_t.shape
    _check_lengths("hist_q_u8", n, B, 1, pos=pos, gq=gq, hq=hq)
    N = node_ids.shape[0]
    dev = pos.device
    on_cpu = dev.type == "cpu"
    plan = u8_plan(N, F, B, n, 1 if on_cpu else _sm_count(dev.index), fg,
                   rows_per_block)
    if on_cpu:
        return hist_q_u8_plain(bins_t, pos, gq, hq, node_ids, B)
    for name, t, dtypes, shape in (
        ("bins_t", bins_t, (torch.uint8,), (F, n)),
        ("pos", pos, (torch.int32,), (n,)),
        ("gq", gq, (torch.float32,), (n,)),
        ("hq", hq, (torch.float32,), (n,)),
        ("node_ids", node_ids, (torch.int32,), (N,)),
    ):
        _check(name, t, dtypes, shape, dev)
    out = torch.zeros((F, 3 * N, B), dtype=torch.int32, device=dev)
    if n == 0 or N == 0 or F == 0:
        return out
    lib = _U8_LIBRARY.load()
    with torch.cuda.device(dev):
        rc = lib.ytk_hist_q_u8(
            bins_t.data_ptr(), n, pos.data_ptr(), gq.data_ptr(),
            hq.data_ptr(), node_ids.data_ptr(), N, F, B, plan["fg"],
            plan["n_fgroups"], plan["tps"], plan["mtw"], plan["n_slices"],
            plan["n_chunks"], plan["threads"], plan["smem"],
            plan["rows_per_block"], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    _U8_LIBRARY.check(rc, "hist_q_u8")
    _count(hist_q_u8)
    return out


hist_q_u8.launches = 0


# ---------------------------------------------------------------------------
# Compaction and host padding
# ---------------------------------------------------------------------------


def compact_indices(mask: torch.Tensor, R: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Order-preserving compaction of a boolean row mask into a static
    (R,) index buffer: idx[:cnt] are the True positions in ascending
    order, slots at/past cnt point at row 0 (callers mask them out).
    Entries past R are dropped. Returns (idx (R,) int32, cnt () int32);
    no host sync (no nonzero)."""
    n = mask.shape[0]
    dev = mask.device
    csum = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32)
    cnt = csum[-1] if n else torch.zeros((), dtype=torch.int32, device=dev)
    dest = torch.where(mask & (csum <= R), csum - 1, R).long()
    idx = torch.zeros(R + 1, dtype=torch.int32, device=dev)
    idx.scatter_(0, dest, torch.arange(n, dtype=torch.int32, device=dev))
    return idx[:R], cnt


def pad_inputs(bins: np.ndarray, bm: int = BM_DEFAULT, n_pad: int = None,
               F_pad: int = None):
    """Host one-time prep: transpose + pad the bin matrix. Returns
    (bins_t (F_pad, n_pad) int32, n_pad); padding rows get bin 0. The
    device trainer bins and pads on the card; the reference's host-binned
    path (multi-process shards, ROADMAP.md 1.7) pads with this."""
    n, F = bins.shape
    if n_pad is None:
        n_pad = _pad_to(n, bm)
    if F_pad is None:
        F_pad = F
    bins_t = np.zeros((F_pad, n_pad), np.int32)
    bins_t[:F, :n] = bins.T
    return bins_t, n_pad
