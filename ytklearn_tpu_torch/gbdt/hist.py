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
  tile_plan,        a shared-memory tile's launch shape (K1's tile kind) and
  check_plan        an explicit one, checked and completed (the tuning tools
                    pass one; the engine never does)
  float_plan,       K1/K3's launch shape (csrc/hist_float.cu): a
  check_float_plan  shared-memory tile, one vector atomic a row and feature,
                    or K1's "auto", which picks one of the two on the device
                    by the wave's share of the rows
  q_plan,           the same for K2/K4 (csrc/hist.cu): each row packed into
  check_q_plan      one word first (K4: its bins gathered beside), then a
                    tile, integer atomics straight into a scratch ("red"),
                    or K2's "auto"; K4 a tile of one feature
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
(the tree's node capacity, the size of the node lookup), which every
caller passes; K8 compares ids with positions and takes no capacity.
K1-K4 find a row's slot through a lookup over the tree's node ids, of one
of two kinds (`lookup_kind`): "shared", built in each block's shared
memory beside the histogram tile, for every tree whose lookup fits there
with one slot x feature tile (at 256 bins up to 57,344 nodes); or
"global", past that, a table of max_nodes int32 in device memory that one
block of the launch's lookup kernel fills, read through L2. A tile of
K1, K2 or K4 holds a range of bins (`bin_ranges`): all B bins while one
slot x feature of them fits shared memory (B <= 19,370), else the fewest
equal ranges that fit, each a tile of its own, which skips the rows whose
bin falls outside its range (2 ranges of 16,384 bins at B = 2^15, 4 at
2^16). The red kinds need no tile and take any B.
"""

from __future__ import annotations

import ctypes
import os
from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from ..cuda_build import KernelLibrary, launching

#: rows are padded to a multiple of this (the reference's Pallas sample
#: block; the int8 scale's qmax counts the padded rows)
BM_DEFAULT = 16384
#: gathered-row unit of the fused budget rungs (R is a multiple of it)
BMG_DEFAULT = 1024

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


def lookup_table(node_ids: torch.Tensor, max_nodes: int,
                 table: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the global lookup kind's kernel (`lookup_kernel`
    in csrc/hist_float.cu and csrc/hist.cu): an int32 table of max_nodes
    entries (padded to 4) whose entry id holds the lowest slot of id in
    node_ids, INT32_MAX where the wave has none. Ids outside [0,
    max_nodes) mark nothing. `table`: one to fill again, whatever an
    earlier wave left in it, as every launch fills its table."""
    L = _pad_to(max_nodes, 4)
    if table is None:
        table = torch.empty(L, dtype=torch.int32, device=node_ids.device)
    if table.shape != (L,) or table.dtype != torch.int32:
        raise ValueError(f"lookup table must be ({L},) int32, got "
                         f"{table.dtype} {tuple(table.shape)}")
    ids = node_ids.long()
    keep = (ids >= 0) & (ids < max_nodes)
    table.fill_(torch.iinfo(torch.int32).max)
    table.scatter_reduce_(0, ids[keep], torch.nonzero(keep).flatten().to(
        torch.int32), reduce="amin")
    return table


def lookup_slots(table: torch.Tensor, pos: torch.Tensor, max_nodes: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A row's slot through a lookup_table, as the kernels read it: (slot
    per row as int64, bool mask of rows in the wave); a position outside
    [0, max_nodes) or an entry of INT32_MAX is outside the wave."""
    p = pos.long()
    ok = (p >= 0) & (p < max_nodes)
    q = table[torch.where(ok, p, 0)].long()
    ok &= q != torch.iinfo(torch.int32).max
    return torch.where(ok, q, 0), ok


def node_slots(pos: torch.Tensor, node_ids: torch.Tensor,
               max_nodes: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot per row as int64, bool mask of rows in the wave): each row's
    lowest slot of its id, the lookup K1-K4 build in shared memory. Ids
    and positions at or past `max_nodes` match nothing; with max_nodes None
    (K8's rule) every id >= 0 may match. The shared lookup kind's plain
    version; lookup_slots is the global kind's."""
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
    sums of g/h as given / rounded to bf16, accumulated in float64 and
    rounded to f32 once (a cell's rows added one at a time in f32 drift
    far at large n: 2^19 adds of bf16(0.2) land 0.16% off). Each row adds
    into its id's lowest slot; every later slot of the same id then takes
    a copy of that slot's sums."""
    N = node_ids.shape[0]
    if max_nodes is not None and lookup_kind(B, max_nodes, N) == "global":
        slot, ok = lookup_slots(lookup_table(node_ids, max_nodes), pos,
                                max_nodes)
    else:
        slot, ok = node_slots(pos, node_ids, max_nodes)
    rows = torch.nonzero(ok).flatten()
    s = slot[rows]
    if mode == "q":
        dt = torch.long
        gv, hv = g[rows].to(torch.int32).long(), h[rows].to(torch.int32).long()
    else:
        dt = torch.float64
        gv, hv = g[rows].float(), h[rows].float()
        if mode == "bf16":
            gv, hv = round_bf16(gv), round_bf16(hv)
        gv, hv = gv.double(), hv.double()
    vals = torch.stack([gv, hv, torch.ones_like(gv)], dim=1)
    flat = torch.zeros((N * F * B, 3), dtype=dt, device=pos.device)
    for f in range(F):
        b = bin_of(f, rows)
        keep = (b >= 0) & (b < B)
        key = (s * F + f) * B + b
        flat.index_add_(0, key[keep], vals[keep])
    out = flat.to(torch.int32 if mode == "q" else torch.float32)
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


#: bytes of one bin of a slot x feature tile: three 4-byte counters
_CELL_BYTES = 12


def _lut_bytes(max_nodes: int, N: int) -> int:
    """Shared bytes of the shared lookup kind over `max_nodes` ids (N
    entries at least, padded to 4)."""
    return _pad_to(max(max_nodes, N), 4) * 4


def lookup_kind(B: int, max_nodes: int, N: int = 0) -> str:
    """K1-K4's kind of node lookup (tree node id -> the wave's lowest slot
    of it): "shared", built over every id in each block's shared memory,
    when that fits beside one slot x one feature tile of B bins (at B =
    256: up to 57,344 nodes), else "global", a table in device memory
    filled once a launch."""
    return ("shared" if _lut_bytes(max_nodes, N) + B * _CELL_BYTES
            <= SMEM_MAX else "global")


def _smem_lut(B: int, max_nodes: int, N: int) -> int:
    """Shared bytes a block spends on the node lookup: the shared kind's,
    or none."""
    return (_lut_bytes(max_nodes, N) if lookup_kind(B, max_nodes, N)
            == "shared" else 0)


def _lut_len(B: int, max_nodes: int, N: int) -> int:
    """int32 entries of a launch's global lookup table (0: the shared
    kind)."""
    return (_pad_to(max_nodes, 4) if lookup_kind(B, max_nodes, N)
            == "global" else 0)


def bin_ranges(B: int) -> int:
    """The planners' bin ranges a tile: the fewest equal ranges of B bins
    whose one slot x one feature tile fits SMEM_MAX. 1 (the whole of B)
    up to 19,370 bins, so every plan below that is the one-range plan; 2
    ranges of 16,384 bins at B = 2^15, 4 at 2^16. Past one range the node
    lookup is always the global kind (lookup_kind), so a range has all of
    SMEM_MAX."""
    return max(1, -(-B // (SMEM_MAX // _CELL_BYTES)))


def range_bins(B: int, nb: int) -> int:
    """Bins of each of `nb` equal ranges of B bins: range i is [i * bt,
    min(B, (i + 1) * bt)). Raises ValueError unless the nb ranges cover
    the B bins with none empty (so none overlaps either)."""
    if nb < 1 or nb > B:
        raise ValueError(f"plan: nb ({nb}) bin ranges must be in [1, B = "
                         f"{B}]")
    bt = -(-B // nb)
    if (nb - 1) * bt >= B:
        raise ValueError(f"plan: {nb} ranges of {bt} bins leave the last of "
                         f"B = {B} bins empty")
    return bt


def tile_bytes(N: int, ng: int, fg: int, B: int, max_nodes: int,
               nb: Optional[int] = None) -> int:
    """Shared bytes of a K1 tile block: the shared node lookup (none for
    the global kind) and a tile of `ng` slots x `fg` features x one range
    of B bins cut into `nb` (default bin_ranges(B)) of three 4-byte
    counters."""
    bt = range_bins(B, bin_ranges(B) if nb is None else nb)
    return _smem_lut(B, max_nodes, N) + ng * fg * bt * _CELL_BYTES


def tile_plan(N: int, F: int, B: int, max_nodes: int, n: int, sm_count: int
              ) -> dict:
    """A shared-memory tile's launch shape beside the node lookup (K1's
    tile kind takes its tiles from float_plan; check_float_plan checks
    them through check_plan). A block owns `ng` slots x `fg` features of
    the histogram in shared memory and scans one chunk of rows. Slots come
    first: a tile holding every slot of the wave uses every row it reads,
    where a tile of one slot in 64 would skip 63 rows in 64. A tile that
    fits half an SM's shared memory runs two blocks of 512 threads per SM;
    a larger one (64 slots of 256 bins: 196 KB) one block of 1024. Past
    one tile's bins a tile holds one of bin_ranges(B) ranges."""
    lut_bytes = _smem_lut(B, max_nodes, N)
    nb = bin_ranges(B)
    bt = range_bins(B, nb)
    pair = bt * _CELL_BYTES
    most = (SMEM_MAX - lut_bytes) // pair
    pairs = (SMEM_PER_BLOCK - lut_bytes) // pair
    if pairs >= 1 and pairs >= min(N, most):
        threads, per_sm = THREADS, 2
    else:
        pairs, threads, per_sm = most, 2 * THREADS, 1
    ng = min(N, pairs)
    fg = min(F, max(1, pairs // ng))
    n_ftiles = -(-F // fg)
    n_tiles = n_ftiles * -(-N // ng) * nb
    # about two waves of resident blocks; a chunk at least as long as two
    # rows per counter of a slot's feature, so the flush stays small
    target = 2 * per_sm * sm_count
    min_rows = max(2048, 2 * ng * bt)
    n_chunks = max(1, min(-(-target // n_tiles), -(-n // min_rows), 65535))
    rows_per_chunk = max(1, -(-n // n_chunks))
    n_chunks = max(1, -(-n // rows_per_chunk))
    return {
        "fg": fg, "ng": ng, "nb": nb, "n_ftiles": n_ftiles,
        "n_tiles": n_tiles, "n_chunks": n_chunks,
        "rows_per_chunk": rows_per_chunk,
        "smem": tile_bytes(N, ng, fg, B, max_nodes, nb), "threads": threads,
    }


_PLAN_KEYS = ("fg", "ng", "nb", "threads", "rows_per_chunk", "n_chunks",
              "n_ftiles", "n_tiles", "smem")


def check_plan(plan: dict, N: int, F: int, B: int, max_nodes: int, n: int,
               smem_of=None) -> dict:
    """An explicit tile launch shape (the tile and auto kinds of K1, and of
    K2/K4 through check_q_plan), checked before any launch and completed:
    `plan` names `fg` and `ng` (features and slots of a block's tile),
    `threads`, and `rows_per_chunk` or `n_chunks`; `nb`, the equal bin
    ranges a tile holds one of, defaults to bin_ranges(B). The fields that
    tile_plan derives (n_ftiles, n_tiles = feature tiles x slot tiles x
    ranges, smem and the other of the two chunk fields) may be given too,
    and must then be the ones the tile implies, so tile_plan's output
    passes. Raises ValueError when the plan does not cover the (N, F, B)
    histogram over n rows (its ranges each bin once), or its tile needs
    more shared memory than SMEM_MAX, or its threads do not make a block.
    `smem_of(ng, fg, nb)`: the tile's shared bytes (default tile_bytes',
    with the lookup)."""
    unknown = sorted(set(plan) - set(_PLAN_KEYS))
    if unknown:
        raise ValueError(f"plan: unknown fields {unknown}; a plan names "
                         f"{', '.join(_PLAN_KEYS)}")
    fg, ng = int(plan.get("fg", 0)), int(plan.get("ng", 0))
    nb = int(plan.get("nb", bin_ranges(B)))
    threads = int(plan.get("threads", THREADS))
    if fg < 1 or ng < 1:
        raise ValueError(f"plan: fg ({fg}) and ng ({ng}) must be >= 1")
    bt = range_bins(B, nb)
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
    n_tiles = n_ftiles * -(-N // ng) * nb
    if n_tiles > 2 ** 31 - 1:
        raise ValueError(f"plan: {n_tiles} tiles do not fit an int32")
    for name, want in (("n_ftiles", n_ftiles), ("n_tiles", n_tiles)):
        if name in plan and int(plan[name]) != want:
            raise ValueError(
                f"plan does not cover the histogram: {name} = {plan[name]}, "
                f"but fg = {fg}, ng = {ng}, nb = {nb} over (N, F, B) = "
                f"({N}, {F}, {B}) make {want}")
    smem = (smem_of(ng, fg, nb) if smem_of
            else tile_bytes(N, ng, fg, B, max_nodes, nb))
    if smem > SMEM_MAX:
        raise ValueError(
            f"plan's tile of {ng} slots x {fg} features x {bt} bins needs "
            f"{smem} bytes of shared memory, more than {SMEM_MAX}")
    if int(plan.get("smem", smem)) < smem:
        raise ValueError(f"plan: smem {plan['smem']} < the {smem} bytes "
                         "its tile needs")
    return {"fg": fg, "ng": ng, "nb": nb, "n_ftiles": n_ftiles,
            "n_tiles": n_tiles, "n_chunks": chunks, "rows_per_chunk": rpc,
            "smem": smem, "threads": threads}


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
    features as fit, the tiles evenly filled; a tile's bins are one of
    bin_ranges(B) ranges."""
    budget = SMEM_MAX - _smem_lut(B, max_nodes, N)
    pair = range_bins(B, bin_ranges(B)) * _CELL_BYTES
    st = -(-N // max(1, budget // pair))
    ng = -(-N // st)
    ft = -(-F // max(1, min(F, budget // (ng * pair))))
    return ng, -(-F // ft)


def _red_shape(N: int, B: int, max_nodes: int, n: int, sm_count: int
               ) -> Tuple[int, int, int, int]:
    """(chunks, rows a chunk, threads, shared bytes) of a red launch: one
    wave of resident blocks of THREADS threads, the shared lookup their
    only shared memory (the global kind: none)."""
    smem = _smem_lut(B, max_nodes, N)
    per_sm = max(1, min(2048 // THREADS, SMEM_PER_SM // (smem + 1024)))
    chunks = max(1, min(per_sm * sm_count, -(-n // RED_MIN_ROWS), 65535))
    rpc = _pad_to(max(1, -(-n // chunks)), 4)
    return max(1, -(-n // rpc)), rpc, THREADS, smem


@lru_cache(maxsize=512)
def _float_plan(N: int, F: int, B: int, max_nodes: int, n: int,
                sm_count: int, gather: bool) -> Tuple[Tuple[str, object], ...]:
    ng, fg = _float_tile(N, F, B, max_nodes)
    nb = bin_ranges(B)
    n_ftiles = -(-F // fg)
    n_tiles = n_ftiles * -(-N // ng) * nb
    if gather or n_tiles >= F * RED_WEIGHT:  # red at any share of rows
        chunks, rpc, threads, smem = _red_shape(N, B, max_nodes, n,
                                                sm_count)
        return tuple({
            "kind": "red", "fg": F, "ng": N, "nb": 1, "n_ftiles": 1,
            "n_tiles": 1, "n_chunks": chunks, "rows_per_chunk": rpc,
            "smem": smem, "threads": threads}.items())
    smem = tile_bytes(N, ng, fg, B, max_nodes, nb)
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
        "nb": nb, "n_ftiles": n_ftiles, "n_tiles": n_tiles,
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
    of blocks. Past the shared lookup's cap (lookup_kind "global") the
    lookup takes no shared memory. A tile holds one of `nb` =
    bin_ranges(B) ranges of bins (1 up to 19,370 bins), and `n_tiles`
    counts the ranges too; a red plan's `nb` is 1."""
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
    float_plan's output passes; a red plan adds every slot, feature and
    bin, so its fg, ng and nb, if given, are F, N and 1 and its tile counts
    1. Raises ValueError when the plan does not cover the (N, F, B)
    histogram over n rows, or needs more shared memory than SMEM_MAX, or
    its threads do not make a block."""
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
    red = _check_red_fields(rest, N, F, n, _smem_lut(B, max_nodes, N))
    return {"kind": "red", "fg": F, "ng": N, "nb": 1, "n_ftiles": 1,
            "n_tiles": 1, "n_chunks": red["n_chunks"],
            "rows_per_chunk": red["rows_per_chunk"], "smem": red["smem"],
            "threads": red["threads"]}


def _check_red_fields(rest: dict, N: int, F: int, n: int, smem: int
                      ) -> dict:
    """A red plan's fields (K1, K3, K2, K4): every slot, feature and bin in
    one tile, threads that make a block, chunks that cover the n rows, and at
    least `smem` shared bytes (the node lookup, or 0)."""
    for name, want in (("fg", F), ("ng", N), ("nb", 1), ("n_ftiles", 1),
                       ("n_tiles", 1)):
        if name in rest and int(rest[name]) != want:
            raise ValueError(f"plan does not cover the histogram: a red "
                             f"plan adds every slot, feature and bin, so "
                             f"{name} is {want}, not {rest[name]}")
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
    if int(rest.get("smem", smem)) < smem:
        raise ValueError(f"plan: smem {rest['smem']} < the {smem} bytes of "
                         "its node lookup")
    return {"n_chunks": chunks, "rows_per_chunk": rpc, "smem": smem,
            "threads": threads}


# ---------------------------------------------------------------------------
# K2/K4 launch shapes
# ---------------------------------------------------------------------------

#: K2/K4's kinds of launch (csrc/hist.cu), each after a pack pass that
#: writes one word a row (K4: and gathers the rows' bins): "tile", a block's
#: ng slots x fg features in shared memory; "red", three int32 atomics a row
#: and feature into an L2-resident scratch, every row read once; "auto", a
#: tile plan whose pack pass counts the wave's rows on the device and runs
#: the tile or, when the wave holds few rows, red
Q_KINDS = ("tile", "red", "auto")
#: the auto kind runs red when the wave's rows x F x Q_RED_WEIGHT < n x the
#: tiles: a tile pass over n packed rows costs about what Q_RED_WEIGHT
#: rows' integer atomics of one feature do (fitted on the card, PERF.md
#: section 6)
Q_RED_WEIGHT = 20.0
#: a packed row word holds the row's slot in 16 bits (0xFFFF: not in the
#: wave), so a wave has fewer slots: q_plan and check_q_plan refuse a wider
#: one (ValueError)
Q_MAX_SLOTS = 0xFFFF
#: a tile plan of at most this many chunks stores each item's tile whole
#: into its chunk's partial sums (plain stores; the finish kernel adds the
#: chunks up); more chunks flush with three atomics a nonzero bin into one
#: scratch, so the finish reads no more than Q_STORE_CHUNKS partials a bin
Q_STORE_CHUNKS = 8
#: the exactness bounds of csrc/hist.cu. A packed word holds g and h as
#: int8: |g|, |h| <= Q_MAX_ABS (engine._quantize's qmax at most). Every sum
#: (a tile's g, h and count, the scratch, the output) is an int32 lane that
#: wraps mod 2^32 as the reference's int32 sums do, so no chunk length or
#: row count bounds a lane; over at most Q_MAX_ROWS rows at |g| = |h| =
#: Q_MAX_ABS none wraps (engine._quantize shrinks qmax past it, so on its
#: gradients none ever does).
Q_MAX_ABS = 127
Q_MAX_ROWS = (2 ** 31 - 1) // Q_MAX_ABS


def q_tile_bytes(ng: int, fg: int, B: int, nb: Optional[int] = None
                 ) -> int:
    """Shared bytes of a K2 tile block: `ng` slots x `fg` features x one
    range of B bins cut into `nb` (default bin_ranges(B)) of three int32
    counters (the packed rows need no lookup)."""
    return ng * fg * range_bins(B, bin_ranges(B) if nb is None else nb) \
        * _CELL_BYTES


def _q_tile(N: int, F: int, B: int, gather: bool = False
            ) -> Tuple[int, int]:
    """(ng, fg) of a K2/K4 tile in SMEM_MAX: as many of the wave's slots as
    fit with one feature, then (K2) as many features as fit, the tiles
    evenly filled (_float_tile's rule without the lookup). K4 keeps one
    feature a tile: its R rows make each extra pass cheap, and the smaller
    tile flushes sooner (measured faster at N = 1-64, PERF.md section 6).
    A tile's bins are one of bin_ranges(B) ranges."""
    pair = range_bins(B, bin_ranges(B)) * _CELL_BYTES
    st = -(-N // max(1, SMEM_MAX // pair))
    ng = -(-N // st)
    if gather:
        return ng, 1
    ft = -(-F // max(1, min(F, SMEM_MAX // (ng * pair))))
    return ng, -(-F // ft)


def _q_red(N: int, F: int, chunks: int, rpc: int, threads: int) -> dict:
    """A K2/K4 red plan: the red kernel reads the packed rows and needs no
    shared memory (the pack pass holds the lookup)."""
    return {"kind": "red", "fg": F, "ng": N, "nb": 1, "n_ftiles": 1,
            "n_tiles": 1, "n_chunks": chunks, "rows_per_chunk": rpc,
            "smem": 0, "threads": threads}


def _check_q_slots(N: int) -> None:
    """Every slot of a K2/K4 wave fits the packed word's 16-bit field."""
    if N >= Q_MAX_SLOTS:
        raise ValueError(f"a K2/K4 wave holds fewer than {Q_MAX_SLOTS} slots "
                         f"(the packed row word's 16-bit field), got {N}")


@lru_cache(maxsize=512)
def _q_plan(N: int, F: int, B: int, max_nodes: int, n: int, sm_count: int,
            gather: bool) -> Tuple[Tuple[str, object], ...]:
    _check_q_slots(N)
    ng, fg = _q_tile(N, F, B, gather)
    nb = bin_ranges(B)
    n_tiles = -(-F // fg) * -(-N // ng) * nb
    if n_tiles >= F * Q_RED_WEIGHT:  # red at any share of rows
        chunks, rpc, threads, _ = _red_shape(N, B, max_nodes, n, sm_count)
        return tuple(_q_red(N, F, chunks, rpc, threads).items())
    smem = q_tile_bytes(ng, fg, B, nb)
    threads, per_sm = ((THREADS, 2) if smem <= SMEM_PER_BLOCK
                       else (2 * THREADS, 1))
    # one item a resident block where the tiles allow: each item's flush
    # costs an atomic a counter, so chunks are as long as one wave makes
    # them (the resident blocks past a whole number of chunks idle); K4's
    # few rows take at most Q_STORE_CHUNKS, so its tiles store
    chunks = max(1, min(per_sm * sm_count // n_tiles, -(-n // RED_MIN_ROWS),
                        Q_STORE_CHUNKS if gather else 65535))
    rpc = _pad_to(max(1, -(-n // chunks)), 4)
    return tuple({
        "kind": "tile" if n_tiles == 1 or gather else "auto", "fg": fg,
        "ng": ng, "nb": nb, "n_ftiles": -(-F // fg), "n_tiles": n_tiles,
        "n_chunks": max(1, -(-n // rpc)), "rows_per_chunk": rpc,
        "smem": smem, "threads": threads}.items())


def q_plan(N: int, F: int, B: int, max_nodes: int, n: int, sm_count: int,
           gather: bool = False) -> dict:
    """Launch shape of K2 (gather False: n rows scanned) or K4 (gather
    True: n = R gathered rows). A pass packs each row into one word first
    (its wave slot, g and h as int8; K4's gathers the rows' bins beside),
    in the "pack shape", _red_shape's. A tile: a block owns `ng` slots x
    `fg` features of the histogram in shared memory (every slot of the
    wave first; K4 one feature) over a chunk of `rows_per_chunk` packed
    rows, one item a resident block where it can (K4: at most
    Q_STORE_CHUNKS chunks). "tile" when one tile holds the whole
    histogram, and for K4, whose compacted rows are the wave's; "auto" for
    K2 when it takes more: the launch picks tile or red on the device by
    the wave's rows; "red" when the tiles are so many that red wins
    whatever the wave holds: no tile, integer atomics a row and feature,
    one wave of blocks. The pack pass holds the node lookup, of
    lookup_kind's kind. A tile holds one of `nb` = bin_ranges(B) ranges of
    bins (1 up to 19,370 bins), and `n_tiles` counts the ranges too; a red
    plan's `nb` is 1. Raises ValueError for a wave of Q_MAX_SLOTS slots or
    more."""
    return dict(_q_plan(N, F, B, max_nodes, n, sm_count, bool(gather)))


def check_q_plan(plan: dict, N: int, F: int, B: int, max_nodes: int,
                 n: int) -> dict:
    """An explicit launch shape of K2 (n rows scanned) or K4 (n = R
    gathered rows), checked before any launch and completed: `kind` ("tile", the default, "auto" or "red"), `threads`, and
    `rows_per_chunk` or `n_chunks`; a tile or auto plan names `fg` and `ng`
    (check_plan checks it, with q_tile_bytes' shared memory; the pack pass
    and auto's red launch take the pack shape). Derived fields (n_ftiles,
    n_tiles, smem, the other chunk field) may be given and must then be the
    ones the plan implies, so q_plan's output passes; a red plan adds every
    slot, feature and bin, so its fg, ng and nb, if given, are F, N and 1
    and its tile counts 1. Raises ValueError when the plan does not cover
    the (N, F, B) histogram over n rows, or needs more shared memory than
    SMEM_MAX, or its threads do not make a block, or the wave has
    Q_MAX_SLOTS slots or more."""
    _check_q_slots(N)
    unknown = sorted(set(plan) - set(_FLOAT_PLAN_KEYS))
    if unknown:
        raise ValueError(f"plan: unknown fields {unknown}; a plan names "
                         f"{', '.join(_FLOAT_PLAN_KEYS)}")
    kind = plan.get("kind", "tile")
    if kind not in Q_KINDS:
        raise ValueError(f"plan: kind must be one of {Q_KINDS}, got "
                         f"{kind!r}")
    rest = {k: v for k, v in plan.items() if k != "kind"}
    if kind != "red":
        return dict(check_plan(rest, N, F, B, max_nodes, n,
                               lambda ng, fg, nb: q_tile_bytes(ng, fg, B,
                                                               nb)),
                    kind=kind)
    red = _check_red_fields(rest, N, F, n, 0)
    return _q_red(N, F, red["n_chunks"], red["rows_per_chunk"],
                  red["threads"])


def _bind(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.ytk_hist_q.restype = ctypes.c_int
    lib.ytk_hist_q.argtypes = (
        [ci] * 6 + [vp, ll, vp, vp, vp, vp, ll, ll, vp] + [ci] * 11
        + [ll, ci, ci, ci, ll, ci, ci, ll, ci, vp, vp, vp, vp])


def _bind_float(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.ytk_hist_float.restype = ctypes.c_int
    lib.ytk_hist_float.argtypes = (
        [ci] * 6 + [vp, ll, vp, vp, vp, vp, ll, vp] + [ci] * 11
        + [ll, ci, ci, ci, ll, ci, ci, ll, vp, vp, vp, vp])


_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_LIBRARY = KernelLibrary(os.path.join(_CSRC, "hist.cu"), _bind)
#: compile csrc/hist.cu (K2, K4) now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_FLOAT_LIBRARY = KernelLibrary(os.path.join(_CSRC, "hist_float.cu"),
                               _bind_float)
#: compile csrc/hist_float.cu (K1, K3) now: {cmd, seconds, log}; raises on
#: failure
build_float_kernel = _FLOAT_LIBRARY.build


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


def _aligned(t: torch.Tensor, m: int) -> bool:
    return t.data_ptr() % m == 0


@lru_cache(maxsize=1024)
def _q_shape(N: int, F: int, B: int, max_nodes: int, n: int, sm_count: int,
             gather: bool, eb: int, plan: Tuple[Tuple[str, object], ...]
             ) -> Tuple[int, ...]:
    """What one K2/K4 launch derives from its shapes and plan: (n_pad, the
    pack shape's 4 fields, n_store, red_rows, the scratch's int32 length,
    the global lookup's int32 length (0: the shared kind))."""
    p = dict(plan)
    n_pad = _pad_to(n, 4) if gather else n
    # the tile stores its chunks' partial sums when they are few
    n_store = p["n_chunks"] if (p["kind"] != "red"
                                and p["n_chunks"] <= Q_STORE_CHUNKS) else 0
    # auto: red below this many rows of the wave (see Q_RED_WEIGHT)
    red_rows = int(n * p["n_tiles"] // (F * Q_RED_WEIGHT))
    # the kernels' scratch (csrc/hist.cu, ytk_hist_q): 16-byte (N, F, B)
    # cells, 16 bytes holding auto's count of the wave's rows, the n_pad
    # packed row words, (K4) the (F, n_pad) gathered bins, then the store
    # mode's (n_store, N, F, B, 3) partial sums; the global lookup's table
    # after them
    scratch_len = ((N * F * B + 1) * 4 + n_pad
                   + (F * n_pad * eb // 4 if gather else 0)
                   + n_store * N * F * B * 3)
    return (n_pad, *_red_shape(N, B, max_nodes, n, sm_count), n_store,
            red_rows, scratch_len, _lut_len(B, max_nodes, N))


def _launch_q(wrapper, gather: bool, bins, n_bins_rows: int, idx, pos, gq,
              hq, node_ids, B: int, max_nodes: int,
              plan: Optional[dict] = None) -> torch.Tensor:
    """One launch of K2 (full scan) or K4 (gather), counted on `wrapper`:
    int32 sums; `plan` from check_q_plan, else q_plan's. The pack pass takes
    rows four at a time when pos/gq/hq (and idx) are 16-byte aligned; the
    tile and red kernels when the chunks are multiples of four rows and
    the scanned bins allow it: K4's gathered copy always, K2's bins when
    every feature's row starts on a four-row boundary. Otherwise one row at
    a time."""
    dev = pos.device
    n = pos.shape[0]
    F = bins.shape[1] if gather else bins.shape[0]
    N = node_ids.shape[0]
    _check_inputs(gather, "gq", bins, idx, pos, gq, hq, node_ids)
    if n == 0 or N == 0 or F == 0:
        return torch.zeros((N, F, B, 3), dtype=torch.int32, device=dev)
    sm = _sm_count(dev.index)
    if plan is None:
        plan = q_plan(N, F, B, max_nodes, n, sm, gather)
    eb = bins.element_size()
    nb = plan.get("nb", 1)  # a plan without ranges: all B bins a tile
    (n_pad, pack_chunks, pack_rpc, pack_threads, pack_smem, n_store,
     red_rows, scratch_len, lut_len) = _q_shape(
        N, F, B, max_nodes, n, sm, gather, eb, tuple(plan.items()))
    pack_vec = all(_aligned(t, 16) for t in ((pos, gq, hq, idx) if gather
                                             else (pos, gq, hq)))
    scan_vec = plan["rows_per_chunk"] % 4 == 0 and (
        gather or (n % 4 == 0 and _aligned(bins, 4 * eb)))
    words = gather and eb == 1 and F % 4 == 0 and _aligned(bins, 4)
    scratch = torch.empty(scratch_len + lut_len, dtype=torch.int32,
                          device=dev)
    out = torch.empty((N, F, B, 3), dtype=torch.int32, device=dev)
    lib = _LIBRARY.load()
    name = "hist_gather_q" if gather else "hist_q"
    args = (
        Q_KINDS.index(plan["kind"]), eb, int(gather), int(pack_vec),
        int(scan_vec), int(words), bins.data_ptr(), n_bins_rows,
        idx.data_ptr() if gather else None, pos.data_ptr(), gq.data_ptr(),
        hq.data_ptr(), n, n_pad, node_ids.data_ptr(), N, max_nodes, F, B,
        plan["fg"], plan["ng"], plan["n_ftiles"], plan["n_tiles"],
        nb, range_bins(B, nb), plan["n_chunks"],
        plan["rows_per_chunk"], plan["threads"], plan["smem"], pack_chunks, pack_rpc, pack_threads, pack_smem,
        red_rows, n_store, out.data_ptr(), scratch.data_ptr(),
        scratch[scratch_len:].data_ptr() if lut_len else None,
    )
    with launching(wrapper, name, plan["kind"], eb, int(pack_vec),
                   int(scan_vec), int(lut_len > 0)):
        if dev.index == torch.cuda.current_device():
            rc = lib.ytk_hist_q(*args,
                                torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                rc = lib.ytk_hist_q(*args,
                                    torch.cuda.current_stream().cuda_stream)
        _LIBRARY.check(rc, name)
    return out


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
    nb = plan.get("nb", 1)  # a plan without ranges: all B bins a tile
    # the kernels' scratch, zeroed by the launcher: (g, h, count, unused) a
    # bin, 16-byte aligned, then the auto kind's count of the wave's rows;
    # the global lookup's table after it
    acc_len = N * F * B * 4 + 4
    lut_len = _lut_len(B, max_nodes, N)
    scratch = torch.empty(acc_len + lut_len, dtype=torch.float32, device=dev)
    out = torch.empty((N, F, B, 3), dtype=torch.float32, device=dev)
    red_shape = _red_shape(N, B, max_nodes, n, _sm_count(dev.index))
    # auto: red below this many rows of the wave (see RED_WEIGHT)
    red_rows = int(n * plan["n_tiles"] // (F * RED_WEIGHT))
    lib = _FLOAT_LIBRARY.load()
    args = [
        FLOAT_KINDS.index(kind), eb, int(gather), int(vec), int(use_bf16),
        int(words), bins.data_ptr(), n_bins_rows,
        idx.data_ptr() if gather else None, pos.data_ptr(), g.data_ptr(),
        h.data_ptr(), n, node_ids.data_ptr(), N, max_nodes, F, B,
        plan["fg"], plan["ng"], plan["n_ftiles"], plan["n_tiles"],
        nb, range_bins(B, nb), plan["n_chunks"],
        plan["rows_per_chunk"], plan["threads"], plan["smem"], *red_shape, red_rows, out.data_ptr(),
        scratch.data_ptr(),
        scratch[acc_len:].data_ptr() if lut_len else None,
    ]
    name = "hist_gather" if gather else "hist"
    with launching(wrapper, name, kind, eb, int(vec), int(lut_len > 0)):
        if dev.index == torch.cuda.current_device():
            rc = lib.ytk_hist_float(*args,
                                    torch.cuda.current_stream().cuda_stream)
        else:
            with torch.cuda.device(dev):
                rc = lib.ytk_hist_float(
                    *args, torch.cuda.current_stream().cuda_stream)
        _FLOAT_LIBRARY.check(rc, name)
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


def _plan_of(plan, node_ids, F: int, B: int, max_nodes: int, n: int,
             check, **kw):
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
    plan                   — a launch shape for check_q_plan (tuning tools)
    On the CPU: the plain version; on CUDA: kernel K2."""
    if bins_t.dim() != 2:
        raise ValueError(f"hist_wave_q: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    _check_lengths("hist_wave_q", bins_t.shape[1], B, max_nodes, pos=pos,
                   gq=gq, hq=hq)
    plan = _plan_of(plan, node_ids, bins_t.shape[0], B, max_nodes,
                    bins_t.shape[1], check_q_plan)
    if pos.device.type == "cpu":
        return hist_wave_q_plain(bins_t, pos, gq, hq, node_ids, B, max_nodes)
    return _launch_q(hist_wave_q, False, bins_t, bins_t.shape[1], None, pos,
                     gq, hq, node_ids, B, max_nodes, plan)


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
    check_q_plan (int8) or check_float_plan (mxu). On the CPU: the plain
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
                    idx.shape[0], check_q_plan)
    if pos_g.device.type == "cpu":
        return hist_gather_q_plain(rows, idx, pos_g, g, h, node_ids, B,
                                   max_nodes)
    return _launch_q(hist_wave_gather, True, rows, rows.shape[0], idx, pos_g,
                     g, h, node_ids, B, max_nodes, plan)


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

#: K8's launch shape (csrc/hist_u8.cu): a block is one producer warpgroup
#: and U8_CONSUMERS consumer warpgroups; the producer stages `kt` rows at a
#: time (kt / 32 k-steps of the wgmma product; kt in U8_KTS, the longest
#: whose ring holds U8_RING_MIN stages), u8_ahead(kt) stages ahead into
#: u8_ahead(kt) + 1 staged slots of its own, and builds PV into a ring of
#: at most U8_RING stages that the consumers read
U8_KTS = (512, 256, 128)
U8_CONSUMERS = 2
U8_THREADS = 128 * (1 + U8_CONSUMERS)
U8_RING = 4
U8_RING_MIN = 3
#: the kernel's wgmma widths: an n-tile holds 3N rows of PV rounded up to
#: one of them, and 3N past the last is cut into n-tiles of at most it
U8_WIDTHS = (32, 64, 96, 128, 192, 256)
#: the (W, mtw, kt) instances csrc/hist_u8.cu compiles
U8_INSTANCES = frozenset(
    [(w, m, 512) for w in (32, 64, 96) for m in (1, 2)]
    + [(128, 1, 512), (192, 1, 256), (192, 1, 128), (256, 1, 256),
       (256, 1, 128)])
#: 64-bin m-tiles a consumer holds: two where the accumulators (MTW x W / 2
#: int32 a thread) and the two sets of A fragments (16 MTW) stay within
#: U8_REGS
U8_REGS = 144
#: features an item may cover (the parent design's warps a block)
U8_MAX_FG = 16
#: rows at least in an item's chunk when the plan picks the chunk length
U8_MIN_ROWS = 8192
_U8_BARRIER_BYTES = 16


def u8_ahead(kt: int) -> int:
    """Stages K8's producer loads ahead: 1024 rows, two stages at least."""
    return max(2, 1024 // kt)


def _u8_tiles(N: int, B: int) -> Tuple[int, int, int, int]:
    """(W, n-tiles, MTW, m-groups) of K8: the 3N PV rows cut into the
    fewest n-tiles of at most U8_WIDTHS[-1] rows, each rounded up to a wgmma
    width W; the ceil(B/64) m-tiles of 64 bins in groups of MTW."""
    rows3 = 3 * max(N, 1)
    n_ntiles = -(-rows3 // U8_WIDTHS[-1])
    W = next(w for w in U8_WIDTHS if w * n_ntiles >= rows3)
    MT = -(-B // 64)
    mtw = 2 if MT >= 2 and 2 * W // 2 + 16 * 2 <= U8_REGS else 1
    return W, n_ntiles, mtw, -(-MT // mtw)


def _u8_stage_bytes(W: int, regions: int, kt: int) -> int:
    """A ring stage: PV regions, the consumers' bins, two mbarriers."""
    return regions * kt * W + U8_CONSUMERS * kt + _U8_BARRIER_BYTES


def _u8_smem(W: int, regions: int, ring: int, kt: int) -> int:
    """The ring, the staged slots (pos, gq, hq as f32 and g, h as int8 of
    kt rows and the consumers' bins) and the tables of PV rows (two
    regions of W rows x (id, channel))."""
    return (ring * _u8_stage_bytes(W, regions, kt)
            + (u8_ahead(kt) + 1) * kt * (14 + U8_CONSUMERS) + 2 * W * 5)


def _u8_ring(W: int, regions: int, kt: int) -> int:
    return min(U8_RING, (SMEM_MAX - _u8_smem(W, regions, 0, kt))
               // _u8_stage_bytes(W, regions, kt))


def _u8_chunks(n_fgroups: int, n: int, sm_count: int) -> int:
    """Row chunks for a persistent grid of sm_count blocks over n_fgroups x
    chunks equal items: the fewest whose makespan, ceil(items / blocks) /
    chunks, is within 2% of the best over chunks of U8_MIN_ROWS rows or
    more."""
    top = max(1, n // U8_MIN_ROWS)

    def span(c):
        return -(-n_fgroups * c // sm_count) / c

    best = min(span(c) for c in range(1, top + 1))
    return next(c for c in range(1, top + 1) if span(c) <= best * 1.02)


@lru_cache(maxsize=512)
def _u8_plan(N: int, F: int, B: int, n: int, sm_count: int, fg: int,
             rows_per_block: int) -> Tuple[Tuple[str, object], ...]:
    W, n_ntiles, mtw, n_mgroups = _u8_tiles(N, B)
    upf = n_ntiles * n_mgroups
    if fg <= 0:  # the default: an item's units fill whole rounds
        fg = 1 if upf % U8_CONSUMERS == 0 else min(max(F, 1), U8_CONSUMERS)
    regions = min(U8_CONSUMERS, n_ntiles)
    kt = next(k for k in U8_KTS
              if _u8_ring(W, regions, k) >= (U8_RING_MIN if k > U8_KTS[-1]
                                             else 2))
    ring = _u8_ring(W, regions, kt)
    n_fgroups = max(1, -(-F // fg))
    if rows_per_block <= 0:
        chunks = _u8_chunks(n_fgroups, n, sm_count)
        rows_per_block = _pad_to(max(1, -(-n // chunks)), kt)
    n_chunks = max(1, -(-n // rows_per_block))
    items = n_fgroups * n_chunks
    return tuple({
        "W": W, "n_ntiles": n_ntiles, "mtw": mtw, "n_mgroups": n_mgroups,
        "fg": fg, "n_fgroups": n_fgroups, "rows_per_block": rows_per_block,
        "n_chunks": n_chunks, "items": items, "regions": regions,
        "kt": kt, "ring": ring, "smem": _u8_smem(W, regions, ring, kt),
        "threads": U8_THREADS, "blocks": max(1, min(items, sm_count)),
    }.items())


def u8_plan(N: int, F: int, B: int, n: int, sm_count: int,
            fg: Optional[int] = None,
            rows_per_block: Optional[int] = None) -> dict:
    """Launch shape of K8 (csrc/hist_u8.cu). The (3N, B) histogram of one
    feature is cut into n-tiles of PV rows (`n_ntiles` of width `W`, a wgmma
    width) x m-groups of `mtw` 64-bin m-tiles (`n_mgroups`): n_ntiles x
    n_mgroups units, each one consumer warpgroup's accumulators. An item is
    `fg` features (their units in rounds of U8_CONSUMERS, each round a pass
    over the rows) x a chunk of `rows_per_block` rows; a persistent grid of
    `blocks` (at most one an SM) walks the n_fgroups x n_chunks items.
    fg None: one feature, or two when a feature's units are odd;
    rows_per_block None: the chunks that balance the items over the SMs
    best (_u8_chunks), a multiple of the stage's `kt` rows. The plan is
    checked by
    check_u8_plan, which raises ValueError for an fg outside [1,
    U8_MAX_FG] or rows_per_block < 1."""
    if fg is not None and not 1 <= int(fg) <= U8_MAX_FG:
        raise ValueError(f"hist_q_u8: fg ({fg}) must be in [1, {U8_MAX_FG}]")
    if rows_per_block is not None and int(rows_per_block) < 1:
        raise ValueError(f"hist_q_u8: rows_per_block ({rows_per_block}) "
                         "must be >= 1")
    return check_u8_plan(
        dict(_u8_plan(N, F, B, n, max(1, sm_count), int(fg or 0),
                      int(rows_per_block or 0))), N, F, B, n)


def check_u8_plan(plan: dict, N: int, F: int, B: int, n: int) -> dict:
    """Check a K8 launch shape before any launch (pure integer checks):
    W a wgmma width and its n-tiles covering the 3N PV rows, its m-groups
    covering the B bins (B <= 256), the accumulators and A fragments within
    U8_REGS registers a thread, fg in [1, U8_MAX_FG] and its feature groups
    covering F, chunks covering the n rows, the items and the grid in
    range, the ring's shared memory within SMEM_MAX. Returns the plan;
    raises ValueError naming what fails."""
    W, nt, mtw, mg = (int(plan[k]) for k in ("W", "n_ntiles", "mtw",
                                              "n_mgroups"))
    fg, nfg = int(plan["fg"]), int(plan["n_fgroups"])
    rpb, chunks = int(plan["rows_per_block"]), int(plan["n_chunks"])
    if W not in U8_WIDTHS:
        raise ValueError(f"u8 plan: W ({W}) is not one of {U8_WIDTHS}")
    if nt < 1 or W * nt < 3 * N or W * (nt - 1) >= max(3 * N, 1):
        raise ValueError(f"u8 plan: {nt} n-tiles of {W} rows do not cut "
                         f"3N = {3 * N} PV rows")
    if mtw not in (1, 2) or mg < 1 or 64 * mtw * mg < B             or 64 * mtw * (mg - 1) >= B or not 1 <= B <= 256:
        raise ValueError(f"u8 plan: {mg} m-groups of {mtw} m-tiles do not "
                         f"cover B = {B} bins in at most 256")
    if mtw * W // 2 + 16 * mtw > U8_REGS:
        raise ValueError(f"u8 plan: {mtw} m-tiles x W = {W} need "
                         f"{mtw * W // 2} accumulator registers a thread, "
                         f"past the budget of {U8_REGS}")
    if not 1 <= fg <= U8_MAX_FG or nfg != max(1, -(-F // fg)):
        raise ValueError(f"u8 plan: fg ({fg}) must be in [1, {U8_MAX_FG}] "
                         f"and its {nfg} groups cover F = {F}")
    if rpb < 1 or chunks != max(1, -(-n // rpb)):
        raise ValueError(f"u8 plan: {chunks} chunks of {rpb} rows do not "
                         f"cover n = {n}")
    if int(plan["items"]) != nfg * chunks or nfg * chunks > 2 ** 31 - 1:
        raise ValueError(f"u8 plan: items ({plan['items']}) must be "
                         f"{nfg} x {chunks} and fit an int32")
    if not 1 <= int(plan["blocks"]) <= min(int(plan["items"]), 2 ** 31 - 1):
        raise ValueError(f"u8 plan: blocks ({plan['blocks']}) must be in "
                         f"[1, items = {plan['items']}]")
    regions, ring, kt = (int(plan[k]) for k in ("regions", "ring", "kt"))
    if regions != min(U8_CONSUMERS, nt) or ring < 2:
        raise ValueError(f"u8 plan: regions ({regions}) must be "
                         f"{min(U8_CONSUMERS, nt)} and ring ({ring}) >= 2")
    if (W, mtw, kt) not in U8_INSTANCES:
        raise ValueError(f"u8 plan: (W, mtw, kt) = ({W}, {mtw}, {kt}) is not "
                         "an instance of the kernel")
    smem = _u8_smem(W, regions, ring, kt)
    if int(plan["smem"]) != smem or smem > SMEM_MAX:
        raise ValueError(f"u8 plan: {ring} stages of {regions} PV regions "
                         f"of width {W} need {smem} bytes of shared memory "
                         f"(plan: {plan['smem']}; at most {SMEM_MAX})")
    if int(plan["threads"]) != U8_THREADS:
        raise ValueError(f"u8 plan: threads must be {U8_THREADS}")
    return plan


def _bind_u8(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    lib.ytk_hist_q_u8.restype = ctypes.c_int
    lib.ytk_hist_q_u8.argtypes = [vp, ll, vp, vp, vp, vp] + [ci] * 10 + [
        ll, ll] + [ci] * 6 + [vp, vp]


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
    vec = int(all(_aligned(t, 16) for t in (pos, gq, hq))
              and plan["rows_per_block"] % 4 == 0)
    bins_vec = int(_aligned(bins_t, 16) and n % 16 == 0
                   and plan["rows_per_block"] % 16 == 0)
    with launching(hist_q_u8, "hist_q_u8", plan["W"], vec, bins_vec), \
            torch.cuda.device(dev):
        rc = lib.ytk_hist_q_u8(
            bins_t.data_ptr(), n, pos.data_ptr(), gq.data_ptr(),
            hq.data_ptr(), node_ids.data_ptr(), N, F, B, plan["W"],
            plan["mtw"], plan["kt"], plan["n_ntiles"], plan["n_mgroups"], plan["fg"],
            plan["n_fgroups"], plan["n_chunks"], plan["rows_per_block"],
            plan["regions"], plan["ring"], vec, bins_vec,
            plan["blocks"], plan["smem"], out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        _U8_LIBRARY.check(rc, "hist_q_u8")
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
