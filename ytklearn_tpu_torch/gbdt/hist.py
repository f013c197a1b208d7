"""GBDT histograms: the wrappers of kernels K1-K4, their plain versions,
and the row compaction of the leaf-partitioned waves.

  hist_wave         (N, F, B, 3) f32 histograms of f32 or bf16-rounded
                    grads over all rows: kernel K1 (csrc/hist.cu), replacing
                    ytklearn_tpu/gbdt/hist.py::_hist_pallas (:51)
  hist_wave_q       (N, F, B, 3) int32 histograms of int8-quantized grads
                    over all rows: kernel K2 (csrc/hist.cu), replacing
                    ytklearn_tpu/gbdt/hist.py::_hist_pallas_q (:113)
  hist_wave_gather  the same over a compacted row list, gathering each
                    row's bins in the kernel: mode "int8" runs K4 (int32
                    sums, replacing _hist_gather_pallas_q :434), mode "mxu"
                    hist_wave_gather_mxu, kernel K3 (f32 sums, replacing
                    _hist_gather_pallas :371)
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

Node ids: a row belongs to the wave slot s with node_ids[s] == pos[row];
negative ids are pads and match nothing, pos = -1 rows are dead, and a
duplicated id feeds only its lowest slot. Every id must be < `max_nodes`
(the tree's node capacity, the kernel's lookup-table size), which every
caller passes. The kernels keep the node lookup and one histogram tile in
shared memory: on CUDA, a tree of more nodes than fit there (about 57k at
256 bins) raises NotImplementedError (ROADMAP.md 1.8).
"""

from __future__ import annotations

import ctypes
import os
import threading
from functools import lru_cache
from typing import Tuple

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
THREADS = 512


def _pad_to(x: int, m: int) -> int:
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def node_slots(pos: torch.Tensor, node_ids: torch.Tensor, max_nodes: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot per row as int64, bool mask of rows in the wave): the lookup
    the kernels build in shared memory (lowest slot wins a duplicate)."""
    N = node_ids.shape[0]
    dev = pos.device
    ids = node_ids.long()
    in_range = (ids >= 0) & (ids < max_nodes)
    lut = torch.full((max_nodes + 1,), N, dtype=torch.long, device=dev)
    lut.scatter_reduce_(0, torch.where(in_range, ids, max_nodes),
                        torch.arange(N, device=dev), reduce="amin")
    lut[max_nodes] = N
    p = pos.long()
    ok = (p >= 0) & (p < max_nodes)
    slot = lut[torch.where(ok, p, max_nodes)]
    return slot, ok & (slot < N)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 -> nearest bf16 (ties to even) -> f32: jnp.astype(bfloat16)'s
    rounding, and the kernels' __float2bfloat16_rn."""
    return x.to(torch.bfloat16).float()


def _hist_plain(bin_of, pos, g, h, node_ids, F: int, B: int,
                max_nodes: int, mode: str) -> torch.Tensor:
    """Shared body: `bin_of(f, rows)` -> int64 bins of feature f. mode
    "q": g/h are f32 integers summed exactly (int32 out); "f32" / "bf16":
    f32 sums of g/h as given / rounded to bf16 (f32 out)."""
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
    return out.view(N, F, B, 3)


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


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def check_tile_fits(B: int, max_nodes: int) -> None:
    """Raise NotImplementedError when the lookup over `max_nodes` tree
    node ids and one slot x one feature of B bins do not fit one block's
    shared memory (at B = 256: more than 57,344 nodes)."""
    need = _pad_to(max_nodes, 4) * 4 + B * 3 * 4
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
    check_tile_fits(B, max_nodes)
    lut_bytes = _pad_to(max_nodes, 4) * 4
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
        "smem": lut_bytes + ng * fg * pair, "threads": threads,
    }


def _bind(lib) -> None:
    ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
    tail = [ci, ci, ci, ci, ci, ci, ci, ci, ci, ll, ci, ci, vp, vp]
    lib.ytk_hist_q.restype = ctypes.c_int
    lib.ytk_hist_q.argtypes = [ci, ci, vp, ll, vp, vp, vp, vp, ll, vp] + tail
    lib.ytk_hist.restype = ctypes.c_int
    lib.ytk_hist.argtypes = [ci, ci, ci, vp, ll, vp, vp, vp, vp, ll, vp] + tail


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "hist.cu"),
    _bind,
)
#: compile csrc/hist.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
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


def _launch(gather: bool, mode: str, bins, n_bins_rows: int, idx, pos, g,
            h, node_ids, B: int, max_nodes: int) -> torch.Tensor:
    """One launch of K1-K4. mode "q" (int32 sums: K2/K4), "f32" or "bf16"
    (f32 sums: K1/K3)."""
    dev = pos.device
    n = pos.shape[0]
    F = bins.shape[0] if not gather else bins.shape[1]
    N = node_ids.shape[0]
    for name, t, dtypes, shape in (
        ("pos", pos, (torch.int32,), (n,)),
        ("g" if mode != "q" else "gq", g, (torch.float32,), (n,)),
        ("h" if mode != "q" else "hq", h, (torch.float32,), (n,)),
        ("node_ids", node_ids, (torch.int32,), (N,)),
        ("bins", bins, (torch.uint8, torch.int32), tuple(bins.shape)),
    ):
        _check(name, t, dtypes, shape, dev)
    if gather:
        _check("idx", idx, (torch.int32,), (n,), dev)
    out = torch.zeros((N, F, B, 3), dtype=torch.int32 if mode == "q"
                      else torch.float32, device=dev)
    if n == 0 or N == 0 or F == 0:
        return out
    plan = tile_plan(N, F, B, max_nodes, n, _sm_count(dev.index))
    lib = _LIBRARY.load()
    head = [bins.element_size(), int(gather)]
    if mode != "q":
        head.append(int(mode == "bf16"))
    args = head + [
        bins.data_ptr(), n_bins_rows, idx.data_ptr() if gather else None,
        pos.data_ptr(), g.data_ptr(), h.data_ptr(), n, node_ids.data_ptr(),
        N, max_nodes, F, B, plan["fg"], plan["ng"], plan["n_ftiles"],
        plan["n_tiles"], plan["n_chunks"], plan["rows_per_chunk"],
        plan["threads"], plan["smem"], out.data_ptr(),
    ]
    with torch.cuda.device(dev):
        fn = lib.ytk_hist_q if mode == "q" else lib.ytk_hist
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    name = "hist_gather" if gather else "hist"
    _LIBRARY.check(rc, name + "_q" if mode == "q" else name)
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


def hist_wave(bins_t, pos, g, h, node_ids, B: int, *, max_nodes: int,
              use_bf16: bool = True) -> torch.Tensor:
    """(N, F, B, 3) f32 histograms for the nodes listed in `node_ids`.

    bins_t   (F, n) u8|i32 — transposed bin matrix
    pos      (n,) i32      — tree-node id per row (-1 = skip)
    g, h     (n,) f32      — weighted grad / hess, rounded to bf16 per row
                             when use_bf16 (the sums stay f32)
    node_ids (N,) i32      — node ids to histogram (-2 pads)
    max_nodes              — the tree's node capacity: every id < it
    On the CPU: the plain version; on CUDA: kernel K1."""
    if bins_t.dim() != 2:
        raise ValueError(f"hist_wave: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    _check_lengths("hist_wave", bins_t.shape[1], B, max_nodes, pos=pos, g=g,
                   h=h)
    if pos.device.type == "cpu":
        return hist_wave_plain(bins_t, pos, g, h, node_ids, B, max_nodes,
                               use_bf16)
    out = _launch(False, _val_mode(use_bf16), bins_t, bins_t.shape[1], None,
                  pos, g, h, node_ids, B, max_nodes)
    _count(hist_wave)
    return out


hist_wave.launches = 0


def hist_wave_q(bins_t, pos, gq, hq, node_ids, B: int, *, max_nodes: int
                ) -> torch.Tensor:
    """(N, F, B, 3) int32 histograms from int8-quantized grads.

    bins_t   (F, n) u8|i32 — transposed bin matrix
    pos      (n,) i32      — tree-node id per row (-1 = skip)
    gq, hq   (n,) f32      — quantized grad / hess, integers in [-127, 127]
    node_ids (N,) i32      — node ids to histogram (-2 pads)
    max_nodes              — the tree's node capacity: every id < it
    On the CPU: the plain version; on CUDA: kernel K2."""
    if bins_t.dim() != 2:
        raise ValueError(f"hist_wave_q: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    _check_lengths("hist_wave_q", bins_t.shape[1], B, max_nodes, pos=pos,
                   gq=gq, hq=hq)
    if pos.device.type == "cpu":
        return hist_wave_q_plain(bins_t, pos, gq, hq, node_ids, B, max_nodes)
    out = _launch(False, "q", bins_t, bins_t.shape[1], None, pos, gq, hq,
                  node_ids, B, max_nodes)
    _count(hist_wave_q)
    return out


hist_wave_q.launches = 0


def hist_wave_gather(rows, idx, pos_g, g, h, node_ids, B: int,
                     mode: str = "int8", *, max_nodes: int,
                     use_bf16: bool = True) -> torch.Tensor:
    """(N, F, B, 3) partial histograms over a compacted row subset:
    rows (n_rows, F) u8|i32 row-major, idx (R,) i32 row ids, pos_g (R,)
    i32 node per gathered row (-1 = dead slot), g/h (R,) f32 per gathered
    row. mode "int8": g/h quantized, int32 sums (kernel K4 on CUDA); mode
    "mxu": hist_wave_gather_mxu (K3). On the CPU: the plain versions."""
    if mode == "mxu":
        return hist_wave_gather_mxu(rows, idx, pos_g, g, h, node_ids, B,
                                    max_nodes=max_nodes, use_bf16=use_bf16)
    if mode != "int8":
        raise ValueError(f"hist_wave_gather: mode must be int8|mxu, got "
                         f"{mode!r}")
    _check_gather("hist_wave_gather", rows, idx, pos_g, g, h, B, max_nodes)
    if pos_g.device.type == "cpu":
        return hist_gather_q_plain(rows, idx, pos_g, g, h, node_ids, B,
                                   max_nodes)
    out = _launch(True, "q", rows, rows.shape[0], idx, pos_g, g, h,
                  node_ids, B, max_nodes)
    _count(hist_wave_gather)
    return out


hist_wave_gather.launches = 0


def hist_wave_gather_mxu(rows, idx, pos_g, g, h, node_ids, B: int, *,
                         max_nodes: int, use_bf16: bool = True
                         ) -> torch.Tensor:
    """(N, F, B, 3) f32 partial histograms over a compacted row subset
    (hist_wave_gather's inputs) with raw f32 g/h, rounded to bf16 per row
    when use_bf16. On the CPU: the plain version; on CUDA: kernel K3."""
    _check_gather("hist_wave_gather_mxu", rows, idx, pos_g, g, h, B,
                  max_nodes)
    if pos_g.device.type == "cpu":
        return hist_gather_plain(rows, idx, pos_g, g, h, node_ids, B,
                                 max_nodes, use_bf16)
    out = _launch(True, _val_mode(use_bf16), rows, rows.shape[0], idx, pos_g,
                  g, h, node_ids, B, max_nodes)
    _count(hist_wave_gather_mxu)
    return out


hist_wave_gather_mxu.launches = 0


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
