"""Wave routing: the wrapper of kernel K5 and its plain version.

  route_wave        one pass over the rows for a wave of NW split slots:
                    kernel K5 (csrc/route.cu), replacing
                    ytklearn_tpu/gbdt/route.py::_route_pallas (:23)
  route_wave_plain  the same function in plain PyTorch (the counterpart of
                    ytklearn_tpu/gbdt/engine.py::_route_wave, :312)

For slot i, a row with pos == nid[i] and valid[i] moves to rch[i] if
slot[i] < bin <= hi[i] and bin >= lo[i], else to lch[i], where bin is the
row's bin of feature max(feat[i], 0). Every slot tests the row's position
from BEFORE the wave (the Pallas kernel's rule); `engine._route_wave`
updates pos slot by slot instead, and the two agree only because a wave's
child ids are fresh (never a node id of the same wave). The wrapper takes
the plain version only for tensors on the CPU; on a CUDA tensor it
launches the kernel or raises. `route_wave.launches` counts the launches.

K5's launch shape comes from `route_plan`: a persistent grid of at most
ROUTE_BLOCKS_PER_SM blocks an SM, each of which reads the wave's slot
fields where the caller keeps them (`_field`: no table is stacked on the
host) and turns them into a node -> slot lookup in shared memory (a
direct map over the valid ids' span when it is at most `map_cap` ids,
else the sorted ids and a binary search; the highest valid slot of an id
wins either way), then routes four rows a thread.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from ..cuda_build import KernelLibrary, launching
from .hist import SMEM_MAX, _sm_count

#: default upper bound of a slot's member range (no bound)
HI_DEFAULT = 2 ** 30
THREADS = 256
#: resident blocks of THREADS an SM the persistent grid asks for
ROUTE_BLOCKS_PER_SM = 8
#: ids the direct node -> slot map may span (int32 entries in shared memory)
ROUTE_MAP_CAP = 4096
#: shared bytes of one slot's entry (feature, split slot, children, range)
ROUTE_ENTRY_BYTES = 24
#: the kernel's codes of the slot fields' element types (csrc/route.cu)
_FIELD_CODES = {torch.bool: 1, torch.uint8: 1, torch.int8: -1,
                torch.int16: 2, torch.int32: 4, torch.int64: 8}


def _field(name: str, t: Optional[torch.Tensor], NW: int,
           dev: torch.device) -> Tuple[Optional[torch.Tensor], int]:
    """One per-slot field as the kernel reads it, in place: (tensor, code
    of its element type); (None, 0) for an absent lo/hi. Another dtype or
    a strided view is converted to contiguous int32 first (the plain
    version's comparisons are those of .to(torch.int32))."""
    if t is None:
        return None, 0
    if t.device != dev or tuple(t.shape) != (NW,):
        raise ValueError(f"route_wave: {name} must be an ({NW},) tensor on "
                         f"pos's device {dev}, got {tuple(t.shape)} on "
                         f"{t.device}")
    code = _FIELD_CODES.get(t.dtype)
    if code is None or not t.is_contiguous():
        return t.to(torch.int32).contiguous(), 4
    return t, code


def route_wave_plain(bins_t, pos, valid, nid, feat, slot, lch, rch, lo, hi
                     ) -> torch.Tensor:
    """Plain PyTorch twin of K5 (same arguments as route_wave, lo/hi
    given). A later matching slot wins."""
    F = bins_t.shape[0]
    newp = pos.clone()
    for i in range(nid.shape[0]):
        f = torch.clamp(feat[i].long(), 0, F - 1)
        row = bins_t[f].to(torch.int32)
        go_right = (row > slot[i]) & (row >= lo[i]) & (row <= hi[i])
        child = torch.where(go_right, rch[i], lch[i]).to(pos.dtype)
        newp = torch.where((pos == nid[i]) & valid[i], child, newp)
    return newp


def route_plan(NW: int, n: int, sm_count: int, vec: bool = True) -> dict:
    """Launch shape of K5 for a wave of NW slots over n rows: `map_cap`,
    the ids the direct map may span; `smem`, the bytes of the NW slot
    entries and of the map or the NW sorted ids, whichever is larger;
    `blocks`, a persistent grid of at most ROUTE_BLOCKS_PER_SM blocks an SM
    and no more than the rows (four a thread when `vec`) need. Raises
    ValueError when the entries and sorted ids pass SMEM_MAX (NW past
    8,301)."""
    if NW < 0 or n < 0 or sm_count < 1:
        raise ValueError(f"route_plan: NW ({NW}), n ({n}) and sm_count "
                         f"({sm_count}) must be >= 0, >= 0 and >= 1")
    room = (SMEM_MAX - ROUTE_ENTRY_BYTES * NW) // 4
    if room < max(NW, 1):
        raise ValueError(f"route_wave: a wave of {NW} slots needs more than "
                         f"{SMEM_MAX} bytes of shared memory for its slot "
                         "entries and sorted ids")
    map_cap = max(1, min(ROUTE_MAP_CAP, room))
    items = -(-n // 4) if vec else n
    blocks = max(1, min(-(-items // THREADS), ROUTE_BLOCKS_PER_SM * sm_count))
    return {"map_cap": map_cap, "threads": THREADS, "blocks": blocks,
            "smem": ROUTE_ENTRY_BYTES * NW + 4 * max(map_cap, NW)}


def _bind(lib) -> None:
    lib.ytk_route.restype = ctypes.c_int
    lib.ytk_route.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "route.cu"),
    _bind,
)
#: compile csrc/route.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build



def route_wave(bins_t, pos, valid, nid, feat, slot, lch, rch, lo=None,
               hi=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New (n,) int32 positions after one wave of splits.

    bins_t (F, n) u8|i32, pos (n,) i32; valid (NW,) bool and nid, feat,
    slot, lch, rch (NW,) int per slot; lo/hi optional per-slot member
    range (default 0 and 2^30). `out`, a contiguous (n,) int32 tensor on
    pos's device, receives the result and may be `pos` itself (the kernel
    reads a row's position before writing it)."""
    NW = nid.shape[0]
    if bins_t.dim() != 2:
        raise ValueError(f"route_wave: bins_t must be (F, n), got "
                         f"{tuple(bins_t.shape)}")
    F, n = bins_t.shape
    checks = [("bins_t", bins_t, (torch.uint8, torch.int32), (F, n)),
              ("pos", pos, (torch.int32,), (n,))]
    if out is not None:
        checks.append(("out", out, (torch.int32,), (n,)))
    for name, t, dtypes, shape in checks:
        if t.device != pos.device or t.dtype not in dtypes \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"route_wave: {name} must be a contiguous {dtypes} {shape} "
                f"tensor on {pos.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}"
            )
    if F == 0:
        raise ValueError("route_wave: bins_t has no features")
    if pos.device.type == "cpu":
        if lo is None:
            lo = torch.zeros(NW, dtype=torch.int32)
        if hi is None:
            hi = torch.full((NW,), HI_DEFAULT, dtype=torch.int32)
        new = route_wave_plain(bins_t, pos, valid, nid, feat, slot, lch, rch,
                               lo, hi)
        return new if out is None else out.copy_(new)
    fields = [_field(k, t, NW, pos.device) for k, t in (
        ("valid", valid), ("nid", nid), ("feat", feat), ("slot", slot),
        ("lch", lch), ("rch", rch), ("lo", lo), ("hi", hi))]
    if out is None:
        out = torch.empty_like(pos)
    if n == 0:
        return out
    vec = pos.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    plan = route_plan(NW, n, _sm_count(pos.device.index), vec)
    lib = _LIBRARY.load()
    with launching(route_wave, "route", bins_t.element_size(), int(vec)), \
            torch.cuda.device(pos.device):
        rc = lib.ytk_route(
            bins_t.element_size(), bins_t.data_ptr(), n, F, pos.data_ptr(),
            (ctypes.c_void_p * 8)(*[0 if t is None else t.data_ptr()
                                    for t, _ in fields]),
            (ctypes.c_int * 8)(*[c for _, c in fields]), NW,
            plan["map_cap"], int(vec),
            int(bins_t.data_ptr() % 16 == 0 and n % 4 == 0),
            int(out.data_ptr() == pos.data_ptr()), out.data_ptr(),
            plan["blocks"], plan["smem"],
            torch.cuda.current_stream().cuda_stream,
        )
        _LIBRARY.check(rc, "route")
    return out


route_wave.launches = 0
