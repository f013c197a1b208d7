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
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from ..cuda_build import KernelLibrary

#: default upper bound of a slot's member range (no bound)
HI_DEFAULT = 2 ** 30
THREADS = 256


def _slot_table(valid, nid, feat, slot, lch, rch, lo, hi) -> torch.Tensor:
    """The (8, NW) int32 slot table the kernel reads, in the Pallas
    kernel's row order (valid, nid, feat, slot, lch, rch, lo, hi)."""
    return torch.stack([
        valid.to(torch.int32), nid.to(torch.int32),
        torch.clamp_min(feat.to(torch.int32), 0), slot.to(torch.int32),
        lch.to(torch.int32), rch.to(torch.int32), lo.to(torch.int32),
        hi.to(torch.int32),
    ]).contiguous()


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


def _bind(lib) -> None:
    lib.ytk_route.restype = ctypes.c_int
    lib.ytk_route.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "route.cu"),
    _bind,
)
#: compile csrc/route.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_count_lock = threading.Lock()


def route_wave(bins_t, pos, valid, nid, feat, slot, lch, rch, lo=None,
               hi=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """New (n,) int32 positions after one wave of splits.

    bins_t (F, n) u8|i32, pos (n,) i32; valid (NW,) bool and nid, feat,
    slot, lch, rch (NW,) int per slot; lo/hi optional per-slot member
    range (default 0 and 2^30). `out`, a contiguous (n,) int32 tensor on
    pos's device, receives the result and may be `pos` itself (the kernel
    reads a row's position before writing it)."""
    NW = nid.shape[0]
    if lo is None:
        lo = torch.zeros(NW, dtype=torch.int32, device=pos.device)
    if hi is None:
        hi = torch.full((NW,), HI_DEFAULT, dtype=torch.int32,
                        device=pos.device)
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
        new = route_wave_plain(bins_t, pos, valid, nid, feat, slot, lch, rch,
                               lo, hi)
        return new if out is None else out.copy_(new)
    tab = _slot_table(valid, nid, feat, slot, lch, rch, lo, hi)
    if tab.device != pos.device:
        raise ValueError("route_wave: slot tables must lie on pos's device")
    if out is None:
        out = torch.empty_like(pos)
    if n == 0:
        return out
    blocks = max(1, min(-(-n // THREADS), 65535 * 8))
    lib = _LIBRARY.load()
    with torch.cuda.device(pos.device):
        rc = lib.ytk_route(
            bins_t.element_size(), bins_t.data_ptr(), n, F, pos.data_ptr(),
            tab.data_ptr(), NW, out.data_ptr(), blocks, THREADS,
            torch.cuda.current_stream().cuda_stream,
        )
    _LIBRARY.check(rc, "route")
    with _count_lock:
        route_wave.launches += 1
    return out


route_wave.launches = 0
