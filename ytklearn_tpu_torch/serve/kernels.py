"""Fused serve-side GBDT inference: the heap layout and the heap-walk kernel.

  heap layout   every tree re-laid as a perfect heap (Tree.heap_arrays):
                slot p's children are 2p+1 / 2p+2, so the fixed-depth walk
                needs no child pointers and the leaf value lives in the
                last heap level only
  heap_walk     the CUDA kernel (csrc/heap_walk.cu), replacing the JAX
                package's Pallas body serve/kernels.py::_walk_block (float
                mode, fused_scores). One thread per row, trees folded in
                ascending order in f64: bit-identical to the stacked rung
                and to GBDTPredictor.batch_scores
  heap_walk_plain  the same function in plain PyTorch; the wrapper takes it
                only for tensors on the CPU

The kernel is built at first use with nvcc into csrc/build/ (cached by
source mtime, ytklearn_tpu_torch/cuda_build.py) and bound through ctypes.
A build or launch failure raises: nothing falls back to the plain version
on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..cuda_build import KernelLibrary, find_nvcc  # noqa: F401 (re-export)

#: heap layout is 2^(depth+1)-1 slots per tree; deeper ensembles refuse the
#: fused rung and serve on the stacked rung
HEAP_DEPTH_CAP = 10
#: serving features addressable by the packed node layout the binned rung
#: shares (12 bits of feature id)
FEAT_BITS = 12


# ---------------------------------------------------------------------------
# Heap-layout ensemble export
# ---------------------------------------------------------------------------


@dataclass
class HeapEnsemble:
    """Stacked kernel-layout node arrays for T trees (Tree.heap_arrays)."""

    feat: np.ndarray  # (T, H) int32 — serving column id per slot
    split: np.ndarray  # (T, H) float64 — +inf on pad slots (always left)
    dleft: np.ndarray  # (T, H) int32 — missing-value default direction
    inner: np.ndarray  # (T, H) bool — real split nodes (pads excluded)
    leaf: np.ndarray  # (T, LL) float64 — last-level leaf values (-0.0 pads)
    depth: int
    n_trees: int  # real tree count; rows past it are -0.0 pad trees

    @property
    def heap(self) -> int:
        return self.feat.shape[1]

    @property
    def last(self) -> int:
        return self.leaf.shape[1]


def build_heap(
    trees, vocab: Dict[str, int], depth_cap: int = HEAP_DEPTH_CAP,
    pad_trees_to: int = 8,
) -> Tuple[Optional[HeapEnsemble], str]:
    """Stack every tree's heap arrays; (None, reason) when the ensemble
    cannot take the kernel layout (too deep, too many features, no
    features at all) — the scorer serves on the stacked rung then."""
    if not trees:
        return None, "empty ensemble"
    if not vocab:
        return None, "no split features (leaf-only ensemble)"
    if len(vocab) > (1 << FEAT_BITS) - 1:
        return None, f"{len(vocab)} features > packed-node limit"
    depth = max(max(t.max_depth() for t in trees), 1)
    if depth > depth_cap:
        return None, f"ensemble depth {depth} > heap cap {depth_cap}"
    T = len(trees)
    Tp = -(-T // pad_trees_to) * pad_trees_to
    H = (1 << (depth + 1)) - 1
    LL = 1 << depth
    feat = np.zeros((Tp, H), np.int32)
    split = np.full((Tp, H), np.inf, np.float64)
    dleft = np.ones((Tp, H), np.int32)
    inner = np.zeros((Tp, H), bool)
    # -0.0 pad values: x + (-0.0) == x for EVERY x (x + 0.0 flips -0.0),
    # so the pad trees keep the fold bit-exact
    leaf = np.full((Tp, LL), -0.0, np.float64)
    for ti, t in enumerate(trees):
        ids = [
            vocab[t.feat_name[nid]] if not t.is_leaf(nid) else -1
            for nid in range(t.n_nodes())
        ]
        arrs = t.heap_arrays(depth, feat_ids=ids)
        feat[ti] = arrs["feat"]
        split[ti] = arrs["split"]
        dleft[ti] = arrs["dleft"]
        inner[ti] = arrs["inner"]
        leaf[ti] = arrs["leaf"]
    return HeapEnsemble(feat, split, dleft, inner, leaf, depth, T), ""


@dataclass
class HeapTensors:
    """A HeapEnsemble's walk arrays as tensors on one device."""

    feat: torch.Tensor  # (T, H) int32
    split: torch.Tensor  # (T, H) float64
    dleft: torch.Tensor  # (T, H) int32
    leaf: torch.Tensor  # (T, LL) float64
    depth: int
    n_trees: int
    max_feat: int  # largest feat id, read on the host when built; -1 if T == 0


def heap_from_numpy(feat, split, dleft, leaf, depth: int, n_trees: int,
                    device) -> HeapTensors:
    """numpy heap arrays (this package's HeapEnsemble or the JAX package's,
    field for field) -> contiguous tensors on `device`. Checks the layout
    the kernel assumes, so a malformed table fails here and not on the
    card."""
    feat = np.asarray(feat)
    split = np.asarray(split)
    dleft = np.asarray(dleft)
    leaf = np.asarray(leaf)
    if not 1 <= depth <= HEAP_DEPTH_CAP:
        raise ValueError(f"heap depth {depth} outside [1, {HEAP_DEPTH_CAP}]")
    T, H = feat.shape
    if H != (1 << (depth + 1)) - 1 or leaf.shape != (T, 1 << depth):
        raise ValueError(
            f"heap shapes feat {feat.shape} / leaf {leaf.shape} do not "
            f"match depth {depth}"
        )
    if split.shape != (T, H) or dleft.shape != (T, H):
        raise ValueError("split/dleft must have feat's (T, H) shape")
    if not 0 <= n_trees <= T:
        raise ValueError(f"n_trees {n_trees} outside [0, {T}]")
    if T and (feat.min() < 0 or feat.max() > (1 << FEAT_BITS) - 2):
        raise ValueError("feat ids must lie in [0, 4094]")

    def put(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return HeapTensors(
        feat=put(feat, np.int32), split=put(split, np.float64),
        dleft=put(dleft, np.int32), leaf=put(leaf, np.float64),
        depth=int(depth), n_trees=int(n_trees),
        max_feat=int(feat.max()) if T else -1,
    )


# ---------------------------------------------------------------------------
# The walk: plain version and kernel wrapper
# ---------------------------------------------------------------------------


def heap_walk_plain(X, feat, split, dleft, leaf, depth: int) -> torch.Tensor:
    """(B,) raw ensemble sums (no base, no RF divide) from rows X (B, F)
    f64, NaN = missing. Every tree walks at once over (B, T) positions; the
    sum is then a strict tree-ascending left fold from +0.0, the kernel's
    order (a torch.sum would reassociate)."""
    B = X.shape[0]
    T = feat.shape[0]
    LL = leaf.shape[1]
    rows = torch.arange(B, device=X.device)[:, None]
    tids = torch.arange(T, device=X.device)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=X.device)
    for _ in range(depth):
        v = X[rows, feat[tids, pos].long()]
        go_left = torch.where(
            torch.isnan(v), dleft[tids, pos] > 0, v <= split[tids, pos]
        )
        pos = 2 * pos + 2 - go_left.long()
    contrib = leaf[tids, pos - (LL - 1)]  # (B, T)
    acc = torch.zeros(B, dtype=leaf.dtype, device=X.device)
    for t in range(T):
        acc = acc + contrib[:, t]
    return acc


_count_lock = threading.Lock()


def heap_walk(X, feat, split, dleft, leaf, depth: int,
              max_feat: Optional[int] = None) -> torch.Tensor:
    """heap_walk_plain's function. On CPU tensors it is the plain version;
    on CUDA tensors it launches csrc/heap_walk.cu on the current stream
    (building it at first use) or raises. `heap_walk.launches` counts the
    kernel launches.

    Every feat id must index a column of X: the kernel does not bound its
    reads. `max_feat` is the largest id (HeapTensors.max_feat); without it
    the ids are read back from the device, a synchronising check."""
    B, F = X.shape
    T, H = feat.shape
    if max_feat is None and T:
        lo, hi = (int(v) for v in torch.aminmax(feat))
        if lo < 0:
            raise ValueError(f"heap_walk: feat id {lo} < 0")
        max_feat = hi
    if max_feat is not None and max_feat >= F:
        raise ValueError(
            f"heap_walk: feat id {max_feat} indexes past X's {F} columns"
        )
    if X.device.type == "cpu":
        return heap_walk_plain(X, feat, split, dleft, leaf, depth)
    LL = leaf.shape[1]
    if not 1 <= depth <= HEAP_DEPTH_CAP or H != (1 << (depth + 1)) - 1 \
            or LL != 1 << depth:
        raise ValueError(f"heap shapes (T={T}, H={H}, LL={LL}) do not "
                         f"match depth {depth}")
    for name, t, dtype, shape in (
        ("X", X, torch.float64, (B, F)),
        ("feat", feat, torch.int32, (T, H)),
        ("split", split, torch.float64, (T, H)),
        ("dleft", dleft, torch.int32, (T, H)),
        ("leaf", leaf, torch.float64, (T, LL)),
    ):
        if t.device != X.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"heap_walk: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {X.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    out = torch.empty(B, dtype=torch.float64, device=X.device)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(X.device):
        rc = lib.ytk_heap_walk_f64(
            X.data_ptr(), B, F, feat.data_ptr(), split.data_ptr(),
            dleft.data_ptr(), leaf.data_ptr(), T, depth, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _LIBRARY.check(rc, "heap_walk")
    with _count_lock:
        heap_walk.launches += 1
    return out


heap_walk.launches = 0


# ---------------------------------------------------------------------------
# Kernel build: nvcc -> shared library with a C interface, loaded by ctypes
# ---------------------------------------------------------------------------


def _bind(lib) -> None:
    lib.ytk_heap_walk_f64.restype = ctypes.c_int
    lib.ytk_heap_walk_f64.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "heap_walk.cu"),
    _bind,
)
#: compile csrc/heap_walk.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_load = _LIBRARY.load
