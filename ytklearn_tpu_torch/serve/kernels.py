"""Fused serve-side GBDT inference: the heap layout, the bin tables and the
two walk kernels.

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
  bin tables    BinTable: per-feature sorted edge values, the dumped
                training representatives (`<model>.bins.json`, mode
                "edges") or the ensemble's own split values (mode
                "thresholds"); `bin_rows` bins a request batch once on the
                host (uint8/uint16, missing = sentinel) and
                `pack_heap_nodes` folds each heap slot into one int32 (feat
                12 bits | rank+1 16 bits | default_left 1 bit). In
                thresholds mode `bin < rank+1` is exactly `value <= split`;
                in edges mode the compare reproduces the training bins'
                nearest-representative routing (ytklearn_tpu/serve/
                kernels.py:191-336, field for field)
  binned_walk   the binned walk, CUDA kernel K7 (csrc/heap_walk.cu),
                replacing the Pallas body's binned mode (binned_scores_pallas
                :439); binned_walk_plain is its plain version (the
                reference's make_binned_xla, :454)

The kernels are built at first use with nvcc into csrc/build/ (cached by
source mtime, ytklearn_tpu_torch/cuda_build.py) and bound through ctypes.
A build or launch failure raises: nothing falls back to the plain version
on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..cuda_build import KernelLibrary, find_nvcc  # noqa: F401 (re-export)

log = logging.getLogger(__name__)

#: heap layout is 2^(depth+1)-1 slots per tree; deeper ensembles refuse the
#: fused rung and serve on the stacked rung
HEAP_DEPTH_CAP = 10
#: packed-node field widths of the binned walk
FEAT_BITS = 12  # <= 4095 distinct serving features
RANK_BITS = 16  # <= 65534 edges per feature (uint16 bins)

_U8_SENTINEL = 0xFF
_U16_SENTINEL = 0xFFFF


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
# Bin tables: dumped training edges, or thresholds derived from the model
# ---------------------------------------------------------------------------


@dataclass
class BinTable:
    """Per-feature sorted edge values and the serve-side binning rule.

    mode "edges": values are the dumped training representatives; rows bin
    by the training matrix's nearest-representative rule (in f64), and a
    node's rank+1 = #edges <= split. Boundary ties round up as in
    training; off-boundary rows route as the float compare does.

    mode "thresholds": values are the ensemble's own distinct split values
    per feature; bin = #thresholds < value, rank+1 = index(split)+1, and
    `bin < rank+1` IS `value <= split`, bit-identical everywhere."""

    values: List[np.ndarray]  # per serving column, ascending f64
    mode: str  # "edges" | "thresholds"
    dtype: np.dtype
    sentinel: int

    def flat(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(edges, offsets, counts): the tables concatenated (cached; the
        values are immutable)."""
        out = getattr(self, "_flat", None)
        if out is None:
            counts = np.asarray([len(v) for v in self.values], np.int64)
            offsets = np.zeros(len(self.values), np.int64)
            if len(counts):
                offsets[1:] = np.cumsum(counts)[:-1]
            edges = (
                np.ascontiguousarray(np.concatenate(self.values))
                if len(self.values)
                else np.zeros(0, np.float64)
            )
            out = (edges, offsets, counts)
            self._flat = out
        return out


def build_bin_table(
    trees, vocab: Dict[str, int],
    edges_by_name: Optional[Dict[str, np.ndarray]] = None,
) -> Tuple[Optional[BinTable], str]:
    """BinTable for the serving columns, or (None, reason).

    A dumped sidecar is used only when it covers every split feature and
    every split value lies inside its feature's edge range; a stale one
    falls back to ensemble-derived thresholds with a warning."""
    F = len(vocab)
    splits_per_col: List[set] = [set() for _ in range(F)]
    for t in trees:
        for nid in range(t.n_nodes()):
            if not t.is_leaf(nid):
                splits_per_col[vocab[t.feat_name[nid]]].add(
                    float(t.split[nid]))
    mode = "thresholds"
    values: List[np.ndarray] = []
    if edges_by_name is not None:
        by_col: List[Optional[np.ndarray]] = [None] * F
        ok = True
        for name, j in vocab.items():
            e = edges_by_name.get(name)
            if e is None or len(e) == 0:
                log.warning("bin-edges sidecar misses feature %r; deriving "
                            "thresholds from the ensemble instead", name)
                ok = False
                break
            e = np.unique(np.asarray(e, np.float64))
            if splits_per_col[j] and (min(splits_per_col[j]) < e[0]
                                      or max(splits_per_col[j]) > e[-1]):
                log.warning("bin-edges sidecar looks stale for feature %r "
                            "(split outside the edge range); deriving "
                            "thresholds from the ensemble instead", name)
                ok = False
                break
            by_col[j] = e
        if ok:
            values = list(by_col)
            mode = "edges"
    if mode == "thresholds":
        values = [
            np.asarray(sorted(s), np.float64) if s
            else np.zeros((1,), np.float64)
            for s in splits_per_col
        ]
    # +1 headroom: thresholds-mode bins range up to len(values[f])
    maxc = max((len(v) for v in values), default=1)
    if maxc + 1 >= _U16_SENTINEL:
        return None, f"{maxc} edges on one feature > uint16 bin budget"
    small = maxc + 1 < _U8_SENTINEL
    return BinTable(
        values=values, mode=mode,
        dtype=np.dtype(np.uint8 if small else np.uint16),
        sentinel=_U8_SENTINEL if small else _U16_SENTINEL,
    ), ""


def bin_rows(X: np.ndarray, table: BinTable) -> np.ndarray:
    """(B, F) raw f64 rows (NaN = missing) -> (B, F) bin indices in the
    table's dtype, binned once per batch on the host; missing values get
    the sentinel. Thresholds: bin = #edges < value. Edges: the training
    nearest-representative rule, in f64 (the reference's searchsorted
    path, ytklearn_tpu/serve/kernels.py:287-303)."""
    X = np.ascontiguousarray(X, np.float64)
    B, F = X.shape
    nan = np.isnan(X)
    out = np.empty((B, F), np.int64)
    for f in range(F):
        v = table.values[f]
        col = X[:, f]
        i = np.searchsorted(v, col, side="left")
        if table.mode == "edges":
            cnt = len(v)
            over = col > v[-1]
            i = np.clip(i, 0, cnt - 1)
            mids = 0.5 * (v[np.maximum(i - 1, 0)] + v[i])
            i = np.where((i >= 1) & (col < mids) & ~over, i - 1, i)
            i = np.where(over, cnt - 1, i)
        out[:, f] = i
    out = out.astype(table.dtype)
    out[nan] = table.sentinel
    return np.ascontiguousarray(out)


def pack_heap_nodes(heap: HeapEnsemble, table: BinTable) -> np.ndarray:
    """(T, H) int32 packed node records of the binned walk: feat (12 bits)
    | rank+1 (16 bits) | default_left (1 bit). go_left iff bin < rank+1
    (0 = always right); pad slots get the all-ones rank, so every
    non-missing row keeps descending left."""
    rank1 = np.full(heap.feat.shape, (1 << RANK_BITS) - 1, np.int64)
    side = "right" if table.mode == "edges" else "left"
    for f, v in enumerate(table.values):
        m = heap.inner & (heap.feat == f)
        if not m.any():
            continue
        r = np.searchsorted(v, heap.split[m], side=side)
        if table.mode == "thresholds":
            r = r + 1  # bin < idx+1  <=>  #{th < v} <= idx  <=>  v <= split
        rank1[m] = r
    packed = (
        heap.feat.astype(np.int64)
        | (rank1 << FEAT_BITS)
        | (heap.dleft.astype(np.int64) << (FEAT_BITS + RANK_BITS))
    )
    return packed.astype(np.int32)


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


def unpack_nodes(packed: torch.Tensor):
    """(feat, rank1, dleft) int64 fields of packed node words."""
    pk = packed.long()
    return (pk & ((1 << FEAT_BITS) - 1),
            (pk >> FEAT_BITS) & ((1 << RANK_BITS) - 1),
            (pk >> (FEAT_BITS + RANK_BITS)) & 1)


def binned_walk_plain(bins, packed, leaf, depth: int, sentinel: int
                      ) -> torch.Tensor:
    """(B,) raw ensemble sums from binned rows bins (B, F) u8|u16 and
    packed nodes (T, H) i32: a loop over depth of gathers on (B, T)
    positions, then a strict tree-ascending left fold from +0.0 in f64
    (the reference's make_binned_xla)."""
    B = bins.shape[0]
    T = packed.shape[0]
    LL = leaf.shape[1]
    dev = bins.device
    bw = bins.long()
    rows = torch.arange(B, device=dev)[:, None]
    tids = torch.arange(T, device=dev)[None, :]
    pos = torch.zeros((B, T), dtype=torch.long, device=dev)
    for _ in range(depth):
        fv, rank1, dl = unpack_nodes(packed[tids, pos])
        vv = bw[rows, fv]
        go_left = torch.where(vv == sentinel, dl > 0, vv < rank1)
        pos = 2 * pos + 2 - go_left.long()
    contrib = leaf[tids, pos - (LL - 1)]  # (B, T)
    acc = torch.zeros(B, dtype=leaf.dtype, device=dev)
    for t in range(T):
        acc = acc + contrib[:, t]
    return acc


_BIN_DTYPES = {torch.uint8: _U8_SENTINEL, torch.uint16: _U16_SENTINEL}


def binned_walk(bins, packed, leaf, depth: int, sentinel: int,
                max_feat: Optional[int] = None) -> torch.Tensor:
    """binned_walk_plain's function. On CPU tensors it is the plain
    version; on CUDA tensors it launches K7 (csrc/heap_walk.cu) on the
    current stream (building it at first use) or raises.
    `binned_walk.launches` counts the kernel launches.

    bins (B, F) uint8 (sentinel 255) or uint16 (sentinel 65535); every
    packed feat id must index a column of bins. `max_feat` is the largest
    id; without it the ids are read back from the device (a sync)."""
    B, F = bins.shape
    T, H = packed.shape
    if max_feat is None and T:
        max_feat = int(unpack_nodes(packed)[0].max())
    if max_feat is not None and max_feat >= F:
        raise ValueError(
            f"binned_walk: feat id {max_feat} indexes past the {F} bin "
            "columns"
        )
    if bins.dtype not in _BIN_DTYPES or sentinel != _BIN_DTYPES[bins.dtype]:
        raise ValueError(
            f"binned_walk: bins must be uint8 (sentinel 255) or uint16 "
            f"(sentinel 65535), got {bins.dtype} with sentinel {sentinel}"
        )
    if bins.device.type == "cpu":
        return binned_walk_plain(bins, packed, leaf, depth, sentinel)
    LL = leaf.shape[1]
    if not 1 <= depth <= HEAP_DEPTH_CAP or H != (1 << (depth + 1)) - 1 \
            or LL != 1 << depth:
        raise ValueError(f"heap shapes (T={T}, H={H}, LL={LL}) do not "
                         f"match depth {depth}")
    for name, t, dtype, shape in (
        ("bins", bins, bins.dtype, (B, F)),
        ("packed", packed, torch.int32, (T, H)),
        ("leaf", leaf, torch.float64, (T, LL)),
    ):
        if t.device != bins.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"binned_walk: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {bins.device}, got {t.dtype} {tuple(t.shape)} "
                f"on {t.device}"
            )
    out = torch.empty(B, dtype=torch.float64, device=bins.device)
    if B == 0:
        return out
    lib = _load()
    with torch.cuda.device(bins.device):
        rc = lib.ytk_binned_walk(
            bins.element_size(), bins.data_ptr(), B, F, packed.data_ptr(),
            leaf.data_ptr(), T, depth, sentinel, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _LIBRARY.check(rc, "binned_walk")
    with _count_lock:
        binned_walk.launches += 1
    return out


binned_walk.launches = 0


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
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.ytk_binned_walk.restype = ci
    lib.ytk_binned_walk.argtypes = [ci, vp, ci, ci, vp, vp, ci, ci, ci, vp,
                                    vp]


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "heap_walk.cu"),
    _bind,
)
#: compile csrc/heap_walk.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_load = _LIBRARY.load
