"""Fused serve-side GBDT inference: the heap layout, the bin tables and the
two walk kernels.

  heap layout   every tree re-laid as a perfect heap (Tree.heap_arrays):
                slot p's children are 2p+1 / 2p+2, so the fixed-depth walk
                needs no child pointers and the leaf value lives in the
                last heap level only; node_records packs a slot's split,
                feat and dleft into one 16-byte record, K6's one node
                table (HeapTensors.nodes; unpack_records gives the three
                arrays back)
  heap_walk     the CUDA kernel K6 (csrc/heap_walk.cu), replacing the JAX
                package's Pallas body serve/kernels.py::_walk_block (float
                mode, fused_scores). A block stages a tile of rows in shared
                memory and walks (row, tree) pairs in parallel, a chunk of
                trees at a time; one thread a row folds the leaf values in
                ascending tree order in f64 (walk_plan picks the tile, the
                chunk and the threads; check_walk_plan checks a given
                plan): bit-identical to the stacked rung and to
                GBDTPredictor.batch_scores
  heap_walk_plain  the same function in plain PyTorch on the three arrays;
                the wrapper takes it, on the unpacked records, only for
                tensors on the CPU
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
  binned_walk   the binned walk, CUDA kernel K7 (csrc/heap_walk.cu, K6's
                template on bins and packed nodes), replacing the Pallas
                body's binned mode (binned_scores_pallas :439);
                binned_walk_plain is its plain version (the reference's
                make_binned_xla, :454)

The kernels are built at first use with nvcc into csrc/build/ (cached by
source mtime, ytklearn_tpu_torch/cuda_build.py) and bound through ctypes.
A build or launch failure raises: nothing falls back to the plain version
on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import os
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import knobs
from ..cuda_build import KernelLibrary, find_nvcc  # noqa: F401 (re-export)
from ..io.native import GXX_FLAGS, build_host_library

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
    """A HeapEnsemble's walk tables as tensors on one device: K6's node
    records and the leaf values (unpack_records gives the plain version
    its three arrays back)."""

    nodes: torch.Tensor  # (T, H, 2) int64: node_records
    leaf: torch.Tensor  # (T, LL) float64
    depth: int
    n_trees: int
    max_feat: int  # largest feat id, read on the host when built; -1 if T == 0


def node_records(feat, split, dleft) -> torch.Tensor:
    """(T, H, 2) int64 node records of K6, one 16-byte record a heap slot:
    the split's f64 bits, then feat in the low and dleft in the high 32
    bits of the second word (little-endian: split f64, feat i32, dleft i32,
    the kernel's int4 load). Built on the three (T, H) tensors' device."""
    rec = torch.empty(tuple(feat.shape) + (2,), dtype=torch.int64,
                      device=feat.device)
    rec[..., 0] = split.to(torch.float64).contiguous().view(torch.int64)
    rec[..., 1] = (feat.long() & 0xFFFFFFFF) | (dleft.long() << 32)
    return rec


def unpack_records(nodes: torch.Tensor):
    """node_records' inverse: (feat int32, split float64, dleft int32),
    each (T, H) and contiguous, on the records' device."""
    return (nodes[..., 1].to(torch.int32),
            nodes[..., 0].contiguous().view(torch.float64),
            (nodes[..., 1] >> 32).to(torch.int32))


def heap_from_numpy(feat, split, dleft, leaf, depth: int, n_trees: int,
                    device) -> HeapTensors:
    """numpy heap arrays (this package's HeapEnsemble or the JAX package's,
    field for field) -> K6's node records and the leaf values, contiguous
    on `device`. Checks the layout the kernel assumes, so a malformed table
    fails here and not on the card."""
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
        return torch.from_numpy(np.ascontiguousarray(a, dtype))

    nodes = node_records(put(feat, np.int32), put(split, np.float64),
                         put(dleft, np.int32))
    return HeapTensors(
        nodes=nodes.to(device), leaf=put(leaf, np.float64).to(device),
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
    nearest-representative rule, in f64. The native entry
    (`ytk_serve_bin_*`, the reference's bin_rows,
    ytklearn_tpu/serve/kernels.py:262-286) runs the same f64 comparisons;
    `bin_rows_plain` is its numpy version, taken under YTK_NO_NATIVE (read
    at every call) or when the library does not build. The two are
    bit-equal."""
    X = np.ascontiguousarray(X, np.float64)
    B, F = X.shape
    lib = _native()
    if lib is None or F != len(table.values):
        return bin_rows_plain(X, table)
    edges, offsets, counts = table.flat()
    out = np.empty((B, F), table.dtype)
    fn = (lib.ytk_serve_bin_u8 if table.dtype == np.uint8
          else lib.ytk_serve_bin_u16)
    nt = 1 if B < 64 else resolve_kernel_threads()
    fn(
        X.ctypes.data, B, F, edges.ctypes.data, offsets.ctypes.data,
        counts.ctypes.data, 0 if table.mode == "thresholds" else 1,
        table.sentinel, out.ctypes.data, nt,
    )
    return out


def bin_rows_plain(X: np.ndarray, table: BinTable) -> np.ndarray:
    """`bin_rows` as a numpy loop over features (the reference's
    searchsorted path, ytklearn_tpu/serve/kernels.py:287-303)."""
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


# ---------------------------------------------------------------------------
# The kernels' launch shape
# ---------------------------------------------------------------------------

#: an H100 block's dynamic shared memory (227 KB)
SMEM_MAX = 232448
#: threads a block at most, and walk chains in flight a thread (the
#: kernel's kUnroll)
WALK_MAX_THREADS = 1024
WALK_UNROLL = 4
#: rows a tile at most: one fold warp
WALK_MAX_ROWS = 32
#: trees a chunk at most: each chunk's walks wait on a chain of `depth`
#: node loads, so short chunks run slower (PERF.md, the design probes)
WALK_CHUNK_CAP = 512


def walk_smem(rows: int, chunk: int, F: int, bin_bytes: int) -> int:
    """Shared bytes of a walk block: two chunk x rows f64 buffers of leaf
    values, then the tile's rows of F elements (padded to 16 bytes)."""
    return 16 * chunk * rows + -(-rows * F * bin_bytes // 16) * 16


def _walk_args(B: int, T: int, depth: int, F: int, bin_bytes: int) -> None:
    if B < 0 or T < 0 or F < 1 or not 1 <= depth <= HEAP_DEPTH_CAP \
            or bin_bytes not in (1, 2, 8):
        raise ValueError(
            f"walk plan: B ({B}) and T ({T}) must be >= 0, F ({F}) >= 1, "
            f"depth ({depth}) in [1, {HEAP_DEPTH_CAP}] and bin_bytes "
            f"({bin_bytes}) 1, 2 or 8")


def _derived(rows: int, chunk: int, B: int, T: int, F: int,
             bin_bytes: int) -> dict:
    return {"fold": -(-rows // 32) * 32, "blocks": -(-B // rows),
            "n_chunks": -(-T // chunk),
            "smem": walk_smem(rows, chunk, F, bin_bytes)}


def walk_plan(B: int, T: int, depth: int, F: int, bin_bytes: int,
              sm_count: int) -> dict:
    """K6's (bin_bytes 8) or K7's (1, 2) launch shape for B rows of F
    elements over T trees of `depth` (pure integer arithmetic):

      rows      R rows a block: ceil(B / sm_count), so the row tiles
                cover the SMs at rung 512 (4 rows, 128 blocks) and each
                row of a smaller batch has a block of its own (rung 1: one
                block walks every tree), at most WALK_MAX_ROWS and as many
                as leave shared memory for a chunk
      chunk     C trees a chunk: every tree up to WALK_CHUNK_CAP, fewer
                where shared memory runs out
      threads   one fold warp a 32 rows, and a walk thread for each of
                the chunk's R x C pairs, within 1024 (past that a thread
                keeps up to WALK_UNROLL chains in flight)
      fold, blocks, n_chunks, smem   derived (check_walk_plan)"""
    _walk_args(B, T, depth, F, bin_bytes)
    if sm_count < 1:
        raise ValueError(f"walk plan: sm_count ({sm_count}) must be >= 1")
    rows = max(1, min(WALK_MAX_ROWS, -(-B // sm_count)))
    while rows > 1 and walk_smem(rows, 1, F, bin_bytes) > SMEM_MAX:
        rows -= 1
    room = (SMEM_MAX - walk_smem(rows, 0, F, bin_bytes)) // (16 * rows)
    chunk = max(1, min(T, WALK_CHUNK_CAP, room))
    fold = -(-rows // 32) * 32
    threads = fold + min(WALK_MAX_THREADS - fold, -(-rows * chunk // 32) * 32)
    return check_walk_plan({"rows": rows, "chunk": chunk, "threads": threads},
                           B, T, depth, F, bin_bytes)


def check_walk_plan(plan: dict, B: int, T: int, depth: int, F: int,
                    bin_bytes: int) -> dict:
    """Check a walk launch shape before any launch (pure integer checks):
    rows >= 1; chunk in [1, max(T, 1)]; threads a multiple of 32 within
    1024, with at least one walk warp beside the fold warps; the grid of
    row tiles within an int32; shared memory within SMEM_MAX. Derived keys
    a plan gives (fold, blocks, n_chunks, smem) must match. Returns the
    plan with every key; raises ValueError naming what fails."""
    _walk_args(B, T, depth, F, bin_bytes)
    rows, chunk, threads = (int(plan[k]) for k in ("rows", "chunk",
                                                    "threads"))
    if rows < 1 or not 1 <= chunk <= max(T, 1):
        raise ValueError(f"walk plan: rows ({rows}) must be >= 1 and chunk "
                         f"({chunk}) in [1, {max(T, 1)}]")
    out = {"rows": rows, "chunk": chunk, "threads": threads,
           **_derived(rows, chunk, B, T, F, bin_bytes)}
    if threads % 32 or not out["fold"] + 32 <= threads <= WALK_MAX_THREADS:
        raise ValueError(f"walk plan: threads ({threads}) must be a multiple "
                         f"of 32 in [{out['fold'] + 32}, {WALK_MAX_THREADS}]"
                         f" ({out['fold']} fold threads and a walk warp)")
    if out["blocks"] > 2 ** 31 - 1 or rows * F * bin_bytes > 2 ** 31 - 1:
        raise ValueError(f"walk plan: {out['blocks']} tiles of {rows} rows "
                         "pass the grid's int32")
    if out["smem"] > SMEM_MAX:
        raise ValueError(f"walk plan: {rows} rows of {F} x {bin_bytes} bytes "
                         f"and two {chunk}-tree buffers need {out['smem']} "
                         f"bytes of shared memory, more than {SMEM_MAX}")
    for k, v in out.items():
        if k in plan and int(plan[k]) != v:
            raise ValueError(f"walk plan: {k} ({plan[k]}) must be {v}")
    return out


@functools.lru_cache(maxsize=1024)
def _default_plan(B: int, T: int, depth: int, F: int, bin_bytes: int,
                  device_index: int) -> dict:
    """walk_plan's launch shape on a card, cached: a server asks for the
    few shapes of its ladder on every call, and the planner's Python is a
    share of a call's host time. Read-only (the wrappers never change
    it)."""
    sm = torch.cuda.get_device_properties(device_index).multi_processor_count
    return walk_plan(B, T, depth, F, bin_bytes, sm)


_count_lock = threading.Lock()


def heap_walk(X, nodes, leaf, depth: int, max_feat: Optional[int] = None,
              *, plan: Optional[dict] = None) -> torch.Tensor:
    """heap_walk_plain's function on node records (HeapTensors.nodes). On
    CPU tensors it is the plain version, on the unpacked records; on CUDA
    tensors it launches K6 (csrc/heap_walk.cu) on the current stream
    (building it at first use) or raises. `heap_walk.launches` counts the
    kernel launches.

    Every feat id must index a column of X: the kernel does not bound its
    reads. `max_feat` is the largest id (HeapTensors.max_feat); without it
    the ids are read back from the device, a synchronising check. `plan`:
    a launch shape for check_walk_plan (tests and tools; walk_plan's by
    default), checked on the CPU too."""
    B, F = X.shape
    T, H = nodes.shape[:2]
    if max_feat is None and T:
        lo, hi = (int(v) for v in torch.aminmax(unpack_records(nodes)[0]))
        if lo < 0:
            raise ValueError(f"heap_walk: feat id {lo} < 0")
        max_feat = hi
    if max_feat is not None and max_feat >= F:
        raise ValueError(
            f"heap_walk: feat id {max_feat} indexes past X's {F} columns"
        )
    if plan is not None:
        plan = check_walk_plan(plan, B, T, depth, F, 8)
    if X.device.type == "cpu":
        return heap_walk_plain(X, *unpack_records(nodes), leaf, depth)
    LL = leaf.shape[1]
    if not 1 <= depth <= HEAP_DEPTH_CAP or H != (1 << (depth + 1)) - 1 \
            or LL != 1 << depth:
        raise ValueError(f"heap shapes (T={T}, H={H}, LL={LL}) do not "
                         f"match depth {depth}")
    for name, t, dtype, shape in (
        ("X", X, torch.float64, (B, F)),
        ("nodes", nodes, torch.int64, (T, H, 2)),
        ("leaf", leaf, torch.float64, (T, LL)),
    ):
        if t.device != X.device or t.dtype != dtype \
                or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"heap_walk: {name} must be a contiguous {dtype} {shape} "
                f"tensor on {X.device}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device}"
            )
    if nodes.data_ptr() % 16:
        raise ValueError("heap_walk: nodes (node_records) must be 16-byte "
                         "aligned: the kernel loads a record as one int4")
    out = torch.empty(B, dtype=torch.float64, device=X.device)
    if B == 0:
        return out
    if plan is None:
        plan = _default_plan(B, T, depth, F, 8, X.device.index)
    lib = _load()
    with torch.cuda.device(X.device):
        rc = lib.ytk_heap_walk_f64(
            X.data_ptr(), B, F, nodes.data_ptr(), leaf.data_ptr(), T, depth,
            plan["rows"], plan["chunk"], plan["threads"], out.data_ptr(),
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
                max_feat: Optional[int] = None, *,
                plan: Optional[dict] = None) -> torch.Tensor:
    """binned_walk_plain's function. On CPU tensors it is the plain
    version; on CUDA tensors it launches K7 (csrc/heap_walk.cu) on the
    current stream (building it at first use) or raises.
    `binned_walk.launches` counts the kernel launches.

    bins (B, F) uint8 (sentinel 255) or uint16 (sentinel 65535); every
    packed feat id must index a column of bins. `max_feat` is the largest
    id; without it the ids are read back from the device (a sync). `plan`:
    a launch shape for check_walk_plan (walk_plan's by default), checked
    on the CPU too."""
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
    if plan is not None:
        plan = check_walk_plan(plan, B, T, depth, F, bins.element_size())
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
    if plan is None:
        plan = _default_plan(B, T, depth, F, bins.element_size(),
                             bins.device.index)
    lib = _load()
    with torch.cuda.device(bins.device):
        rc = lib.ytk_binned_walk(
            bins.element_size(), bins.data_ptr(), B, F, packed.data_ptr(),
            leaf.data_ptr(), T, depth, sentinel, plan["rows"], plan["chunk"],
            plan["threads"], out.data_ptr(),
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
    ci, vp = ctypes.c_int, ctypes.c_void_p
    lib.ytk_heap_walk_f64.restype = ci
    lib.ytk_heap_walk_f64.argtypes = [vp, ci, ci, vp, vp, ci, ci, ci, ci, ci,
                                      vp, vp]
    lib.ytk_binned_walk.restype = ci
    lib.ytk_binned_walk.argtypes = [ci, vp, ci, ci, vp, vp, ci, ci, ci, ci,
                                    ci, ci, vp, vp]


_LIBRARY = KernelLibrary(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                 "heap_walk.cu"),
    _bind,
)
#: compile csrc/heap_walk.cu now: {cmd, seconds, log}; raises on failure
build_kernel = _LIBRARY.build
_load = _LIBRARY.load


# ---------------------------------------------------------------------------
# The native serve library (csrc/ytk_serve.cpp, a copy of the reference's
# native/ytk_serve.cpp): host binning for both binned rungs and the CPU
# binned walk. Built with g++ at first use into csrc/build/, cached by
# source mtime, the io/native.py idiom. It is a host library and reaches
# no GPU.
# ---------------------------------------------------------------------------

_SERVE_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                          "ytk_serve.cpp")
_SERVE_SO = os.path.join(os.path.dirname(_SERVE_SRC), "build",
                         "libytk_serve.so")

_native_lock = threading.Lock()
_native_lib = None
_native_failed = False


def _build_native() -> bool:
    """OpenMP first (row-parallel), then without (the pragma is ignored:
    one thread, the same results)."""
    return build_host_library(_SERVE_SRC, _SERVE_SO,
                              [("-fopenmp", *GXX_FLAGS), GXX_FLAGS])


def _load_native():
    """The loaded library, built first when missing or stale; None when the
    build or the load failed (remembered: no second compile)."""
    global _native_lib, _native_failed
    with _native_lock:
        if _native_lib is not None or _native_failed:
            return _native_lib
        try:
            stale = (not os.path.exists(_SERVE_SO)
                     or os.path.getmtime(_SERVE_SO)
                     < os.path.getmtime(_SERVE_SRC))
        except OSError:
            stale = True
        if stale and not _build_native():
            _native_failed = True
            return None
        try:
            lib = ctypes.CDLL(_SERVE_SO)
        except OSError as e:
            log.warning("native serve library load failed: %s", e)
            _native_failed = True
            return None
        for name in ("ytk_serve_score_u8", "ytk_serve_score_u16"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32,
            ]
        for name in ("ytk_serve_bin_u8", "ytk_serve_bin_u16"):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_void_p,
                ctypes.c_int32,
            ]
        _native_lib = lib
        return _native_lib


def _native():
    """The library for this call: None under YTK_NO_NATIVE (read at every
    call, unlike the reference, which latches its first answer) or when
    it does not build."""
    if knobs.get_bool("YTK_NO_NATIVE"):
        return None
    return _load_native()


def native_serve_available() -> bool:
    """The library builds and loads, and YTK_NO_NATIVE is off now."""
    return _native() is not None


def resolve_kernel_threads() -> int:
    """YTK_SERVE_KERNEL_THREADS, or min(8, cores): rows parallelize
    embarrassingly, but a serving box shares its cores with the batcher
    and HTTP threads, so the default stays bounded."""
    n = knobs.get_int("YTK_SERVE_KERNEL_THREADS") or 0
    if n > 0:
        return n
    return max(1, min(8, os.cpu_count() or 1))


def native_binned_scores(
    bins: np.ndarray, packed: np.ndarray, leaf: np.ndarray, depth: int,
    sentinel: int, n_threads: int,
) -> np.ndarray:
    """(B,) raw f64 ensemble sums from (B, F) u8/u16 bins on the host (the
    reference's native_binned_scores, ytklearn_tpu/serve/kernels.py:
    600-625): the per-row fold is ascending trees in f64, as
    binned_walk's, so the two are bit-equal on the same bins."""
    lib = _native()
    if lib is None:
        raise RuntimeError("native serve library unavailable")
    if bins.dtype not in (np.uint8, np.uint16):
        raise TypeError(f"bins dtype {bins.dtype} not u8/u16")
    bins = np.ascontiguousarray(bins)
    packed = np.ascontiguousarray(packed, np.int32)
    leaf = np.ascontiguousarray(leaf, np.float64)
    B, F = bins.shape
    T, H = packed.shape
    LL = leaf.shape[1]
    # the walk indexes rows by the packed feat ids and leaves by the heap
    # slots: check both before passing pointers
    if leaf.shape[0] != T or H != 2 * LL - 1 or (1 << depth) != LL:
        raise ValueError(f"packed {packed.shape}, leaf {leaf.shape} and "
                         f"depth {depth} are not one heap layout")
    if T and int((packed & ((1 << FEAT_BITS) - 1)).max()) >= F:
        raise ValueError(f"a packed feature id is past the {F} bin columns")
    out = np.zeros((B,), np.float64)
    fn = (lib.ytk_serve_score_u8 if bins.dtype == np.uint8
          else lib.ytk_serve_score_u16)
    nt = 1 if B < 64 else n_threads
    fn(
        bins.ctypes.data, B, F, packed.ctypes.data, leaf.ctypes.data,
        T, H, LL, depth, sentinel, out.ctypes.data, nt,
    )
    return out
