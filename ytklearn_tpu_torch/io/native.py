"""ctypes bindings for the native C++ ingest parser (``io/csrc/ytk_parse.cpp``).

The counterpart of ``ytklearn_tpu/io/native.py``. The shared library is
compiled on the host at first use with

    g++ -O3 -std=c++17 -shared -fPIC -pthread -march=native ytk_parse.cpp

into ``io/csrc/build/libytk_parse.so`` (gitignored), rebuilt when it is
missing or older than its source. Each builder compiles to a pid-suffixed
temp file and promotes it with ``os.replace``, so concurrent first uses
(parallel test workers, several processes on one machine) never load a
torn library.

Callers ask `use_native(delim)` at every dispatch: the ``YTK_NO_NATIVE``
knob is read there each time (the JAX package reads it once, at its first
load, and keeps that answer for the process), then the delimiters
(`supports_delims`), then the library. When g++ is missing or the build
fails, the ingest falls back to the Python parser and logs it; the native
path gives the same rows, errors and first-seen feature-name order, with
values parsed as float32 (the Python path parses float64).

The parse is the reference's reader-thread parallelism (dataflow/
DataFlow.java:483-534, per-thread CoreData.readData): std::thread workers
over row ranges of one byte buffer, merged into numpy columnar arrays.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Sequence

import numpy as np

from ..config import knobs

log = logging.getLogger(__name__)

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                    "ytk_parse.cpp")
_SO = os.path.join(os.path.dirname(_SRC), "build", "libytk_parse.so")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
             "-march=native")

_lock = threading.Lock()
_lib = None
_build_failed = False


def build_host_library(src: str, so: str,
                       flag_sets: Sequence[Sequence[str]]) -> bool:
    """Compile `src` with g++ into `so`, trying each flag set in turn until
    one builds: into a pid-suffixed temp file, then promoted with
    `os.replace`, so a concurrent loader never sees a torn library."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    for flags in flag_sets:
        try:
            subprocess.run(["g++", *flags, src, "-o", tmp], check=True,
                           capture_output=True, timeout=120)
        except (subprocess.SubprocessError, OSError) as e:
            err = getattr(e, "stderr", b"")
            log.warning("g++ build of %s failed (%s): %s",
                        os.path.basename(src), e,
                        err.decode()[:500] if err else "")
            continue
        os.replace(tmp, so)
        return True
    if os.path.exists(tmp):
        os.unlink(tmp)
    return False


def open_host_library(src: str, so: str, build: Callable[[], bool]):
    """The library at `so` through ctypes, built first by `build()` when
    it is missing or older than `src`; None when the build or the load
    fails. A build is reported to the obs build watcher with its seconds,
    a load of a library built before as a load."""
    from ..obs import health

    try:
        stale = (not os.path.exists(so)
                 or os.path.getmtime(so) < os.path.getmtime(src))
    except OSError:
        stale = True
    name = os.path.basename(so)
    t0 = time.perf_counter()
    if stale:
        if not build():
            return None
        health.note_compile("build", name, time.perf_counter() - t0)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        log.warning("%s load failed: %s", name, e)
        return None
    if not stale:
        health.note_compile("load", name, time.perf_counter() - t0)
    return lib


def _build() -> bool:
    """Compile the parser; on failure the Python parser runs instead."""
    return build_host_library(_SRC, _SO, [GXX_FLAGS])


def _load():
    """The loaded library, built first when missing or stale; None when the
    build or the load failed (remembered: no second compile)."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        lib = open_host_library(_SRC, _SO, _build)
        if lib is None:
            _build_failed = True
            return None
        lib.ytk_parse.restype = ctypes.c_void_p
        lib.ytk_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64,
        ]
        for name in ("ytk_n_rows", "ytk_nnz", "ytk_n_label_vals",
                     "ytk_n_names", "ytk_name_bytes", "ytk_n_errors"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.ytk_fill.restype = None
        lib.ytk_fill.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7
        lib.ytk_free.restype = None
        lib.ytk_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """The library builds and loads, and YTK_NO_NATIVE is off now."""
    return not knobs.get_bool("YTK_NO_NATIVE") and _load() is not None


def use_native(delim, hook=None) -> bool:
    """Whether an ingest dispatch takes the native parser: no python line
    hook, delimiters it handles, YTK_NO_NATIVE off at this call, and the
    library available."""
    return (hook is None and supports_delims(delim)
            and native_available())


@dataclass
class ParsedBlock:
    """Columnar parse of a block of lines, rows in input-line order.
    `labels` is ragged through label_ptr (1 entry for scalar losses, K for
    an explicit multiclass vector); `feat_ids` index `names` (first-seen
    order across kept lines)."""

    weights: np.ndarray  # (n,) f32
    label_ptr: np.ndarray  # (n+1,) i64
    labels: np.ndarray  # (L,) f32
    row_ptr: np.ndarray  # (n+1,) i64
    feat_ids: np.ndarray  # (nnz,) i32 -> names
    feat_vals: np.ndarray  # (nnz,) f32
    names: List[str]
    n_errors: int

    @property
    def n(self) -> int:
        return len(self.weights)


def parse_block(data: bytes, x_delim: str = "###", y_delim: str = ",",
                features_delim: str = ",",
                feature_name_val_delim: str = ":", n_threads: int = 0,
                divisor: int = 1, remainder: int = 0) -> ParsedBlock:
    """Parse a byte buffer of ytklearn lines. divisor/remainder select the
    global line-modulo shard (line i is kept when i % divisor ==
    remainder)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser unavailable")
    if (len(y_delim) != 1 or len(features_delim) != 1
            or len(feature_name_val_delim) != 1):
        raise ValueError("native parser requires single-char "
                         "y/features/name-val delims")
    if n_threads <= 0:
        n_threads = min(os.cpu_count() or 1, 32)
    h = lib.ytk_parse(data, len(data), x_delim.encode(), y_delim.encode(),
                      features_delim.encode(),
                      feature_name_val_delim.encode(), n_threads, divisor,
                      remainder)
    try:
        n = lib.ytk_n_rows(h)
        nnz = lib.ytk_nnz(h)
        nbytes = lib.ytk_name_bytes(h)
        weights = np.empty(n, np.float32)
        label_ptr = np.empty(n + 1, np.int64)
        labels = np.empty(lib.ytk_n_label_vals(h), np.float32)
        row_ptr = np.empty(n + 1, np.int64)
        feat_ids = np.empty(nnz, np.int32)
        feat_vals = np.empty(nnz, np.float32)
        name_buf = ctypes.create_string_buffer(max(int(nbytes), 1))
        lib.ytk_fill(
            h, *(a.ctypes.data_as(ctypes.c_void_p) for a in (
                weights, label_ptr, labels, row_ptr, feat_ids, feat_vals)),
            ctypes.cast(name_buf, ctypes.c_void_p))
        names = (name_buf.raw[: int(nbytes)].decode("utf-8").split("\n")[:-1]
                 if lib.ytk_n_names(h) else [])
        return ParsedBlock(weights=weights, label_ptr=label_ptr,
                           labels=labels, row_ptr=row_ptr, feat_ids=feat_ids,
                           feat_vals=feat_vals, names=names,
                           n_errors=int(lib.ytk_n_errors(h)))
    finally:
        lib.ytk_free(h)


def parse_paths(fs, paths: Sequence[str], x_delim: str = "###",
                y_delim: str = ",", features_delim: str = ",",
                feature_name_val_delim: str = ":", n_threads: int = 0,
                divisor: int = 1, remainder: int = 0) -> ParsedBlock:
    """Parse files one at a time (sorted-path order) and merge: the same
    result as one parse_block over the newline-normalised concatenation,
    holding one file's bytes at a time. The line-modulo phase carries
    across files: file k starts at global line sum(lines of files < k)."""
    blocks: List[ParsedBlock] = []
    line0 = 0
    from ..resilience import chaos_point, retry_call

    for p in sorted(fs.recur_get_paths(paths)):
        # the `io.read` retry and chaos seam of read_lines: a transient
        # fault rereads this one file
        def read(path=p) -> bytes:
            chaos_point("io.read")
            with fs.open(path, "rb") as f:
                return f.read()

        b = retry_call(read, site="io.read")
        if not b:
            continue
        if not b.endswith(b"\n"):
            b += b"\n"
        rem = (remainder - line0) % divisor if divisor > 1 else 0
        blocks.append(parse_block(b, x_delim, y_delim, features_delim,
                                  feature_name_val_delim,
                                  n_threads=n_threads, divisor=divisor,
                                  remainder=rem))
        line0 += b.count(b"\n")
        del b
    return merge_blocks(blocks)


def merge_blocks(blocks: Sequence[ParsedBlock]) -> ParsedBlock:
    """Concatenate blocks row-wise, keeping the first-seen name order across
    blocks (block order = file order = line order)."""
    if not blocks:
        return ParsedBlock(
            weights=np.empty(0, np.float32), label_ptr=np.zeros(1, np.int64),
            labels=np.empty(0, np.float32), row_ptr=np.zeros(1, np.int64),
            feat_ids=np.empty(0, np.int32), feat_vals=np.empty(0, np.float32),
            names=[], n_errors=0)
    if len(blocks) == 1:
        return blocks[0]
    uniq: dict = {}
    remapped: List[np.ndarray] = []
    for blk in blocks:
        remap = np.asarray([uniq.setdefault(nm, len(uniq))
                            for nm in blk.names], np.int32)
        remapped.append(remap[blk.feat_ids] if len(blk.names)
                        else blk.feat_ids)
    label_ptr = [np.zeros(1, np.int64)]
    row_ptr = [np.zeros(1, np.int64)]
    loff = roff = 0
    for blk in blocks:
        label_ptr.append(blk.label_ptr[1:] + loff)
        row_ptr.append(blk.row_ptr[1:] + roff)
        loff += int(blk.label_ptr[-1])
        roff += int(blk.row_ptr[-1])
    return ParsedBlock(
        weights=np.concatenate([b.weights for b in blocks]),
        label_ptr=np.concatenate(label_ptr),
        labels=np.concatenate([b.labels for b in blocks]),
        row_ptr=np.concatenate(row_ptr),
        feat_ids=np.concatenate(remapped),
        feat_vals=np.concatenate([b.feat_vals for b in blocks]),
        names=list(uniq), n_errors=sum(b.n_errors for b in blocks))


def expand_labels_columnar(label_ptr: np.ndarray, labels: np.ndarray, n: int,
                           K: int):
    """The Python path's label expansion, vectorised: a width-K vector
    passes through; a width-1 label is an int()-truncated class index where
    a negative in-range value wraps (list indexing) and anything outside
    [-K, K-1] is an error line. Returns (bad (n,) bool, y): y is (n,) f32
    for K == 1 (the first label, extras ignored) or (n, K) f32 one-hot or
    verbatim, zero rows where bad."""
    firsts = labels[label_ptr[:-1]] if n else np.zeros(0, np.float32)
    if K == 1:
        return np.zeros(n, bool), firsts.astype(np.float32)
    widths = np.diff(label_ptr)
    bad = (widths != 1) & (widths != K)
    cls = np.trunc(firsts).astype(np.int64)
    is_cls = widths == 1
    bad |= is_cls & ((cls >= K) | (cls < -K))
    y = np.zeros((n, K), np.float32)
    fullm = ~bad & (widths == K)
    if fullm.any():
        src = label_ptr[:-1][fullm][:, None] + np.arange(K)
        y[fullm] = labels[src]
    onem = ~bad & is_cls
    if onem.any():
        ck = cls[onem]
        y[np.where(onem)[0], np.where(ck < 0, ck + K, ck)] = 1.0
    return bad, y


def supports_delims(delim) -> bool:
    """The C parser takes a multi-char x_delim but single-char y, features
    and name-value delims; other configs take the Python path."""
    return (len(delim.x_delim) >= 1 and len(delim.y_delim) == 1
            and len(delim.features_delim) == 1
            and len(delim.feature_name_val_delim) == 1)
