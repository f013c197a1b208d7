"""The text ingest (``ytklearn_tpu/io/reader.py``, reference
dataflow/CoreData.java and DataFlow.java).

  parse_line           `weight###label[,label...]###name:val,...` -> ParsedLine
  load_transform_hook  the user's python line-transform hook
  shard_plan           this process's read plan: (paths, divisor, remainder)
  shard_read_lines     this process's lines
  FeatureStat, TransformNode  feature statistics and their standardization
                       or range scaling (the sidecar's text format)
  SparseDataset        padded ELL rows: (n, width) feature indices and
                       values (and FFM's fields), labels and weights
  DataIngest           the convex families' loadFlow: lines -> parse ->
                       label expansion, hashing, y-sampling -> feature
                       dict (count filter, sorted names, bias at 0) or a
                       dict file -> transform stats and their sidecar ->
                       ELL arrays

`DataIngest.load` dispatches to `_load_fast`, the columnar pipeline over
the native C++ parser (io/native.py), unless a python transform hook is
set, a delimiter is one the parser does not take, or YTK_NO_NATIVE is on
at that call; `_load_python` is the Python parser's pipeline. Both give
the same rows, dict, labels and rng draws; the native parser reads values
as float32 (the Python one as float64), so transform stats and hashed
sums may differ in their last digits, as in the JAX package.

Under `--coordinator` each process reads its shard_plan: every line with
`data.assigned`, else every world-th file (files_avg) or line (lines_avg),
and the processes merge what the dict and the transform need through the
host gather (parallel/collectives.py::host_allgather_objects, the
`collective.host` seam and the census see each): the feature counts
(`_merge_counts`), the feature statistics (`nodes_from_stats`), and a
dict file read by process 0 alone (`load_feature_map`, after process 0
chose the dict's source in `_resolve_feature_map`: a branch chosen by
each process from its own view of the storage could leave process 0 in
one collective and its peers in another). Only process 0 writes the
transform sidecar.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Optional, \
    Sequence, Tuple

import numpy as np

from ..config.params import CommonParams, DelimParams
from ..obs import health, inc as obs_inc, span as obs_span
from . import native
from .feature_hash import FeatureHash
from .fs import LocalFileSystem

log = logging.getLogger("ytklearn_tpu_torch.ingest")


@dataclass
class ParsedLine:
    weight: float
    labels: List[float]  # 1 entry for scalar losses; K for multiclass
    feats: List[Tuple[str, float]]


def parse_line(line: str, delim: DelimParams) -> ParsedLine:
    """`weight###label[,label...]###name:val,name:val` (reference:
    CoreData.trainDataSplit/weightExtract/yExtract/line2FeatureMap). Raises
    ValueError or IndexError on a malformed line."""
    info = line.strip().split(delim.x_delim)
    weight = float(info[0])
    labels = [float(v) for v in info[1].split(delim.y_delim)]
    ftext = info[2].strip()
    pairs = [f.partition(delim.feature_name_val_delim)
             for f in ftext.split(delim.features_delim)] if ftext else []
    return ParsedLine(weight, labels,
                      [(name.strip(), float(val)) for name, _, val in pairs])


def load_transform_hook(path: str) -> Callable[[bytes], List[str]]:
    """Load the user data-transform hook: a python file defining
    `transform(line: bytes) -> list[str]` (the reference embeds Jython for
    this, dataflow/DataUtils.java:142, bin/transform.py)."""
    ns: Dict = {}
    with LocalFileSystem().open(path) as f:
        exec(compile(f.read(), path, "exec"), ns)
    if "transform" not in ns:
        raise ValueError(f"{path} does not define transform(bytearray) -> "
                         "[lines]")
    return ns["transform"]


def shard_plan(fs, data_params, paths) -> Tuple[Sequence[str], int, int]:
    """This process's read plan: (paths, divisor, remainder), the one
    source of the assigned / files_avg / lines_avg dispatch (reference
    :263-277, DataFlow.java:391-410) that the Python reader and the native
    parser both read through. One ingesting process (no mesh, or the
    shared ingest of `--devices`) or `data.assigned` reads everything;
    under `--coordinator` files_avg takes every world-th file of the
    sorted listing from its rank, lines_avg every world-th line."""
    from ..parallel.mesh import process_count, process_index

    n_proc = process_count()
    proc = process_index()
    if data_params.assigned or n_proc == 1:
        return paths, 1, 0
    if data_params.unassigned_mode == "files_avg":
        files = sorted(fs.recur_get_paths(paths))
        return files[proc::n_proc], 1, 0
    return paths, n_proc, proc


def shard_read_lines(fs, data_params, paths) -> Iterator[str]:
    """This process's lines (the plan of shard_plan)."""
    paths, divisor, remainder = shard_plan(fs, data_params, paths)
    if divisor == 1:
        return fs.read_lines(paths)
    return fs.select_read_lines(paths, divisor, remainder)


# -- feature statistics and transforms --------------------------------------


@dataclass
class FeatureStat:
    """Running (cnt, sum, sum2, min, max) (reference: CoreData.FeatureStat)."""

    cnt: int = 0
    sum: float = 0.0
    sum2: float = 0.0
    max: float = -math.inf
    min: float = math.inf

    def update(self, v: float) -> None:
        self.cnt += 1
        self.sum += v
        self.sum2 += v * v
        if v > self.max:
            self.max = v
        if v < self.min:
            self.min = v

    def merge(self, o: "FeatureStat") -> None:
        """Add another process's statistics of the same feature."""
        self.cnt += o.cnt
        self.sum += o.sum
        self.sum2 += o.sum2
        self.max = max(self.max, o.max)
        self.min = min(self.min, o.min)


@dataclass
class TransformNode:
    """Standardization or range scaling of one feature (reference:
    CoreData.TransformNode; the sidecar's text format)."""

    mode: str  # standardization | scale_range
    mean: float = 0.0
    stdvar: float = 0.0
    max: float = 0.0
    min: float = 0.0
    range_max: float = 1.0
    range_min: float = -1.0

    def transform(self, val: float) -> float:
        if self.mode == "standardization":
            if self.stdvar < 1e-6:
                return val
            return (val - self.mean) / self.stdvar
        if abs(self.max - self.min) < 1e-6:
            return 1.0
        return self.range_min + (self.range_max - self.range_min) * (
            (val - self.min) / (self.max - self.min))

    def __str__(self) -> str:  # a sidecar line's payload
        return (f"mode={self.mode}, mean={self.mean}, stdvar={self.stdvar}, "
                f"max={self.max}, min={self.min}, rangeMax={self.range_max}, "
                f"rangeMin={self.range_min}")

    @classmethod
    def from_string(cls, s: str) -> "TransformNode":
        info = [kv.split("=")[1].strip() for kv in s.split(",")]
        return cls(mode=info[0].lower(), mean=float(info[1]),
                   stdvar=float(info[2]), max=float(info[3]),
                   min=float(info[4]), range_max=float(info[5]),
                   range_min=float(info[6]))

    @classmethod
    def from_stat(cls, stat: FeatureStat, mode: str, range_max: float,
                  range_min: float) -> "TransformNode":
        mean = stat.sum / stat.cnt
        mean2 = stat.sum2 / stat.cnt
        return cls(mode=mode, mean=mean,
                   stdvar=math.sqrt(max(mean2 - mean * mean, 0.0)),
                   max=stat.max, min=stat.min, range_max=range_max,
                   range_min=range_min)


# -- the dataset ------------------------------------------------------------


@dataclass
class SparseDataset:
    """Padded ELL rows on the host: idx[i, j], val[i, j] hold row i's j-th
    (feature, value); padding slots are (0, 0.0) and add nothing. With
    need_bias, every row's first slot is (0, 1.0): index 0 is the bias."""

    idx: np.ndarray  # (n, width) int32
    val: np.ndarray  # (n, width) float32
    y: np.ndarray  # (n,) or (n, K) float32
    weight: np.ndarray  # (n,) float32
    n_real: int
    dim: int  # feature dimension (dict size)
    field: Optional[np.ndarray] = None  # (n, width) int32, FFM only

    @property
    def n(self) -> int:
        return self.idx.shape[0]

    def rows(self, lo: int, hi: int) -> "SparseDataset":
        """Rows [lo, hi) as a dataset of hi - lo rows: those past n are
        padding (weight 0, y 0, index 0 with value 0). `n_real` counts the
        real rows of the slice."""
        n = self.n
        a, b = min(lo, n), min(hi, n)
        pad = (hi - lo) - (b - a)

        def take(arr):
            if arr is None:
                return None
            part = np.array(arr[a:b])  # a copy, also of a memory map
            if pad:
                part = np.pad(part, ((0, pad),) + ((0, 0),) * (part.ndim - 1))
            return part

        return SparseDataset(
            idx=take(self.idx), val=take(self.val), y=take(self.y),
            weight=take(self.weight),
            n_real=max(0, min(self.n_real, hi) - min(lo, self.n_real)),
            dim=self.dim, field=take(self.field))

    def pad_rows_to(self, target: int) -> "SparseDataset":
        """Padded with weight-0 rows to `target` rows (a process's shard
        held to the count every process pads to)."""
        return self if target <= self.n else self.rows(0, target)

    def shard(self, mesh) -> "SparseDataset":
        """This rank's rows of a mesh, padded with weight-0 rows to the
        count every rank holds (parallel.mesh.equal_row_target, a
        collective under --coordinator): one ingest of every row
        (`--devices`) gives the rank its contiguous block, an own ingest
        (`--coordinator`) is the rank's shard already."""
        from ..parallel.mesh import equal_row_target, local_rows

        target = equal_row_target(self.n, mesh)
        if not mesh.shared_ingest:
            return self.pad_rows_to(target)
        return self.rows(*local_rows(target, mesh))


@dataclass
class IngestResult:
    train: SparseDataset
    test: Optional[SparseDataset]
    feature_map: Dict[str, int]  # name -> global index
    transform_nodes: Dict[int, TransformNode] = field(default_factory=dict)
    # label stats (reference: CoreData.globalSync y stats)
    y_real_stat: Optional[np.ndarray] = None
    y_weight_stat: Optional[np.ndarray] = None
    parser: Optional[str] = None  # native | python


@dataclass
class _Cols:
    """Columnar rows from the native parser after label expansion, hashing
    and y-sampling: the fast path's List[ParsedLine]."""

    weight: np.ndarray  # (n,) f32
    y: np.ndarray  # (n,) or (n, K) f32
    occ_row: np.ndarray  # (nnz,) i64 row of each feature occurrence
    occ_name: np.ndarray  # (nnz,) i64 -> names
    occ_val: np.ndarray  # (nnz,) f64
    names: List[str]


def _counts_from_rows(rows: Sequence[ParsedLine]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for r in rows:
        for name, _ in r.feats:
            counts[name] = counts.get(name, 0) + 1
    return counts


class DataIngest:
    """The convex families' ingest on one process (reference:
    DataFlow.loadFlow)."""

    def __init__(
        self,
        params: CommonParams,
        fs=None,
        n_labels: int = 1,
        transform_hook: Optional[Callable[[bytes], List[str]]] = None,
        field_map: Optional[Dict[str, int]] = None,
    ):
        self.params = params
        self.fs = fs or LocalFileSystem()
        self.n_labels = n_labels  # K for multiclass losses, else 1
        self.transform_hook = transform_hook
        # FFM: a feature's field is its name's prefix before field_delim,
        # through the field dict; features of unknown fields drop
        # (reference: FFMModelDataFlow.updateX)
        self.field_map = field_map
        fh = params.feature.feature_hash
        self.hash = (FeatureHash(fh.bucket_size, fh.seed, fh.feature_prefix)
                     if fh.need_feature_hash else None)
        self.rng = random.Random(20170425)

    # -- parsing --------------------------------------------------------

    def _expand_labels(self, labels: List[float], line: str) -> List[float]:
        K = self.n_labels
        if K == 1:
            return labels[:1]
        if len(labels) == K:
            return labels
        if len(labels) == 1:
            clazz = int(labels[0])
            if clazz >= K:
                raise ValueError(f"label must be in [0,{K-1}]: {line}")
            out = [0.0] * K
            out[clazz] = 1.0
            return out
        raise ValueError(f"label num must be {K} or 1: {line}")

    def parse_rows(self, lines: Iterable[str], max_error_tol: int,
                   is_train: bool) -> List[ParsedLine]:
        delim = self.params.data.delim
        ys = dict(self.params.data.y_sampling)
        rows: List[ParsedLine] = []
        errors = 0
        subsampled = 0  # parse-valid lines dropped by y_sampling
        for raw in lines:
            if not raw.strip():
                continue
            for line in (self.transform_hook(raw.encode("utf-8"))
                         if self.transform_hook else [raw]):
                try:
                    pl = parse_line(line, delim)
                    pl.labels = self._expand_labels(pl.labels, line)
                    if self.hash is not None:
                        pl.feats = self.hash.hash_features(pl.feats)
                    if is_train and ys:
                        # label-dependent subsampling with inverse-
                        # probability weights (reference: CoreData.yExtract);
                        # a K-vector without an exact 1.0 is an error line
                        label_idx = (pl.labels.index(1.0)
                                     if len(pl.labels) > 1
                                     else int(pl.labels[0]))
                        rate = ys.get(str(label_idx))
                        if rate is not None:
                            pl.weight *= (1.0 / rate) if rate <= 1.0 else rate
                            if self.rng.random() > rate:
                                subsampled += 1
                                continue
                except (ValueError, IndexError, OverflowError):
                    errors += 1
                    if errors > max_error_tol:
                        raise
                    continue
                rows.append(pl)
        obs_inc("ingest.rows_parsed", len(rows))
        obs_inc("ingest.error_lines", errors)
        # the rate sentinel under the absolute max_error_tol cap; its
        # denominator counts parse-valid lines before y_sampling drops them
        health.check_ingest("ingest.parse", errors, len(rows) + subsampled,
                            is_train=is_train)
        return rows

    # -- dict -----------------------------------------------------------

    def build_feature_map(self, rows: Sequence[ParsedLine]) -> Dict[str, int]:
        """Count -> filter(threshold) -> sorted names -> indices, bias at 0
        (reference: DataFlow.reduceFeature:294)."""
        return self.finalize_feature_map(_counts_from_rows(rows))

    def finalize_feature_map(self, counts: Dict[str, int]) -> Dict[str, int]:
        """The processes' counts summed, the count filter (threshold),
        sorted names, bias at 0 (reference: DataFlow.reduceFeature:294)."""
        p = self.params
        counts = self._merge_counts(counts)
        thr = p.feature.filter_threshold
        names = sorted(n for n, c in counts.items() if c >= thr)
        fmap: Dict[str, int] = {}
        delta = 0
        if p.model.need_bias:
            fmap[p.model.bias_feature_name] = 0
            delta = 1
            if p.model.bias_feature_name in names:
                names.remove(p.model.bias_feature_name)
        for i, n in enumerate(names):
            fmap[n] = i + delta
        return fmap

    def _merge_counts(self, counts: Dict[str, int]) -> Dict[str, int]:
        """Every process's counts, union-summed (the allreduceMap of
        CoreData.globalSync:628); one process: `counts` itself."""
        from ..parallel.collectives import host_allgather_objects

        all_counts = host_allgather_objects(counts)
        if len(all_counts) == 1:
            return counts
        merged: Dict[str, int] = {}
        for c in all_counts:
            for k, v in c.items():
                merged[k] = merged.get(k, 0) + v
        return merged

    def load_feature_map(self, dict_paths: Sequence[str]) -> Dict[str, int]:
        """Bias at 0, then the dict files' lines in sorted-path order
        (reference: DataFlow.loadDict:244). Process 0 reads them and the
        others take its names: a dict is a process-0 dump, so another
        process's storage may hold none or an older one."""
        from ..parallel.collectives import load_on_rank0

        def read_names() -> List[str]:
            out: List[str] = []
            for path in sorted(self.fs.recur_get_paths(dict_paths)):
                with self.fs.open(path) as f:
                    out.extend(line.strip() for line in f)
            return out

        names = load_on_rank0(read_names)
        p = self.params
        fmap: Dict[str, int] = {}
        if p.model.need_bias:
            fmap[p.model.bias_feature_name] = 0
        for name in names:
            if name and name not in fmap:
                fmap[name] = len(fmap)
        return fmap

    def _resolve_feature_map(self, counts_fn) -> Dict[str, int]:
        """Load a dict when just_evaluate or continue_train finds the
        model's, or need_dict names one; else build it from the counts
        that counts_fn() returns. Process 0 chooses the branch (the dump
        is its own) and every process takes its choice."""
        from ..parallel.collectives import load_on_rank0

        p = self.params
        model_dict = p.model.data_path + "_dict"

        def pick_dict_source() -> Optional[List[str]]:
            if p.loss.just_evaluate and self.fs.exists(model_dict):
                return [model_dict]
            if p.model.need_dict and p.model.dict_path:
                return [p.model.dict_path]
            if p.model.continue_train and self.fs.exists(model_dict):
                return [model_dict]
            return None

        src = load_on_rank0(pick_dict_source)
        if src is not None:
            return self.load_feature_map(src)
        return self.finalize_feature_map(counts_fn())

    # -- transform ------------------------------------------------------

    def compute_transform_nodes(self, rows: Sequence[ParsedLine],
                                fmap: Dict[str, int]
                                ) -> Dict[int, TransformNode]:
        """Stats over the training rows -> nodes (nodes_from_stats)."""
        if not self.params.feature.transform.switch_on:
            return {}
        stats: Dict[str, FeatureStat] = {}
        for r in rows:
            for name, v in r.feats:
                s = stats.get(name)
                if s is None:
                    stats[name] = s = FeatureStat()
                s.update(v)
        return self.nodes_from_stats(stats, fmap)

    def nodes_from_stats(self, stats: Dict[str, FeatureStat],
                         fmap: Dict[str, int]) -> Dict[int, TransformNode]:
        """Nodes of the chosen features (include_features, else all but
        exclude_features; never the bias), from every process's statistics
        merged."""
        from ..parallel.collectives import host_allgather_objects

        all_stats = host_allgather_objects(stats)
        if len(all_stats) > 1:
            merged: Dict[str, FeatureStat] = {}
            for st in all_stats:
                for k, v in st.items():
                    if k in merged:
                        merged[k].merge(v)
                    else:
                        merged[k] = dataclasses.replace(v)
            stats = merged
        p = self.params
        t = p.feature.transform
        include, exclude = set(t.include_features), set(t.exclude_features)
        names = set(fmap) - {p.model.bias_feature_name}
        chosen = include or (names - exclude if exclude else names)
        nodes: Dict[int, TransformNode] = {}
        for name in chosen:
            if name in stats and name in fmap:
                nodes[fmap[name]] = TransformNode.from_stat(
                    stats[name], t.mode, t.scale_max, t.scale_min)
        return nodes

    def write_transform_sidecar(self, nodes: Dict[int, TransformNode],
                                fmap: Dict[str, int]) -> None:
        """`<model>_feature_transform_stat`, the reference's text format;
        process 0 writes it (every process holds the same nodes)."""
        from ..parallel.mesh import process_index

        if not nodes or process_index() != 0:
            return
        inv = {i: n for n, i in fmap.items()}
        path = self.params.model.data_path + "_feature_transform_stat"
        with self.fs.atomic_open(path) as f:
            for i, node in sorted(nodes.items()):
                f.write(f"{inv[i]}###{node}\n")

    def load_transform_sidecar(self, fmap: Dict[str, int]
                               ) -> Dict[int, TransformNode]:
        """The `<model>_feature_transform_stat` sidecar read back as
        {feature index: node} over the names in `fmap` ({} when there is
        none)."""
        from ..transform.sidecar import read_sidecar

        path = self.params.model.data_path + "_feature_transform_stat"
        if not self.fs.exists(path):
            return {}
        named, _digest = read_sidecar(self.fs, path)
        return {fmap[name]: node for name, node in named.items()
                if name in fmap}

    # -- materialization -------------------------------------------------

    def to_dataset(self, rows: Sequence[ParsedLine], fmap: Dict[str, int],
                   nodes: Optional[Dict[int, TransformNode]] = None
                   ) -> SparseDataset:
        """Rows -> padded ELL arrays: the bias first (field 0) when
        need_bias, then each row's features in line order; features
        outside the dict, or of an unknown field, drop."""
        p = self.params
        need_bias = p.model.need_bias
        n = len(rows)
        K = self.n_labels
        fm = self.field_map
        fdelim = p.data.delim.field_delim
        row_of: List[int] = []
        gis: List[int] = []
        vals: List[float] = []
        fis: List[int] = []
        counts = np.zeros(n, np.int64)
        for i, r in enumerate(rows):
            c = 0
            if need_bias:
                row_of.append(i)
                gis.append(0)
                vals.append(1.0)
                fis.append(0)
                c = 1
            for name, v in r.feats:
                gi = fmap.get(name)
                if gi is None:
                    continue
                fi = 0
                if fm is not None:
                    fi = fm.get(name.split(fdelim)[0], -1)
                    if fi < 0:
                        continue
                row_of.append(i)
                gis.append(gi)
                vals.append(v)
                fis.append(fi)
                c += 1
            counts[i] = c
        width = max(int(counts.max()) if n else 0, 1)
        flat_gi = np.asarray(gis, np.int64)
        flat_v = np.asarray(vals, np.float64)
        if nodes and len(flat_gi):
            # the bias has no node (compute_transform_nodes skips it), so
            # its replay is the identity
            from ..transform.pipeline import TransformTable, apply_nodes

            flat_v = apply_nodes(TransformTable.from_indexed(nodes, len(fmap)),
                                 flat_gi, flat_v)
        ri = np.asarray(row_of, np.int64)
        start = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=start[1:])
        jj = np.arange(len(ri)) - start[ri] if len(ri) else ri
        idx = np.zeros((n, width), np.int32)
        val = np.zeros((n, width), np.float32)
        idx[ri, jj] = flat_gi
        val[ri, jj] = flat_v
        fld = None
        if fm is not None:
            fld = np.zeros((n, width), np.int32)
            fld[ri, jj] = np.asarray(fis, np.int64)
        if K > 1:
            y = np.asarray([r.labels for r in rows],
                           np.float32).reshape((n, K))
        else:
            y = np.asarray([r.labels[0] for r in rows], np.float32)
        weight = np.asarray([r.weight for r in rows], np.float32)
        return SparseDataset(idx, val, y, weight, n_real=n, dim=len(fmap),
                             field=fld)

    # -- the whole flow ---------------------------------------------------

    def load(self) -> IngestResult:
        """The loadFlow (reference: dataflow/DataFlow.java:468): the native
        parser's columnar pipeline when it can run, else the Python one."""
        fast = native.use_native(self.params.data.delim, self.transform_hook)
        log.info("convex ingest: the %s parser",
                 "native" if fast else "python")
        return self._load_fast() if fast else self._load_python()

    def _load_python(self) -> IngestResult:
        p = self.params

        def read(paths: Sequence[str]) -> Iterator[str]:
            return shard_read_lines(self.fs, p.data, paths)

        with obs_span("ingest.parse", split="train", path="python"):
            train_rows = self.parse_rows(read(p.data.train_paths),
                                         p.data.train_max_error_tol,
                                         is_train=True)
        with obs_span("ingest.dict"):
            fmap = self._resolve_feature_map(
                lambda: _counts_from_rows(train_rows))
        with obs_span("ingest.transform"):
            nodes = self.compute_transform_nodes(train_rows, fmap)
            if nodes:
                self.write_transform_sidecar(nodes, fmap)
        with obs_span("ingest.materialize", split="train"):
            train = self.to_dataset(train_rows, fmap, nodes)
        obs_inc("ingest.rows", train.n_real)
        test = None
        if p.data.test_paths:
            with obs_span("ingest.parse", split="test", path="python"):
                test_rows = self.parse_rows(read(p.data.test_paths),
                                            p.data.test_max_error_tol,
                                            is_train=False)
            with obs_span("ingest.materialize", split="test"):
                test = self.to_dataset(test_rows, fmap, nodes)
            obs_inc("ingest.rows", test.n_real)
        K = max(self.n_labels, 2)
        y_real = np.zeros(K, np.int64)
        y_weight = np.zeros(K, np.float64)
        for r in train_rows:
            if len(r.labels) > 1:
                if 1.0 not in r.labels:
                    continue  # a soft K-vector label has no class slot
                li = r.labels.index(1.0)
            else:
                li = int(r.labels[0])
            if 0 <= li < K:
                y_real[li] += 1
                y_weight[li] += r.weight
        return IngestResult(train=train, test=test, feature_map=fmap,
                            transform_nodes=nodes, y_real_stat=y_real,
                            y_weight_stat=y_weight, parser="python")

    # -- the columnar path over the native parser --------------------------

    def _parse_cols(self, paths, max_error_tol: int, is_train: bool
                    ) -> _Cols:
        """Native parse + vectorised label expansion, hashing and
        y-sampling (reference io/reader.py:701). Rows and occurrences come
        back in input order: the Python path's rows, errors, dict order and
        rng draws."""
        p = self.params
        d = p.data.delim
        paths2, divisor, remainder = shard_plan(self.fs, p.data, paths)
        blk = native.parse_paths(
            self.fs, paths2, d.x_delim, d.y_delim, d.features_delim,
            d.feature_name_val_delim, divisor=divisor, remainder=remainder)
        n_errors = blk.n_errors
        n = blk.n
        K = self.n_labels
        bad, y = native.expand_labels_columnar(blk.label_ptr, blk.labels, n,
                                               K)
        occ_row = np.repeat(np.arange(n), np.diff(blk.row_ptr))
        occ_name = blk.feat_ids.astype(np.int64)
        occ_val = blk.feat_vals.astype(np.float64)
        names: List[str] = blk.names
        if self.hash is not None and len(names):
            # hash each raw name once, then sum each row's signed values
            # per hashed name in first-occurrence order (hash_features)
            uniq: Dict[str, int] = {}
            hid_of = np.empty(len(names), np.int64)
            sign_of = np.empty(len(names), np.float64)
            for i, nm in enumerate(names):
                hn, sg = self.hash.hash_name(nm)
                hid_of[i] = uniq.setdefault(hn, len(uniq))
                sign_of[i] = sg
            signed = occ_val * sign_of[occ_name]
            hids = hid_of[occ_name]
            key = occ_row * np.int64(len(uniq)) + hids
            _, first_ix, inv = np.unique(key, return_index=True,
                                         return_inverse=True)
            sums = np.bincount(inv, weights=signed)
            order = np.argsort(first_ix, kind="stable")
            sel = first_ix[order]
            occ_row = occ_row[sel]
            occ_name = hids[sel]
            occ_val = sums[order]
            names = list(uniq)
        keep = ~bad
        weight = blk.weights.astype(np.float64)
        n_good = int(keep.sum())  # parse-valid lines, before y_sampling
        if is_train and p.data.y_sampling:
            # label-dependent subsampling (CoreData.yExtract): one
            # rng.random() a kept row whose label has a rate, in row order,
            # as the Python path draws
            ys = {k: float(v) for k, v in dict(p.data.y_sampling).items()}
            if K == 1:
                lidx = np.trunc(y).astype(np.int64)
            else:
                has1 = (y == 1.0).any(axis=1)
                lidx = np.argmax(y == 1.0, axis=1)
                # a K-vector without an exact 1.0 is an error line, as the
                # Python path's labels.index(1.0) raise
                newly_bad = int((keep & ~has1).sum())
                n_errors += newly_bad
                n_good -= newly_bad
                keep &= has1
            for i in np.flatnonzero(keep):
                rate = ys.get(str(int(lidx[i])))
                if rate is None:
                    continue
                weight[i] *= (1.0 / rate) if rate <= 1.0 else rate
                if self.rng.random() > rate:
                    keep[i] = False
        if n_errors > max_error_tol:
            raise ValueError(f"data error lines ({n_errors}) exceed "
                             f"max_error_tol ({max_error_tol})")
        obs_inc("ingest.rows_parsed", float(keep.sum()))
        obs_inc("ingest.error_lines", float(n_errors))
        health.check_ingest("ingest.parse_native", int(n_errors), n_good,
                            is_train=is_train)
        new_row = np.cumsum(keep) - 1
        occ_keep = keep[occ_row]
        return _Cols(weight=weight[keep].astype(np.float32), y=y[keep],
                     occ_row=new_row[occ_row[occ_keep]],
                     occ_name=occ_name[occ_keep],
                     occ_val=occ_val[occ_keep], names=names)

    def _cols_to_dataset(self, cols: _Cols, fmap: Dict[str, int],
                         nodes: Optional[Dict[int, TransformNode]] = None
                         ) -> SparseDataset:
        """Vectorised to_dataset: dict and field filtering, the value
        transform, padded-ELL assembly (reference io/reader.py:799)."""
        p = self.params
        need_bias = p.model.need_bias
        n = len(cols.weight)
        gi_of = np.asarray([fmap.get(nm, -1) for nm in cols.names], np.int64)
        gi = gi_of[cols.occ_name] if len(cols.occ_name) \
            else np.zeros(0, np.int64)
        keep = gi >= 0
        f = None
        if self.field_map is not None:
            fdelim = p.data.delim.field_delim
            fid_of = np.asarray([self.field_map.get(nm.split(fdelim)[0], -1)
                                 for nm in cols.names], np.int64)
            f = fid_of[cols.occ_name] if len(cols.occ_name) \
                else np.zeros(0, np.int64)
            keep &= f >= 0
            f = f[keep]
        occ_row = cols.occ_row[keep]
        gi = gi[keep]
        val = cols.occ_val[keep].astype(np.float64)
        if nodes and len(gi):
            from ..transform.pipeline import TransformTable, apply_nodes

            val = apply_nodes(TransformTable.from_indexed(nodes, len(fmap)),
                              gi, val)
        cnt = np.bincount(occ_row, minlength=n) if n \
            else np.zeros(0, np.int64)
        delta = 1 if need_bias else 0
        width = max((int(cnt.max()) if n and len(cnt) else 0) + delta, 1)
        idx = np.zeros((n, width), np.int32)
        vmat = np.zeros((n, width), np.float32)
        fmat = (np.zeros((n, width), np.int32)
                if self.field_map is not None else None)
        if need_bias and n:
            vmat[:, 0] = 1.0  # bias index 0, field 0
        rp = np.zeros(n + 1, np.int64)
        np.cumsum(cnt, out=rp[1:])
        j = np.arange(len(occ_row)) - rp[occ_row] + delta
        idx[occ_row, j] = gi
        vmat[occ_row, j] = val
        if fmat is not None:
            fmat[occ_row, j] = f
        y = cols.y if self.n_labels > 1 else cols.y.reshape(-1)
        return SparseDataset(idx, vmat, y.astype(np.float32), cols.weight,
                             n_real=n, dim=len(fmap), field=fmat)

    def _load_fast(self) -> IngestResult:
        """The loadFlow over the native parser (reference io/reader.py:859):
        the same pipeline and results as _load_python, vectorised."""
        p = self.params
        with obs_span("ingest.parse", split="train", path="native"):
            train = self._parse_cols(p.data.train_paths,
                                     p.data.train_max_error_tol,
                                     is_train=True)

        def counts() -> Dict[str, int]:
            c = np.bincount(train.occ_name, minlength=len(train.names))
            return {nm: int(c[i]) for i, nm in enumerate(train.names)
                    if c[i] > 0}

        with obs_span("ingest.dict"):
            fmap = self._resolve_feature_map(counts)
        nodes: Dict[int, TransformNode] = {}
        if p.feature.transform.switch_on:
            nn = len(train.names)
            cnt = np.bincount(train.occ_name, minlength=nn).astype(np.int64)
            s1 = np.bincount(train.occ_name, weights=train.occ_val,
                             minlength=nn)
            s2 = np.bincount(train.occ_name, weights=train.occ_val ** 2,
                             minlength=nn)
            mn = np.full(nn, math.inf)
            mx = np.full(nn, -math.inf)
            if len(train.occ_name):
                np.minimum.at(mn, train.occ_name, train.occ_val)
                np.maximum.at(mx, train.occ_name, train.occ_val)
            stats = {nm: FeatureStat(cnt=int(cnt[i]), sum=float(s1[i]),
                                     sum2=float(s2[i]), max=float(mx[i]),
                                     min=float(mn[i]))
                     for i, nm in enumerate(train.names) if cnt[i] > 0}
            nodes = self.nodes_from_stats(stats, fmap)
            if nodes:
                self.write_transform_sidecar(nodes, fmap)
        with obs_span("ingest.materialize", split="train"):
            train_ds = self._cols_to_dataset(train, fmap, nodes)
        obs_inc("ingest.rows", train_ds.n_real)
        test_ds = None
        if p.data.test_paths:
            with obs_span("ingest.parse", split="test", path="native"):
                test = self._parse_cols(p.data.test_paths,
                                        p.data.test_max_error_tol,
                                        is_train=False)
            with obs_span("ingest.materialize", split="test"):
                test_ds = self._cols_to_dataset(test, fmap, nodes)
            obs_inc("ingest.rows", test_ds.n_real)
        K = max(self.n_labels, 2)
        y_real = np.zeros(K, np.int64)
        y_weight = np.zeros(K, np.float64)
        if self.n_labels == 1:
            li = np.trunc(train.y).astype(np.int64)
            valid = (li >= 0) & (li < K)
        else:
            has1 = (train.y == 1.0).any(axis=1)
            li = np.argmax(train.y == 1.0, axis=1)
            valid = has1 & (li >= 0) & (li < K)
        np.add.at(y_real, li[valid], 1)
        np.add.at(y_weight, li[valid], train.weight[valid].astype(np.float64))
        return IngestResult(train=train_ds, test=test_ds, feature_map=fmap,
                            transform_nodes=nodes, y_real_stat=y_real,
                            y_weight_stat=y_weight, parser="native")
