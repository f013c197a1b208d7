"""Line parsing and the read plan of the text ingest
(``ytklearn_tpu/io/reader.py``, reference dataflow/CoreData.java and
DataFlow.java).

  parse_line           `weight###label[,label...]###name:val,...` -> ParsedLine
  load_transform_hook  the user's python line-transform hook
  shard_plan           this process's read plan: (paths, divisor, remainder)
  shard_read_lines     this process's lines

The port runs one process, so every plan reads every line; the multi-process
line and file shards come with multi-GPU training (ROADMAP.md 1.7). The
convex families' DataIngest and its sparse ELL arrays come with the convex
stack (ROADMAP.md 1.9).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

from ..config.params import DelimParams
from .fs import LocalFileSystem


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
    """This process's read plan: (paths, divisor, remainder). One process
    reads everything, whether `data.assigned` or not: (paths, 1, 0)."""
    return paths, 1, 0


def shard_read_lines(fs, data_params, paths) -> Iterator[str]:
    """This process's lines (the plan of shard_plan)."""
    paths, divisor, remainder = shard_plan(fs, data_params, paths)
    if divisor == 1:
        return fs.read_lines(paths)
    return fs.select_read_lines(paths, divisor, remainder)
