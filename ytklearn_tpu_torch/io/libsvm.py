"""libsvm -> ytklearn text converter, `cli convert` (the JAX package's
``io/libsvm.py``; reference utils/LibsvmConvertTool.java:43-155 and the
bin/libsvm_convert_2_ytklearn.sh surface): every reference demo dataset
ships as libsvm, so this is the on-ramp for demo-parity runs.

mode: "binary_classification@l0,l1" | "multi_classification@l0,l1,..."
      | "regression"
Lines become `1<x_delim><label><x_delim>name:val,...`; unlabeled lines
(first token contains ':') keep an empty label column.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from ..obs import heartbeat as obs_heartbeat, inc as obs_inc, span as obs_span
from .fs import FileSystem, LocalFileSystem

log = logging.getLogger("ytklearn_tpu_torch.libsvm")


def convert_libsvm(
    mode: str,
    input_path: str,
    output_path: str,
    x_delim: str = "###",
    y_delim: str = ",",
    features_delim: str = ",",
    feature_name_val_delim: str = ":",
    fs: Optional[FileSystem] = None,
) -> int:
    """Convert one libsvm file; returns the number of lines written."""
    fs = fs or LocalFileSystem()
    label_map: Dict[str, int] = {}
    if "classification" in mode:
        head, _, labels = mode.partition("@")
        if not labels:
            raise ValueError(
                f"{head} mode needs labels, e.g. binary_classification@0,1"
            )
        for i, name in enumerate(s.strip() for s in labels.split(y_delim)):
            label_map[name] = i
        if head == "binary_classification" and len(label_map) != 2:
            raise ValueError(f"binary_classification needs 2 labels: {mode}")
    elif not mode.startswith("regression"):
        raise ValueError(f"unsupported mode: {mode}")

    cnt = 0
    kcnt = [0] * max(len(label_map), 1)
    hb = obs_heartbeat("libsvm.convert", every_s=30.0)
    with obs_span("ingest.convert", input=input_path), fs.open(
        output_path, "w"
    ) as out:
        for line in fs.read_lines([input_path]):
            if cnt and cnt & 0xFFFF == 0:
                hb.beat(lines=cnt)
            line = line.strip()
            if not line:
                continue
            info = line.split()
            has_label = ":" not in info[0]
            parts = ["1", ""]
            if has_label:
                if label_map:
                    label = label_map.get(info[0])
                    if label is None:
                        raise ValueError(f"unknown label: {info[0]!r} in {line!r}")
                    parts[1] = str(label)
                    kcnt[label] += 1
                else:
                    parts[1] = str(float(info[0]))
            feats = info[1:] if has_label else info
            kvs = []
            for kv in feats:
                name, _, val = kv.partition(":")
                kvs.append(f"{name}{feature_name_val_delim}{val}")
            out.write(x_delim.join(parts + [features_delim.join(kvs)]) + "\n")
            cnt += 1
    obs_inc("ingest.converted_lines", cnt)
    if label_map:
        log.info("converted %d lines, per-label counts: %s", cnt, kcnt)
    else:
        log.info("converted %d lines", cnt)
    return cnt
