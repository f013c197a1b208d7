"""The transform-stat sidecar (``ytklearn_tpu/transform/sidecar.py``).

`<model>_feature_transform_stat` keeps the reference text format for its
data lines (`<name>###mode=..., mean=..., ...`). At model-dump time the
sidecar is re-stamped with a sha256 digest of the model text about to
land, as a `#model_digest=` header line, atomically and BEFORE the model
file; a predictor refuses a sidecar whose digest names another model text
(the crash-between-writes window). Digestless sidecars (written at ingest,
before a model exists) load as they are.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Optional, Tuple

from ..io.fs import is_tmp_path

DIGEST_PREFIX = "#model_digest="


def model_text_digest(text: str) -> str:
    """sha256 hex of a model text."""
    return hashlib.sha256(text.encode("utf-8")).hexdigest()


def model_parts_digest(fs, model_path: str) -> Optional[str]:
    """Digest of the dumped model: its part texts concatenated in sorted
    path order (the order every loader reads them); None when there is no
    model yet."""
    if not fs.exists(model_path):
        return None
    h = hashlib.sha256()
    for part in sorted(fs.recur_get_paths([model_path])):
        if is_tmp_path(part):
            continue  # an atomic writer's temp file
        with fs.open(part) as f:
            h.update(f.read().encode("utf-8"))
    return h.hexdigest()


def read_sidecar(fs, path: str) -> Tuple[Dict[str, object], Optional[str]]:
    """-> (name -> TransformNode, the embedded digest or None). Lines that
    start with `#` are headers."""
    from ..io.reader import TransformNode

    nodes: Dict[str, object] = {}
    digest: Optional[str] = None
    with fs.open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                if line.startswith(DIGEST_PREFIX):
                    digest = line[len(DIGEST_PREFIX):].strip()
                continue
            name, _, payload = line.partition("###")
            nodes[name.strip()] = TransformNode.from_string(payload.strip())
    return nodes, digest


def verify_sidecar_digest(fs, model_path: str, digest: Optional[str]) -> None:
    """Raise when the sidecar's digest names another model text than the
    one on disk. No digest, or no model yet, passes."""
    if digest is None:
        return
    actual = model_parts_digest(fs, model_path)
    if actual is not None and actual != digest:
        raise ValueError(
            f"transform sidecar digest mismatch for {model_path}: sidecar "
            f"was dumped with model text {digest[:12]}…, on-disk model is "
            f"{actual[:12]}… — refusing to replay stale transform stats "
            "(re-dump the model, or delete the sidecar to retrain stats)"
        )


def stamp_sidecar_digest(fs, sidecar_path: str, digest: str) -> None:
    """Rewrite the sidecar atomically with `#model_digest=<hex>` as its
    header (replacing an earlier one). Call BEFORE writing the model text
    the digest names."""
    if not fs.exists(sidecar_path):
        return
    with fs.open(sidecar_path) as f:
        lines = [
            ln for ln in f.read().splitlines()
            if ln.strip() and not ln.lstrip().startswith("#")
        ]
    with fs.atomic_open(sidecar_path) as f:
        f.write(DIGEST_PREFIX + digest + "\n")
        for ln in lines:
            f.write(ln + "\n")
