"""Storage seam: the local filesystem behind the reference `IFileSystem`
surface (reference: fs/LocalFileSystem.java:39), cut to what model loading
reads. Remote schemes are not ported yet."""

from __future__ import annotations

import os
from typing import IO

#: marker in the names an atomic writer uses before its replace; loaders
#: skip such paths so a temp file left by a crashed writer is never parsed
TMP_MARKER = ".tmp-"


def is_tmp_path(path: str) -> bool:
    """True for in-flight atomic-write temp files."""
    return TMP_MARKER in path.rsplit("/", 1)[-1]


class LocalFileSystem:
    """reference: fs/LocalFileSystem.java:39."""

    def _strip(self, path: str) -> str:
        if path.startswith("file://"):
            path = path[len("file://"):]
        return path

    def exists(self, path: str) -> bool:
        return os.path.exists(self._strip(path))

    def open(self, path: str, mode: str = "r") -> IO:
        path = self._strip(path)
        if any(m in mode for m in ("w", "a")):
            parent = os.path.dirname(os.path.abspath(path))
            os.makedirs(parent, exist_ok=True)
        return open(path, mode)


def create_filesystem(scheme: str = "local") -> LocalFileSystem:
    if (scheme or "local").lower() in ("local", "file"):
        return LocalFileSystem()
    raise NotImplementedError(
        f"filesystem scheme {scheme!r} is not ported yet "
        "(ROADMAP.md, rest of serving)"
    )
