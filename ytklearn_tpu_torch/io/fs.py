"""Storage seam: the local filesystem behind the reference `IFileSystem`
surface (reference: fs/LocalFileSystem.java:39), cut to what model loading,
the GBDT ingest's line readers and the trainer's dumps need, with the
resilience layer's `io.read` and `io.dump` seams. Remote schemes are not
ported yet."""

from __future__ import annotations

import contextlib
import glob as _glob
import os
from typing import IO, Iterator, List, Sequence

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

    @contextlib.contextmanager
    def atomic_open(self, path: str, mode: str = "w"):
        """Write-then-replace: `path` keeps its old content or carries the
        complete new content, never a half-written file (the serving
        registry's fingerprint watcher may read it at any time). On error
        the temp file is removed and `path` is untouched. The commit (the
        replace) is the `io.dump` retry and chaos site: a transient fault
        there costs a backoff, not the checkpoint, and a commit that gives
        up leaves no temp file behind."""
        from ..resilience import chaos_point, retry_call

        dst = self._strip(path)
        tmp = f"{dst}{TMP_MARKER}{os.getpid()}"
        f = self.open(tmp, mode)
        try:
            yield f
        except BaseException:
            f.close()
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        f.close()

        def commit():
            chaos_point("io.dump")
            os.replace(tmp, dst)

        try:
            retry_call(commit, site="io.dump")
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def recur_get_paths(self, paths: Sequence[str]) -> List[str]:
        """Expand directories (recursively, files in sorted order) and
        globs into a flat file list (reference: IFileSystem.recurGetPaths);
        a path that matches nothing raises FileNotFoundError."""
        out: List[str] = []
        for p in paths:
            p = self._strip(p)
            if os.path.isdir(p):
                for root, dirs, files in os.walk(p):
                    dirs.sort()
                    out.extend(os.path.join(root, f) for f in sorted(files))
            elif os.path.exists(p):
                out.append(p)
            else:
                hits = sorted(_glob.glob(p))
                if not hits:
                    raise FileNotFoundError(p)
                out.extend(hits)
        return out

    def read_lines(self, paths: Sequence[str]) -> Iterator[str]:
        """Every line of every file, files in sorted-path order, without the
        trailing newline; streaming (one line held at a time). Each file
        is read under the `io.read` retry and chaos site: a transient
        fault, at the open or mid-read, reopens that file and skips the
        lines already yielded (resilience.retry_lines)."""
        from ..resilience import chaos_point, retry_lines

        for p in sorted(self.recur_get_paths(paths)):

            def open_file(path=p):
                chaos_point("io.read")
                return self.open(path)

            for line in retry_lines(open_file, site="io.read"):
                yield line.rstrip("\n")

    def select_read_lines(self, paths: Sequence[str], divisor: int,
                          remainder: int) -> Iterator[str]:
        """Line-modulo sharding: global line i is kept iff i % divisor ==
        remainder (the `lines_avg` assignment, reference
        dataflow/DataFlow.java:405)."""
        for i, line in enumerate(self.read_lines(paths)):
            if i % divisor == remainder:
                yield line


def create_filesystem(scheme: str = "local") -> LocalFileSystem:
    if (scheme or "local").lower() in ("local", "file"):
        return LocalFileSystem()
    raise NotImplementedError(
        f"filesystem scheme {scheme!r} is not ported yet "
        "(ROADMAP.md, rest of serving)"
    )
