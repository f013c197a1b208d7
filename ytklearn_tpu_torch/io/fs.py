"""Storage seam (the JAX package's ``io/fs.py``): the reference
`IFileSystem` surface (reference: fs/IFileSystem.java:35-46) over the local
filesystem (fs/LocalFileSystem.java:39) and any fsspec scheme (gs, s3,
hdfs, memory, ...), with the resilience layer's `io.read` and `io.dump`
seams. Model loading, the ingests' readers, the trainers' dumps and the
serving registry's hot reload all go through it."""

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


class FileSystem:
    """Interface (reference: fs/IFileSystem.java:35-46)."""

    def exists(self, path: str) -> bool:
        raise NotImplementedError

    def open(self, path: str, mode: str = "r") -> IO:
        raise NotImplementedError

    def mkdirs(self, path: str) -> None:
        raise NotImplementedError

    def delete(self, path: str) -> None:
        raise NotImplementedError

    def replace(self, src: str, dst: str) -> None:
        """Move `src` over `dst`, replacing it. Atomic on the local
        filesystem (os.replace); remote schemes degrade to delete+move,
        which is the strongest those stores offer."""
        raise NotImplementedError

    def recur_get_paths(self, paths: Sequence[str]) -> List[str]:
        """Expand directories (recursively) and globs into a flat file list
        (reference: IFileSystem.recurGetPaths); a path that matches nothing
        raises FileNotFoundError."""
        raise NotImplementedError

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

        tmp = f"{path}{TMP_MARKER}{os.getpid()}"
        f = self.open(tmp, mode)
        try:
            yield f
        except BaseException:
            f.close()
            self._discard(tmp)
            raise
        f.close()

        def commit():
            chaos_point("io.dump")
            self.replace(tmp, path)

        try:
            retry_call(commit, site="io.dump")
        except BaseException:
            self._discard(tmp)
            raise

    def _discard(self, tmp: str) -> None:
        try:
            self.delete(tmp)
        # cleanup of the temp file is best-effort: the exception being
        # raised is the failure that matters
        except Exception:  # noqa: BLE001
            pass

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


class LocalFileSystem(FileSystem):
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

    def mkdirs(self, path: str) -> None:
        os.makedirs(self._strip(path), exist_ok=True)

    def delete(self, path: str) -> None:
        path = self._strip(path)
        if os.path.isdir(path):
            import shutil

            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def replace(self, src: str, dst: str) -> None:
        dst = self._strip(dst)
        parent = os.path.dirname(os.path.abspath(dst))
        os.makedirs(parent, exist_ok=True)
        os.replace(self._strip(src), dst)

    def recur_get_paths(self, paths: Sequence[str]) -> List[str]:
        """As FileSystem.recur_get_paths, a directory's files in sorted
        order."""
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


class FsspecFileSystem(FileSystem):
    """Remote schemes (gs/s3/hdfs/memory/...) via fsspec (reference:
    fs/HdfsFileSystem.java:41). Paths may carry the scheme prefix or be
    bare; fsspec normalizes either."""

    def __init__(self, scheme: str):
        import fsspec

        self.scheme = scheme
        self.fs = fsspec.filesystem(scheme)

    def exists(self, path: str) -> bool:
        return self.fs.exists(path)

    def open(self, path: str, mode: str = "r") -> IO:
        if any(m in mode for m in ("w", "a")):
            parent = path.rsplit("/", 1)[0]
            if parent and parent != path:
                try:
                    self.fs.makedirs(parent, exist_ok=True)
                # fsspec backends raise backend-specific errors; flat
                # namespaces need no parent dirs and open() surfaces real
                # failures
                except Exception:  # noqa: BLE001
                    pass
        return self.fs.open(path, mode)

    def mkdirs(self, path: str) -> None:
        self.fs.makedirs(path, exist_ok=True)

    def delete(self, path: str) -> None:
        if self.fs.exists(path):
            self.fs.rm(path, recursive=True)

    def replace(self, src: str, dst: str) -> None:
        # remote object stores have no atomic rename; delete+move is the
        # closest equivalent (readers racing this see missing-then-new,
        # never a half-written file, because `src` was written in full)
        if self.fs.exists(dst):
            self.fs.rm(dst)
        self.fs.mv(src, dst)

    def recur_get_paths(self, paths: Sequence[str]) -> List[str]:
        out: List[str] = []
        for p in paths:
            if self.fs.isdir(p):
                out.extend(self.fs.find(p))
            elif self.fs.exists(p):
                out.append(p)
            else:
                hits = sorted(self.fs.glob(p))
                if not hits:
                    raise FileNotFoundError(p)
                out.extend(hits)
        return out


def create_filesystem(scheme_or_uri: str = "local") -> FileSystem:
    """Scheme -> FileSystem (reference: fs/FileSystemFactory.java:54).

    `local` / `file` map to LocalFileSystem; any other scheme (gs, s3,
    hdfs, memory, ...) resolves through fsspec."""
    scheme = (scheme_or_uri.split("://")[0] if "://" in scheme_or_uri
              else scheme_or_uri)
    scheme = (scheme or "local").lower()
    if scheme in ("local", "file", ""):
        return LocalFileSystem()
    try:
        return FsspecFileSystem(scheme)
    except ImportError as e:
        raise NotImplementedError(
            f"filesystem scheme {scheme!r} needs fsspec (not installed)"
        ) from e
    except ValueError as e:
        raise NotImplementedError(
            f"filesystem scheme {scheme!r} not known to fsspec: {e}"
        ) from e
