"""Build and load the port's hand-written CUDA kernels.

Every kernel source is a ``csrc/*.cu`` file with a plain C interface. It is
compiled at first use with

    nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a -shared
         -Xcompiler -fPIC -Xptxas -v <src> -o <csrc>/build/lib<name>.so

into the ``build/`` directory beside the source (gitignored), and loaded
through ctypes. A library is rebuilt when it is missing or older than its
source. A failed build raises with nvcc's stderr: nothing falls back to a
kernel's plain PyTorch version on a CUDA tensor.

Every build and every load of a library built before is reported to the
obs build watcher (obs/health.py::note_compile), and so is the first
launch in the process of each kernel instantiation: `launching()` is the
kernels' shared launch counter, which also opens a
`torch.profiler.record_function("kernel.<name>")` around the launch while
the profiling plane is on (obs/profiler.py).
"""

from __future__ import annotations

import ctypes
import logging
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, Optional

from .obs import profiler as _profiler
from .obs.core import annotate

log = logging.getLogger(__name__)

NVCC_FLAGS = (
    "-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the port's kernels are "
        "built from their csrc/*.cu sources at first use on a CUDA machine"
    )


class KernelLibrary:
    """One csrc/*.cu source, its shared library and its ctypes binding.

    `bind(lib)` sets the argtypes/restype of the library's C functions.
    Every source exports `const char* ytk_cuda_error_string(int)` beside
    its launchers, which return the cudaGetLastError() of their launch."""

    def __init__(self, src: str, bind: Callable[[ctypes.CDLL], None]):
        self.src = src
        name = os.path.splitext(os.path.basename(src))[0]
        self.so = os.path.join(os.path.dirname(src), "build",
                               f"libytk_{name}.so")
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def build(self) -> Dict[str, object]:
        """Compile the source now. Returns the command, its seconds and
        nvcc's log (ptxas registers/spills); raises with nvcc's stderr when
        the build fails."""
        os.makedirs(os.path.dirname(self.so), exist_ok=True)
        tmp = f"{self.so}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, self.src, "-o", tmp]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (rc {proc.returncode}) building {self.src}:\n"
                f"{proc.stderr[-4000:]}"
            )
        os.replace(tmp, self.so)
        log.info("built %s in %.1f s", self.so, seconds)
        note_compile("build", os.path.basename(self.so), seconds)
        return {"cmd": " ".join(cmd), "seconds": seconds,
                "log": proc.stdout + proc.stderr}

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first when missing or older than its
        source. Serialised so concurrent first launches build once."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            built = not os.path.exists(self.so) or \
                os.path.getmtime(self.so) < os.path.getmtime(self.src)
            if built:
                self.build()
            t0 = time.perf_counter()
            lib = ctypes.CDLL(self.so)
            if not built:
                note_compile("load", os.path.basename(self.so),
                             time.perf_counter() - t0)
            lib.ytk_cuda_error_string.restype = ctypes.c_char_p
            lib.ytk_cuda_error_string.argtypes = [ctypes.c_int]
            self._bind(lib)
            self._lib = lib
            return lib

    def check(self, rc: int, what: str) -> None:
        """Raise when a launcher returned a CUDA error."""
        if rc != 0:
            raise RuntimeError(
                f"{what} launch failed: CUDA error {rc} "
                f"({self.load().ytk_cuda_error_string(rc).decode()})"
            )


def note_compile(kind: str, what: str, seconds: float) -> None:
    """Report a build, a load or an instantiation to the obs watcher."""
    from .obs import health

    health.note_compile(kind, what, seconds)


_launch_lock = threading.Lock()
#: the kernel instantiations launched in this process
_instances: set = set()


class launching:
    """The kernels' shared launch counter, around one launch:

        with launching(hist_wave, "hist", kind, bin_bytes, vec):
            rc = lib.ytk_hist_float(...)
            LIBRARY.check(rc, "hist")

    On a clean exit it adds one to `wrapper.launches`; the first launch in
    the process of the instantiation (`name` and the `instance` values:
    the plan kind and template arguments, never a size) is reported to the
    build watcher as kind "instantiate" with the launch's host seconds,
    which hold the lazy module load. While the profiling plane is on, the
    launch runs inside `record_function("kernel.<name>")`, the kernel
    table's row for it."""

    __slots__ = ("wrapper", "key", "ann", "t0")

    def __init__(self, wrapper, name: str, *instance):
        self.wrapper = wrapper
        self.key = (name,) + instance

    def __enter__(self) -> "launching":
        self.ann = (annotate(_profiler.KERNEL_PREFIX + self.key[0])
                    if _profiler.enabled() else None)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        seconds = time.perf_counter() - self.t0
        if self.ann is not None:
            self.ann.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return False
        with _launch_lock:
            self.wrapper.launches += 1
            new = self.key not in _instances
            if new:
                _instances.add(self.key)
        if new:
            name, *inst = self.key
            note_compile("instantiate",
                         f"{name}[{','.join(str(v) for v in inst)}]",
                         seconds)
        return False

