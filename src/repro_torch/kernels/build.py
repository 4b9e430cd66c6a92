"""Build ``csrc/*.cu`` with nvcc and bind the C entry points with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the root of the checkout, named
by a hash of its source and flags, so an edited source never loads a
stale build. Building happens at the first launch, or up front for every
source at once with ``build_all`` (one nvcc process per source, all
started together). A failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``CudaKernel.launch`` raises on a non-zero code and otherwise adds one to
``launches`` — the count a run reads to show that its path went through
the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
KERNELS: dict[str, "CudaKernel"] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``$PATH`` first, then ``/usr/local/cuda``)."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    text = (CSRC / source).read_bytes() + " ".join(NVCC_FLAGS).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so"


def _start(source: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = library_path(source)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return out, tmp, proc


def _finish(source: str, job) -> None:
    if job is None:
        return
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent builder never loads half a file


def build_all(sources: list[str] | None = None) -> list[Path]:
    """Build every source (default: all of ``csrc/*.cu``) in parallel."""
    if sources is None:
        sources = sorted(p.name for p in CSRC.glob("*.cu"))
    jobs = [(s, _start(s)) for s in sources]
    for source, job in jobs:
        _finish(source, job)
    return [library_path(s) for s in sources]


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            _finish(source, _start(source))
            lib = ctypes.CDLL(str(library_path(source)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[source] = lib
        return lib


class CudaKernel:
    """One C entry point of one source: lazy build, binding, launch count.

    ``argtypes`` are ctypes types, ``ctypes.c_void_p`` for every pointer
    and for the stream (a bare int would be cut to 32 bits).
    """

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def _bind(self):
        if self._fn is None:
            lib = load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point; raise on a CUDA error, else count it."""
        lib, fn = self._bind()
        err = fn(*args)
        if err != 0:
            msg = lib.repro_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def counts() -> dict[str, int]:
    """Launch count of every registered kernel, by name."""
    return {name: k.launches for name, k in KERNELS.items()}
