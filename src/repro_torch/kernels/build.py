"""Build ``csrc/*.cu`` with nvcc and bind the C entry points with ctypes.

Each source compiles on its own into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The library lands in ``build/kernels/`` at the root of the checkout, named
by a hash of its source, every ``csrc`` header it includes (directly or
through another header) and the flags, so an edited source or header
never loads a stale build. Building happens at the first launch, or up
front for every source at once with ``build_all`` (one nvcc process per
source, all started together). A failed build raises; nothing falls back.

Every C entry point returns ``cudaGetLastError()`` after its launches;
``CudaKernel.launch`` raises on a non-zero code and otherwise adds one to
``launches`` — the count a run reads to show that its path went through
the kernel. ``on_card`` and ``check_operands`` are the dispatch rule and
the pointer checks every wrapper applies before a launch. Inside
``card_stand_in`` (the dry run, ``launch.dryrun``) a fake tensor on a
``meta`` or ``lazy`` device (the dry run's mesh positions) stands in for
a tensor on the card: ``on_card`` takes it for one, and each wrapper
reaches its launch op, whose shape rule (``register_fake``) gives the
output; a bare ``meta`` tensor raises as before.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from contextlib import contextmanager
from pathlib import Path

import torch
from torch._subclasses.fake_tensor import FakeTensor

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

_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.MULTILINE)
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


def includes(source: str) -> list[str]:
    """``source`` and the ``csrc`` headers it includes with ``#include "..."``,
    directly or through another header, in the order first met."""
    found, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name in found or not (CSRC / name).is_file():
            continue  # a missing header is nvcc's error to report
        found.append(name)
        todo += [m.decode() for m in _INCLUDE.findall((CSRC / name).read_bytes())]
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in includes(source):
        h.update(name.encode() + b"\0" + (CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


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


_stand_in = 0  # > 0 inside ``card_stand_in``


@contextmanager
def card_stand_in():
    """While it is open, ``on_card`` takes a fake tensor on a ``meta`` or
    ``lazy`` device for a tensor on the card (the dry run's mesh
    positions)."""
    global _stand_in
    _stand_in += 1
    try:
        yield
    finally:
        _stand_in -= 1


def on_card(Z: torch.Tensor, name: str) -> bool:
    """Whether ``Z`` lies on a CUDA card (launch the kernel) or the CPU
    (compute with the plain twin); any other device raises, but a fake
    ``meta`` or ``lazy`` tensor inside ``card_stand_in``, which stands in
    for the card."""
    if Z.device.type == "cpu":
        return False
    if Z.device.type == "cuda":
        return True
    if Z.device.type in ("meta", "lazy") and _stand_in and isinstance(Z, FakeTensor):
        return True
    raise ValueError(f"{name} runs on cpu or cuda, not {Z.device}")


def refuse_grad(name: str, *operands) -> None:
    """Raise before a launch that autograd would record: grad mode is on
    and an operand requires a gradient. A kernel writes its output by bare
    pointer, so the result would carry no ``grad_fn`` and ``backward``
    would leave the operands' gradients out without a word; the kernels
    have no backward, as the reference's Pallas kernels have none."""
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for t in operands
    ):
        raise RuntimeError(
            f"{name}: the kernel has no backward; call it under torch.no_grad() "
            "or on operands that do not require a gradient"
        )


def check_operands(Z: torch.Tensor, operands: dict, z_dtype=torch.float32) -> None:
    """Raise unless Z is contiguous and of ``z_dtype`` (f32 by default) and
    every ``name: (tensor, shape, dtype)`` operand has its shape and dtype,
    lies on Z's device and is contiguous: what a kernel takes as a bare
    pointer."""
    everything = {"Z": (Z, tuple(Z.shape), z_dtype), **operands}
    for name, (t, shape, dtype) in everything.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.device != Z.device:
            raise ValueError(f"{name} is on {t.device}, Z on {Z.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
