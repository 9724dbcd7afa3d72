"""Build and bind the port's hand-written CUDA kernels.

Each source under ``cald_tpu_torch/csrc`` is compiled with ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, at first
use, into ``cald_tpu_torch/build/`` (keyed by a hash of the source), and
bound with ``ctypes``. A source that calls a library of the CUDA toolkit
(``jpeg_decode.cu``: nvJPEG) names it in its entry's ``libraries``; nothing
else is linked, and nothing outside the repository's sources is built.
Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from collections import defaultdict
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
_BUILD_LOCKS: defaultdict[Path, threading.Lock] = defaultdict(threading.Lock)


def build_library(source: Path, libraries: tuple[str, ...] = ()) -> Path:
    """Compile ``source`` into a shared library for sm_90a unless a build of
    the same source exists, linked against the toolkit's ``libraries`` (with
    the toolkit's library directory as its run path). Returns the library's
    path; raises ``RuntimeError`` with the compiler's output when the build
    fails. Threads that ask for one source at once wait for one build."""
    with _BUILD_LOCKS[Path(source)]:
        return _build(Path(source), libraries)


def _build(source: Path, libraries: tuple[str, ...]) -> Path:
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    lib = BUILD_DIR / f"libcald_{source.stem}_{digest}.so"
    if lib.exists():
        return lib
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else "nvcc"
    link = []
    if libraries:
        libdir = os.path.join(CUDA_HOME or "/usr/local/cuda", "lib64")
        link = [f"-L{libdir}", f"-Xlinker=-rpath,{libdir}", *(f"-l{n}" for n in libraries)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        try:
            proc = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-shared", "-Xcompiler", "-fPIC", "-o", tmp, str(source), *link],
                capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"building {source.name} failed: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed (nvcc exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


class KernelEntry:
    """One C entry point of a kernel library: binding and launch count.

    ``launches`` is incremented once per kernel launch and nowhere else, so a
    run can show that its main path went through the kernel.
    """

    source: Path = CSRC
    libraries: tuple[str, ...] = ()
    symbol = ""
    argtypes: list = []

    def __init__(self):
        self.launches = 0
        self._lib = None
        self._fn = None

    def load(self):
        """Build (if needed) and bind the kernel; returns the C entry point."""
        if self._fn is None:
            self._lib = ctypes.CDLL(str(build_library(self.source, self.libraries)))
            fn = getattr(self._lib, self.symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = self.argtypes
            self._fn = fn
        return self._fn

    def _launch(self, *args):
        err = self.load()(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: kernel launch failed: CUDA error {err}")
        self.launches += 1
