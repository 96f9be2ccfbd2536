"""Build and load the port's CUDA kernels.

``nvcc`` compiles every ``csrc/*.cu`` source of the checkout, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which is loaded with ``ctypes``
(no PyTorch headers, so a build takes seconds). The library lands in
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a digest of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as built. The build happens at
first use; a failed build raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME unset, no nvcc)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libkernels_{h.hexdigest()[:16]}.so"


def _wait_all(procs, timeout: float = 900) -> None:
    """Wait for every (process, log path) pair; raise on the first failure
    with that process's output."""
    try:
        for proc, log in procs:
            proc.wait(timeout=timeout)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{Path(log).read_text()}")
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build() -> str:
    """Compile the kernels if this digest is not built yet. Returns the
    compiler's output (``-Xptxas -v`` register and shared-memory report;
    empty when the library was already built)."""
    out = library_path()
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs, objs = [], []
        for src in sources():
            obj, log = Path(tmp) / f"{src.stem}.o", Path(tmp) / f"{src.stem}.log"
            with open(log, "w") as f:
                procs.append((subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                    stdout=f, stderr=subprocess.STDOUT), log))
            objs.append(str(obj))
        _wait_all(procs)
        lib, log = Path(tmp) / "lib.so", Path(tmp) / "link.log"
        with open(log, "w") as f:
            _wait_all([(subprocess.Popen([_nvcc(), "-shared", "-o", str(lib), *objs],
                                    stdout=f, stderr=subprocess.STDOUT), log)])
        text = "".join(Path(lg).read_text() for _, lg in procs)
        os.replace(lib, out)
    return text


@functools.cache
def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    build()
    lib = ctypes.CDLL(str(library_path()))
    fn = lib.paged_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.fused_rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
                      ctypes.c_int, ctypes.c_float, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
