"""Build the port's CUDA kernels into one shared library and load it.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` on first use,
each source by its own ``nvcc`` process, all started together, and the
objects are linked into one shared library with a plain C interface under
``build/kernels/<hash of flags and sources>/`` at the root of the checkout
(a git-ignored directory). It is loaded with ``ctypes``; each kernel module
binds its own entry points. A library already built from the same sources
is reused; a failed build raises with the compiler's output. Nothing here
runs at import time: CPU-only machines import this module freely and never
reach the compiler.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

__all__ = ["library"]

#: The compiler's output from the build this process ran (ptxas register,
#: shared-memory and spill report per kernel), or None when a cached
#: library was loaded.
build_log: "str | None" = None

_PKG = pathlib.Path(__file__).resolve().parent.parent
_SOURCES = sorted((_PKG / "csrc").glob("*.cu"))
_BUILD_ROOT = _PKG.parent.parent / "build" / "kernels"
_NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # only when building
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the port's kernels (set CUDA_HOME)")


def _compile(out_dir: pathlib.Path, so: pathlib.Path) -> str:
    """Compile every source in parallel, link, and return the log."""
    nvcc = _nvcc()
    jobs = []
    try:
        for src in _SOURCES:
            obj = out_dir / f"{src.stem}.{os.getpid()}.o"
            log = open(out_dir / f"{src.stem}.{os.getpid()}.log", "w+")
            jobs.append((src, obj, log, subprocess.Popen(
                [nvcc, *_NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=log, stderr=subprocess.STDOUT)))
        failed = [src.name for src, _, _, p in jobs if p.wait() != 0]
        text = []
        for src, _, log, _ in jobs:
            log.seek(0)
            text.append(f"== {src.name}\n{log.read()}")
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(text))
        tmp = out_dir / f".tmp.{os.getpid()}.so"
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                               *(str(obj) for _, obj, _, _ in jobs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        os.replace(tmp, so)
        return "".join(text)
    finally:
        for _, obj, log, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log.close()
            obj.unlink(missing_ok=True)


def library() -> ctypes.CDLL:
    """Build (or reuse) the kernel library and load it."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
        for src in _SOURCES:
            h.update(src.name.encode())
            h.update(src.read_bytes())
        out_dir = _BUILD_ROOT / h.hexdigest()[:16]
        so = out_dir / "librepro_torch_kernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            build_log = _compile(out_dir, so)
        _lib = ctypes.CDLL(str(so))
        return _lib
