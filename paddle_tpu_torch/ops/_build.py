"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ctypes.  Nothing
here includes PyTorch's headers, so a build takes seconds.  Libraries go
to ``build/paddle_tpu_torch/`` beside the package, named by a hash of
their source and flags, so a changed source rebuilds and an unchanged
one loads as is.  ptxas reports each kernel's registers, spills and
static shared memory (``-v``; the report is shown when a build fails).
A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

__all__ = ["CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels of paddle_tpu_torch "
                       "build on a machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build_all(names: List[str] = None) -> Dict[str, Path]:
    """Compile every named kernel source (default: all of ``csrc``) that
    has no up-to-date library yet, one ``nvcc`` per source, all started
    together.  Returns ``{name: library path}``; raises on any failure."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {n: _lib_path(n) for n in names}
    running = {}
    for n, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        running[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True))
    failures = []
    for n, (tmp, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            # atomic: a concurrent loader sees whole files only
            os.replace(tmp, libs[n])
    if failures:
        raise RuntimeError("kernel build failed: " + "\n".join(failures))
    return libs


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = _LOADED[name] = ctypes.CDLL(str(build_all([name])[name]))
    return lib
