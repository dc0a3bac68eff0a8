"""The parameter server's native core, built by the port itself.

``csrc/ps_server.cc`` (the JAX package's server: TCP, host-memory
tables, server-side optimizers; host C++ with a plain C interface) is
compiled alone with ``g++`` into ``build/paddle_tpu_torch/``, named by a
hash of the source and flags as the CUDA kernels are
(`ops._build`), so both packages speak one wire format from one source.
Concurrent builders (test workers, trainer processes) take a file lock
and the first one's library is kept.  A failed build raises: there is
no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCE", "CXX_FLAGS", "library_path", "build", "load"]

_REPO = Path(__file__).resolve().parents[3]
SOURCE = _REPO / "csrc" / "ps_server.cc"
BUILD_DIR = _REPO / "build" / "paddle_tpu_torch"
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-pthread"]

_LIB = None


def library_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libps_server_{tag[:16]}.so"


def build() -> Path:
    """Compile `SOURCE` unless its library is up to date; returns the
    library's path, raises on a failed build."""
    import fcntl

    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) for the parameter "
                           "server's native core")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "ps_server.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if lib.exists():
            return lib
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {SOURCE} failed (exit "
                               f"{res.returncode}):\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The library, built on first use, with its signatures set."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build()))
    c = ctypes
    sig = {
        "ptrt_ps_server_create": (c.c_void_p, []),
        "ptrt_ps_server_start": (c.c_int, [c.c_void_p, c.c_int, c.c_int,
                                           c.c_char_p]),
        "ptrt_ps_server_create_dense_table": (
            None, [c.c_void_p, c.c_uint32, c.c_uint64, c.c_float, c.c_int]),
        "ptrt_ps_server_create_sparse_table": (
            c.c_int, [c.c_void_p, c.c_uint32, c.c_uint64, c.c_float,
                      c.c_int]),
        "ptrt_ps_server_create_sparse_table_ssd": (
            c.c_int, [c.c_void_p, c.c_uint32, c.c_uint64, c.c_float,
                      c.c_int, c.c_uint64, c.c_char_p]),
        "ptrt_ps_server_create_graph_table": (
            None, [c.c_void_p, c.c_uint32, c.c_uint64]),
        "ptrt_ps_server_save": (c.c_int, [c.c_void_p, c.c_char_p]),
        "ptrt_ps_server_load": (c.c_int, [c.c_void_p, c.c_char_p]),
        "ptrt_ps_server_stop": (None, [c.c_void_p]),
        "ptrt_ps_server_stopped": (c.c_int, [c.c_void_p]),
        "ptrt_ps_server_destroy": (None, [c.c_void_p]),
        "ptrt_ps_client_create": (c.c_void_p, []),
        "ptrt_ps_client_connect": (c.c_int, [c.c_void_p, c.c_char_p,
                                             c.c_int]),
        "ptrt_ps_client_request": (
            c.c_int, [c.c_void_p, c.c_uint8, c.c_uint32, c.c_uint64,
                      c.c_void_p, c.c_uint64, c.c_void_p, c.c_uint64,
                      c.POINTER(c.c_uint64)]),
        "ptrt_ps_client_destroy": (None, [c.c_void_p]),
    }
    for name, (res, args) in sig.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args
    _LIB = lib
    return lib
