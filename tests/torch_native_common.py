"""The JAX package's native runtime for the port tests that drive it.

``paddle_tpu.core.native`` builds ``build/libpaddle_tpu_rt.so`` on its
first load with no lock across processes.  pytest-xdist workers that
collect the JAX tests at the same moment race in that one build
directory: a worker whose build failed keeps the failure for its life,
and a worker can load a library another is still writing (too short, or
linked from a half-written object, without the parameter server's
symbols).  `jax_native` keeps the port tests out of that race: under an
exclusive ``fcntl.flock`` on ``build/.native_build.lock`` it builds the
runtime target once, in ``build/native_port/``, a directory only this
helper writes, and points the JAX package's loader at that library (the
JAX package's own argument types, by its own ``_load``).  A library this
process loaded already serves if it is complete.  If none can be built
or loaded the test fails loudly: a port test that needs it never skips.
"""
import fcntl
import os
import subprocess

import pytest

# symbols of each part of the runtime the port tests reach: the tracer
# (the profiler) and the parameter server
_NEEDED = ("ptrt_trace_record", "ptrt_ps_server_create")


def _complete(lib):
    return lib not in (None, False) and all(hasattr(lib, s)
                                            for s in _NEEDED)


def load_jax_native():
    """The JAX package's runtime library, complete, as its loader holds
    it (``paddle_tpu.core.native._lib``); raises RuntimeError if it
    cannot be built or loaded."""
    from paddle_tpu.core import native

    if _complete(native._lib):
        return native._lib
    root = native._REPO_ROOT
    out = os.path.join(root, "build", "native_port")
    lib_path = os.path.join(out, "libpaddle_tpu_rt.so")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(root, "build", ".native_build.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        done = os.path.join(out, ".done")
        if not os.path.exists(done):
            try:
                for cmd in (["cmake", "-B", out, "-G", "Ninja",
                             os.path.join(root, "csrc")],
                            ["ninja", "-C", out, "paddle_tpu_rt"]):
                    subprocess.run(cmd, check=True, capture_output=True,
                                   timeout=600)
            except (OSError, subprocess.SubprocessError) as e:
                raise RuntimeError(
                    f"building the JAX package's native runtime failed: "
                    f"{e}") from e
            open(done, "w").close()
        candidates = native._LIB_CANDIDATES
        native._LIB_CANDIDATES = (lib_path,)
        try:
            native._lib = None
            lib = native._load()
        finally:
            native._LIB_CANDIDATES = candidates
    if not _complete(lib):
        raise RuntimeError(f"the JAX package's native runtime at "
                           f"{lib_path} could not be loaded complete")
    return lib


@pytest.fixture(scope="session")
def jax_native():
    return load_jax_native()
