"""``paddle.distributed.spawn`` (counterpart: paddle_tpu/distributed/
spawn.py).

``nprocs`` in (-1, 0, 1) runs ``func(*args)`` in this process, as the
JAX package's single controller does.  Otherwise each rank is a fresh
interpreter (multiprocessing's ``spawn`` start method: nothing of this
process's state, threads or CUDA context is inherited) with the
launcher's environment: ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_LOCAL_SIZE``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_CURRENT_ENDPOINT`` and ``PADDLE_MASTER`` (a free port on
127.0.0.1), so ``func`` starts with `init_parallel_env` or
``fleet.init``.  ``func`` must be importable by name (a module-level
function).  With ``join`` the call waits for every rank; the first rank
that fails has the others terminated and raises `SpawnError`.
"""
from __future__ import annotations

import os
import socket
import time

__all__ = ["spawn", "SpawnError", "free_port"]

# seconds a terminated rank has to exit before it is killed
_GRACE_S = 10.0


class SpawnError(RuntimeError):
    """A spawned rank exited with a non-zero code."""


def free_port() -> int:
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def rank_env(nprocs: int) -> list:
    """The ``PADDLE_*`` environment of each of ``nprocs`` local ranks."""
    eps = [f"127.0.0.1:{free_port()}" for _ in range(nprocs)]
    return [{"PADDLE_TRAINER_ID": str(r), "PADDLE_TRAINERS_NUM": str(nprocs),
             "PADDLE_LOCAL_SIZE": str(nprocs),
             "PADDLE_TRAINER_ENDPOINTS": ",".join(eps),
             "PADDLE_CURRENT_ENDPOINT": eps[r], "PADDLE_MASTER": eps[0]}
            for r in range(nprocs)]


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Run ``func(*args)`` on ``nprocs`` ranks; returns the processes."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return None
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = []
    try:
        for env in rank_env(nprocs):
            p = ctx.Process(target=_entry, args=(func, args, env),
                            daemon=daemon)
            p.start()
            procs.append(p)
        if join:
            join_all(procs)
    except BaseException:
        terminate(procs)
        raise
    return procs


def join_all(procs):
    """Wait for every rank; at the first failure terminate the rest and
    raise `SpawnError`."""
    while True:
        codes = [p.exitcode for p in procs]
        bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:
            terminate(procs)
            r, c = bad[0]
            raise SpawnError(f"rank {r} of {len(procs)} exited with code "
                             f"{c}; the other ranks were terminated")
        if all(c == 0 for c in codes):
            return
        time.sleep(0.1)


def terminate(procs):
    """SIGTERM every live rank, SIGKILL any still alive after a grace."""
    for p in procs:
        if p.is_alive():
            p.terminate()
    deadline = time.monotonic() + _GRACE_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
        if p.is_alive():
            p.kill()
            p.join()


def _entry(func, args, env):
    os.environ.update(env)
    func(*args)
