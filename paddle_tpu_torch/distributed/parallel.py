"""The parallel environment (counterpart: paddle_tpu/distributed/
parallel.py).

A rank is a process, as in the JAX package's multi-controller mode
(``jax.distributed.initialize``); here the processes join one
``torch.distributed`` default group.  `init_parallel_env` reads the
launcher's ``PADDLE_*`` variables (``PADDLE_TRAINER_ID``,
``PADDLE_TRAINERS_NUM``, ``PADDLE_MASTER`` or the first of
``PADDLE_TRAINER_ENDPOINTS``, ``PADDLE_LOCAL_SIZE``) and:

* **device** — rank *r* runs on ``cuda:(r % device_count)``
  (``torch.cuda.set_device``), and on the CPU only when the caller asks,
  by ``device="cpu"`` or ``PADDLE_DEVICE=cpu``.  Without a card and
  without that request it raises: nothing carries on on the CPU;
* **backend** — the serving mesh's rule (`parallel.mesh.choose_backend`):
  NCCL when every rank on this host has a card of its own, gloo when
  ranks share a card or run on the CPU.  A gloo collective of a CUDA
  tensor is staged through host memory (`collective`).  NCCL that fails
  to start raises; nothing falls back to gloo;
* **start-up check** — one all-reduce of ones over the new group, so a
  group that cannot reduce fails here;
* **failure** — every collective is bounded by ``timeout`` seconds
  (`DIST_TIMEOUT_S`); a rank that dies closes its gloo sockets and the
  others' next collective raises at once;
* **world size 1** — no process group: every collective is the identity,
  the JAX package's single-controller behaviour.
"""
from __future__ import annotations

import atexit
import datetime
import os
from typing import Optional

import torch

from ..parallel.mesh import choose_backend

__all__ = ["ParallelEnv", "init_parallel_env", "get_rank", "get_world_size",
           "is_initialized", "current_device", "backend", "DIST_TIMEOUT_S"]

# seconds a collective may wait for a silent rank before it raises
DIST_TIMEOUT_S = 120.0

_STATE = {"initialized": False, "device": None, "backend": None}


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class ParallelEnv:
    """The launcher's view of this rank (``PADDLE_*``), or of the process
    group once one exists."""

    def __init__(self):
        d = _dist()
        self._rank = _env_int("PADDLE_TRAINER_ID",
                              d.get_rank() if d else 0)
        self._world = _env_int("PADDLE_TRAINERS_NUM",
                               d.get_world_size() if d else 1)

    @property
    def rank(self):
        return self._rank

    @property
    def local_rank(self):
        return self._rank

    @property
    def world_size(self):
        return self._world

    @property
    def nranks(self):
        return self._world

    @property
    def device_id(self):
        dev = _STATE["device"]
        if dev is not None and dev.type == "cuda":
            return dev.index
        return 0

    @property
    def current_endpoint(self):
        return os.environ.get("PADDLE_CURRENT_ENDPOINT", "127.0.0.1:6170")

    @property
    def trainer_endpoints(self):
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        return eps.split(",") if eps else [self.current_endpoint]


def _rank_device(rank: int, device) -> torch.device:
    if device is None and os.environ.get("PADDLE_DEVICE", "") == "cpu":
        device = "cpu"
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch.distributed runs each rank on a CUDA card and "
            "none is available; pass device='cpu' or set PADDLE_DEVICE=cpu "
            "to run the ranks on the CPU")
    if device is not None and torch.device(device).index is not None:
        dev = torch.device(device)
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _master() -> Optional[str]:
    addr = os.environ.get("PADDLE_MASTER") or \
        os.environ.get("COORDINATOR_ADDRESS")
    if addr:
        return addr
    eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
    return eps.split(",")[0] if eps else None


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None, device=None, timeout=None):
    """Join this process to the default group (see the module docstring);
    a second call returns at once.  Returns a `ParallelEnv`."""
    if _STATE["initialized"]:
        return ParallelEnv()
    import torch.distributed as dist

    nproc = int(num_processes or _env_int("PADDLE_TRAINERS_NUM", 1))
    rank = int(process_id if process_id is not None
               else _env_int("PADDLE_TRAINER_ID", 0))
    dev = _rank_device(rank, device)
    if nproc > 1 and not dist.is_initialized():
        addr = coordinator_address or _master()
        if not addr:
            raise ValueError(
                f"{nproc} ranks and no rendezvous address: set PADDLE_MASTER "
                "(host:port of rank 0) or launch through "
                "paddle_tpu_torch.distributed.launch / spawn")
        be = choose_backend(dev, _env_int("PADDLE_LOCAL_SIZE", nproc))
        td = datetime.timedelta(seconds=float(timeout or DIST_TIMEOUT_S))
        dist.init_process_group(be, init_method=f"tcp://{addr}",
                                world_size=nproc, rank=rank, timeout=td)
        atexit.register(_destroy)
        _STATE.update(backend=be, timeout=td)
        probe = torch.ones(1, device=dev)
        from .collective import _reduce_inplace
        _reduce_inplace(probe, dist.ReduceOp.SUM, None)
        if int(probe.item()) != nproc:
            raise RuntimeError(f"init_parallel_env: a test all-reduce over "
                               f"{nproc} ranks gave {probe.item()}")
    elif dist.is_initialized():
        _STATE.update(backend=dist.get_backend())
    _STATE.update(initialized=True, device=dev)
    return ParallelEnv()


def _destroy():
    d = _dist()
    if d is not None:
        d.destroy_process_group()


def is_initialized() -> bool:
    return _STATE["initialized"]


def current_device() -> Optional[torch.device]:
    """This rank's device once `init_parallel_env` ran, else None."""
    return _STATE["device"]


def backend() -> Optional[str]:
    """The default group's backend ("nccl" or "gloo"); None at world size
    1."""
    return _STATE["backend"] if _dist() is not None else None


def get_rank(group=None) -> int:
    if group is not None:
        return group.rank
    d = _dist()
    return d.get_rank() if d else _env_int("PADDLE_TRAINER_ID", 0)


def get_world_size(group=None) -> int:
    if group is not None:
        return group.nranks
    d = _dist()
    return d.get_world_size() if d else 1
