"""Device-time breakdown of a ``torch.profiler`` run, shared by the
serve and train profiles."""
from __future__ import annotations

import subprocess

import torch

_TOP = 12
# the port's own kernels (ops/csrc), listed whatever their rank: every
# kernel source keeps its symbols in namespace paddle_tpu_torch
_PORT_PREFIX = "void paddle_tpu_torch::"


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def _self_device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def breakdown(prof, wall_s: float) -> dict:
    """The device's busy time (the sum of every kernel's and copy's time:
    one stream, so nothing overlaps) and idle share over ``wall_s``, and
    the kernels and the PyTorch operators that took the most device
    time, and every kernel of the port."""
    avgs = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = sorted((e for e in avgs if e.device_type == cuda),
                     key=_self_device_us, reverse=True)
    ops = sorted((e for e in avgs if e.device_type != cuda
                  and e.key.startswith("aten::")),
                 key=_self_device_us, reverse=True)
    busy_us = sum(_self_device_us(e) for e in kernels)

    def rows(evts):
        return [dict(name=e.key[:120], calls=int(e.count),
                     device_ms=_self_device_us(e) / 1e3,
                     share_of_busy=(_self_device_us(e) / busy_us
                                    if busy_us else None))
                for e in evts if _self_device_us(e) > 0]

    port = [e for e in kernels if e.key.startswith(_PORT_PREFIX)]
    out = dict(device_busy_s=busy_us / 1e6 if busy_us else None,
               device_idle_share=(1 - busy_us / 1e6 / wall_s) if busy_us
               else None,
               top_kernels=rows(kernels[:_TOP]), top_ops=rows(ops[:_TOP]),
               port_kernels=rows(port))
    if not busy_us:
        out["note"] = "the profiler recorded no device time: not measured"
    return out
