"""Device identity ("Place") (counterpart: paddle_tpu/core/place.py).

A Place is a named handle over a ``torch.device``: `CPUPlace` is the
host, `CUDAPlace` a CUDA card.  The JAX package's accelerator place is
the TPU (``CUDAPlace`` is an alias of ``TPUPlace`` there); the port has
no TPU and no XPU backend, so `TPUPlace` and `XPUPlace` raise.
"""
from __future__ import annotations

import torch

from .. import device as _device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "to_device"]


class Place:
    device_type = "unknown"

    def __init__(self, device_id: int = 0):
        self.device_id = int(device_id)

    def __eq__(self, other):
        return type(self) is type(other) and \
            self.device_id == other.device_id

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def __repr__(self):
        return f"{type(self).__name__}({self.device_id})"

    def torch_device(self) -> torch.device:
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def __init__(self, device_id: int = 0):
        super().__init__(0)

    def torch_device(self) -> torch.device:
        return torch.device("cpu")


class CUDAPlace(Place):
    device_type = "gpu"

    def torch_device(self) -> torch.device:
        return torch.device("cuda", self.device_id)


class _NoBackendPlace(Place):
    def __init__(self, device_id: int = 0):
        raise ValueError(
            f"{type(self).__name__}: paddle_tpu_torch runs on PyTorch with "
            f"CUDA and has no {self.device_type} backend; use CUDAPlace (the "
            "card) or CPUPlace")


class TPUPlace(_NoBackendPlace):
    device_type = "tpu"


class XPUPlace(_NoBackendPlace):
    device_type = "xpu"


def to_device(place) -> torch.device:
    """``place`` (None, a Place, a ``torch.device`` or a name such as
    "cpu", "gpu", "gpu:1", "cuda:0") as a ``torch.device``; None is
    `device.default_device()`."""
    if place is None:
        return _device.default_device()
    if isinstance(place, Place):
        return _device.resolve_device(place.torch_device())
    if isinstance(place, str):
        name, _, idx = place.partition(":")
        if name in ("tpu", "xpu"):
            raise ValueError(f"device {place!r}: paddle_tpu_torch has no "
                             f"{name} backend; use 'gpu' or 'cpu'")
        if name == "gpu":
            place = f"cuda:{idx}" if idx else "cuda"
    return _device.resolve_device(place)

