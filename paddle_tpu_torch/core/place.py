"""Device identity ("Place") (counterpart: paddle_tpu/core/place.py).

A Place is a named handle over a ``torch.device``: `CPUPlace` is the
host, `CUDAPlace` a CUDA card.  The JAX package's accelerator place is
the TPU (``CUDAPlace`` is an alias of ``TPUPlace`` there); the port has
no TPU and no XPU backend, so `TPUPlace` and `XPUPlace` raise.

`set_device` names the expected place: the device that `to_tensor`, the
creation and random ops and new layers take when the caller names none.
With nothing set it is the current card (``torch.device("cuda")``, which
follows ``torch.cuda.set_device``, so each rank of a launched job makes
its tensors on its own card), and it raises where there is none, as
`device.default_device` does; ``set_device("cpu")`` is how a program
asks for the CPU.  Engines keep their own ``device=``.
"""
from __future__ import annotations

import contextlib

import torch

from .. import device as _device

__all__ = ["Place", "CPUPlace", "CUDAPlace", "TPUPlace", "XPUPlace",
           "to_device", "set_device", "get_device", "expected_place",
           "device_count"]


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


# the device `set_device` named; None: the current card.  A card named
# without an index stays ``torch.device("cuda")``, which follows
# ``torch.cuda.set_device`` (each launched rank sets its own card)
_EXPECTED_DEVICE = [None]


def _place_of(device: torch.device) -> Place:
    if device.type == "cpu":
        return CPUPlace()
    return CUDAPlace(torch.cuda.current_device() if device.index is None
                     else device.index)


def set_device(device) -> Place:
    """``paddle.set_device``: "cpu", "gpu", "gpu:N", "cuda", "cuda:N", a
    Place or a ``torch.device`` becomes the expected device; "tpu" and
    "xpu" raise ValueError, a card raises where CUDA is unavailable.
    "gpu" without an index is the current card wherever it is read."""
    if isinstance(device, Place):
        device = device.torch_device()
    device = _device.resolve_device(
        _name_to_device(device) if isinstance(device, str) else device)
    _EXPECTED_DEVICE[0] = device
    return _place_of(device)


@contextlib.contextmanager
def expected_device(device):
    """Within the block, ``device`` (when not None) is the expected
    device: layers built there take it."""
    prev = _EXPECTED_DEVICE[0]
    if device is not None:
        _EXPECTED_DEVICE[0] = to_device(device)
    try:
        yield
    finally:
        _EXPECTED_DEVICE[0] = prev


def expected_place() -> Place:
    """The place `set_device` named, else the current card (raises
    without one)."""
    return _place_of(to_device(None))


def get_device() -> str:
    """The expected place as "cpu:0" or "gpu:N" (the JAX package's form)."""
    p = expected_place()
    return f"{p.device_type}:{p.device_id}"


def device_count() -> int:
    """The number of CUDA cards PyTorch sees."""
    return torch.cuda.device_count()


def _name_to_device(place: str):
    name, _, idx = place.partition(":")
    if name in ("tpu", "xpu"):
        raise ValueError(f"device {place!r}: paddle_tpu_torch has no "
                         f"{name} backend; use 'gpu' or 'cpu'")
    if name == "gpu":
        return f"cuda:{idx}" if idx else "cuda"
    return place


def to_device(place) -> torch.device:
    """``place`` (None, a Place, a ``torch.device`` or a name such as
    "cpu", "gpu", "gpu:1", "cuda:0") as a ``torch.device``; None is the
    expected device (`set_device`; the current card when nothing is
    set)."""
    if place is None:
        return _EXPECTED_DEVICE[0] or _device.default_device()
    if isinstance(place, Place):
        return _device.resolve_device(place.torch_device())
    if isinstance(place, str):
        place = _name_to_device(place)
    return _device.resolve_device(place)

