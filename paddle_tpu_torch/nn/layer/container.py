"""Layer containers (counterpart: paddle_tpu/nn/layer/container.py)."""
from __future__ import annotations

from torch import nn

__all__ = ["LayerList"]


class LayerList(nn.ModuleList):
    """An indexable list of sublayers, registered as ``0``, ``1``, ..."""
