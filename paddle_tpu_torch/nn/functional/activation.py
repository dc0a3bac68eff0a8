"""Activations (counterpart: paddle_tpu/nn/functional/activation.py)."""
from __future__ import annotations

import torch

__all__ = ["gelu"]


def gelu(x, approximate=False):
    """GELU; ``approximate=True`` is the tanh form of ``jax.nn.gelu``."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")
