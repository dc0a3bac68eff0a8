"""Dtypes (counterpart: paddle_tpu/core/dtype.py).

Paddle's dtype names and aliases map onto ``torch.dtype``; float32 is the
default floating dtype, as in the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["convert_dtype", "set_default_dtype", "get_default_dtype"]

_NAME_TO_DTYPE = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}

_ALIASES = {
    "fp16": "float16",
    "fp32": "float32",
    "fp64": "float64",
    "bf16": "bfloat16",
    "float": "float32",
    "double": "float64",
    "int": "int32",
    "long": "int64",
}

bool_ = torch.bool
uint8 = torch.uint8
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
complex64 = torch.complex64
complex128 = torch.complex128

_DEFAULT_DTYPE = [torch.float32]


def set_default_dtype(d):
    _DEFAULT_DTYPE[0] = convert_dtype(d)


def get_default_dtype() -> torch.dtype:
    return _DEFAULT_DTYPE[0]


def convert_dtype(dtype):
    """Any dtype spec (name, alias, numpy dtype, ``torch.dtype``) as a
    ``torch.dtype``; ``None`` stays ``None``."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        name = _ALIASES.get(dtype, dtype)
        if name not in _NAME_TO_DTYPE:
            raise ValueError(f"unsupported dtype string: {dtype!r}")
        return _NAME_TO_DTYPE[name]
    name = np.dtype(dtype).name
    if name not in _NAME_TO_DTYPE:
        raise ValueError(f"unsupported dtype: {dtype!r}")
    return _NAME_TO_DTYPE[name]
