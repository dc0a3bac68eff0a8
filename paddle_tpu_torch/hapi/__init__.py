"""The high-level API (counterpart: paddle_tpu/hapi)."""
from . import callbacks
from .model import Model
from .summary import flops, summary

__all__ = ["callbacks", "Model", "summary", "flops"]
