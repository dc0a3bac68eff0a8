"""Framework helpers (counterpart: paddle_tpu/framework): `ParamAttr`
and ``save``/``load``."""
from .io import load, save
from .param_attr import ParamAttr

__all__ = ["ParamAttr", "save", "load"]
