"""paddle_tpu_torch: the PyTorch/CUDA port of paddle_tpu.

Module names follow ``paddle_tpu`` so each piece has an obvious
counterpart there; the JAX package is the reference the port is tested
against and is never imported from here.  The port serves a GPT through
a paged-KV continuous-batching `inference.serving.DecodeEngine` whose
attention runs a hand-written CUDA kernel (`ops.paged_attention`), and
trains it through the dygraph loop (``loss.backward(); opt.step()``),
`jit.TrainStep` or `Model.fit`, with flash-attention kernels
(`ops.flash_attention`), on one card or data-parallel over
``torch.distributed`` (`distributed`, ``DataParallel``, ``fleet``).  The top level carries Paddle's surface:
``seed``, ``to_tensor``, ``grad``, ``no_grad``, ``save``, ``load``,
``Model``, ``summary``, places and dtypes, ``set_device``/``get_device``,
``vision`` (transforms, datasets, LeNet to ViT and YOLOv3, the detection
ops), ``metric``, ``distribution``, ``quantization`` (QAT, PTQ, int8
execution), ``sparsity`` (2:4 ASP), ``text`` (datasets),
and the functional tensor API (`ops`: ``paddle.concat``,
``paddle.matmul``, ``paddle.linalg.inv``, ...).  Tensor methods stay
torch's: see `ops` for the names whose torch method means something
else than Paddle's function, and the Paddle methods attached where
torch has none.
"""
from .device import default_device, resolve_device
from .core.dtype import (bfloat16, bool_, complex64, complex128, float16,
                         float32, float64, get_default_dtype, int8, int16,
                         int32, int64, set_default_dtype, uint8)
from .core.flags import get_flags, set_flags
from .core.framework import seed
from .core.place import (CPUPlace, CUDAPlace, Place, TPUPlace, XPUPlace,
                         device_count, get_device, set_device)
from .core.tensor import is_tensor, to_tensor
from .ops import *  # noqa: F401,F403 -- the functional tensor API
from . import ops
from . import amp, autograd, framework, io, jit, metric, nn, optimizer
from . import regularizer
from . import distributed, incubate, profiler
from .distributed import DataParallel
from .autograd import (enable_grad, grad, is_grad_enabled, no_grad,
                       set_grad_enabled)
from .framework import ParamAttr, load, save
from . import hapi
from .hapi import Model, flops, summary
from . import vision
from . import distribution, quantization, sparsity, text
from . import inference, static
import importlib as _importlib

# `from .ops import *` binds nothing called `linalg`; the name is the
# public namespace module (paddle_tpu_torch/linalg.py), as in the JAX
# package
linalg = _importlib.import_module(".linalg", __name__)

# `enable_static`/`disable_static` exist for Paddle's API: the port, like
# the JAX package, always runs imperatively
_static_mode = [False]


def enable_static():
    _static_mode[0] = True


def disable_static():
    _static_mode[0] = False


def in_dynamic_mode():
    return not _static_mode[0]


__all__ = ["default_device", "resolve_device", "seed", "to_tensor",
           "is_tensor", "grad", "no_grad", "enable_grad", "is_grad_enabled",
           "set_grad_enabled", "save", "load", "Model", "summary", "flops",
           "ParamAttr", "set_flags", "get_flags", "Place", "CPUPlace",
           "CUDAPlace", "TPUPlace", "XPUPlace", "get_default_dtype",
           "set_default_dtype", "amp", "autograd", "framework", "io", "jit",
           "metric", "nn", "optimizer", "regularizer", "hapi",
           "distributed", "incubate", "profiler", "DataParallel",
           "set_device", "get_device", "device_count", "ops", "linalg",
           "enable_static", "disable_static", "in_dynamic_mode",
           "vision", "distribution", "quantization", "sparsity",
           "text"] + ops.__all__
__version__ = "0.1.0"
