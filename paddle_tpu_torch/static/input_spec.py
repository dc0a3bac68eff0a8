"""InputSpec (counterpart: paddle_tpu/static/input_spec.py; reference
`python/paddle/static/input.py`).  ``dtype`` is a ``torch.dtype``."""
from __future__ import annotations

from ..core import dtype as dtype_mod


class InputSpec:
    def __init__(self, shape, dtype="float32", name=None):
        self.shape = list(shape)
        self.dtype = dtype_mod.convert_dtype(dtype)
        self.name = name

    def __repr__(self):
        return f"InputSpec(shape={self.shape}, dtype={self.dtype}, name={self.name})"

    @classmethod
    def from_tensor(cls, tensor, name=None):
        return cls(list(tensor.shape), tensor.dtype, name)

    @classmethod
    def from_numpy(cls, ndarray, name=None):
        return cls(list(ndarray.shape), ndarray.dtype, name)

    def batch(self, batch_size):
        return InputSpec([batch_size] + self.shape, self.dtype, self.name)

    def unbatch(self):
        return InputSpec(self.shape[1:], self.dtype, self.name)


def np_name(dtype) -> str:
    """The numpy name of a dtype spec (``torch.float32`` -> "float32")."""
    return str(dtype_mod.convert_dtype(dtype or "float32")).replace(
        "torch.", "")
