"""`paddle.incubate` (counterpart: paddle_tpu/incubate/)."""
from . import checkpoint  # noqa: F401
