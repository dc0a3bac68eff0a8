"""The functional op library (counterpart: paddle_tpu/ops): creation,
math, manipulation, logic, random, search, stat and linalg ops, the
sequence family, the CRF, control flow (`control_flow`; ``case``,
``switch_case`` and ``while_loop`` here too), the industrial and misc
long tail, over ``torch.Tensor``, exported at the package's top level as
Paddle's ``paddle.*``; the hand-written kernels live beside them
(`paged_attention`, `flash_attention`, `layer_norm`).

**Tensor methods.** The port's tensor is ``torch.Tensor``, so its methods
are torch's.  As the JAX package attaches an op only where its tensor has
no attribute of that name, `_TENSOR_METHODS` attaches only names
``torch.Tensor`` lacks (``x.gather_nd(i)``, ``x.unstack()``,
``x.index_sample(i)``, ...) and never replaces a torch method or
operator.  Some torch methods share a Paddle name with another meaning;
for those Paddle's meaning is the function, ``paddle_tpu_torch.<name>``:

- ``split`` (torch: chunk sizes; Paddle: a number of sections or sizes),
  ``chunk`` (torch allows uneven chunks);
- ``transpose`` (torch: two axes; Paddle: a permutation), ``flatten``,
  ``expand`` and ``reshape`` (torch: sizes as varargs too), ``tile`` and
  ``repeat`` (Paddle's ``tile`` is torch's ``repeat``), ``squeeze``/
  ``unsqueeze`` (Paddle: lists of axes), ``flip``;
- ``gather`` (torch's is `take_along_axis`; Paddle's takes rows),
  ``scatter``, ``index_select`` and ``index_add`` (torch: axis first),
  ``where``;
- ``max``/``min``/``sort``/``median``/``mode`` (torch: also indices;
  torch's median the lower middle value, Paddle's the average; the JAX
  package's ``mode`` (value, count)), ``topk`` (tie order),
  ``cumsum``/``logsumexp`` (torch: an axis is required), ``prod`` (one
  axis in torch), ``mean`` (torch refuses integers);
- ``equal`` (torch: whole-tensor bool; Paddle: elementwise),
  ``allclose`` and ``numel`` (torch: Python values; Paddle: tensors),
  ``histogram`` (torch: also the edges), ``cov``, ``norm``, ``dot``
  (torch: 1-D only), ``unique`` (first indices here).
"""
from __future__ import annotations

import torch

from . import creation, linalg, logic, manipulation, math, random, search
from . import control_flow, crf, industrial, misc, sequence, stat
from .creation import *  # noqa: F401,F403
from .math import *  # noqa: F401,F403
from .manipulation import *  # noqa: F401,F403
from .logic import *  # noqa: F401,F403
from .random import *  # noqa: F401,F403
from .search import *  # noqa: F401,F403
from .stat import *  # noqa: F401,F403
from .linalg import *  # noqa: F401,F403
from .sequence import *  # noqa: F401,F403
from .misc import *  # noqa: F401,F403
from .crf import *  # noqa: F401,F403
from .industrial import *  # noqa: F401,F403
# control flow is a namespace, as in the JAX package: its `cond`
# (branching) must not shadow linalg's `cond` (condition number)
from .control_flow import case, switch_case, while_loop

__all__ = (creation.__all__ + math.__all__ + manipulation.__all__
           + logic.__all__ + random.__all__ + search.__all__ + stat.__all__
           + linalg.__all__ + sequence.__all__ + misc.__all__
           + crf.__all__ + industrial.__all__
           + ["case", "switch_case", "while_loop", "control_flow"])

# Paddle tensor methods torch.Tensor lacks, each the function of its name
_TENSOR_METHODS = (
    "mod", "floor_mod", "scale", "i1", "stanh", "increment", "cast",
    "gather_nd", "take_along_axis", "put_along_axis", "scatter_nd_add",
    "index_sample", "slice", "strided_slice", "unstack", "pad",
    "shard_index", "as_complex", "as_real", "tensordot", "crop",
    "zeros_like", "ones_like", "full_like", "empty_like", "assign",
    "one_hot", "less_than", "greater_than", "equal_all", "is_empty",
    "bucketize", "p_norm", "pinv", "matrix_rank", "eigh", "eigvalsh",
    "cond")


def _attach_methods():
    for name in _TENSOR_METHODS:
        if not hasattr(torch.Tensor, name):
            setattr(torch.Tensor, name, globals()[name])


_attach_methods()
