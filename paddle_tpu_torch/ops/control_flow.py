"""Control flow (counterpart: paddle_tpu/ops/control_flow.py): `cond`,
`while_loop`, `case` and `switch_case` with eager semantics, the JAX
package's concrete-predicate branch: the predicate is read and only the
taken branch runs, as a Python ``if`` in dygraph.

The JAX package's traced branch (``lax.cond``, ``lax.while_loop``,
``lax.switch``) belongs to traced control flow, which lands with
paddle_tpu_torch's slice 4b (ROADMAP.md Queue 1, item 4b).  A
predicate that cannot be read raises with that reason: a CUDA tensor
while a CUDA graph captures (reading it would sync the stream) is never
taken as one branch.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["cond", "while_loop", "case", "switch_case"]


def _readable(v):
    if isinstance(v, torch.Tensor) and v.is_cuda and \
            torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "control flow on a CUDA tensor while a CUDA graph captures: "
            "the predicate cannot be read without a host sync, and the "
            "traced form (both branches in the graph) lands with "
            "slice 4b (ROADMAP.md Queue 1, item 4b)")
    return v


def _concrete(pred) -> bool:
    if isinstance(pred, (bool, int)):
        return bool(pred)
    return bool(_readable(pred))


def _concrete_index(i) -> int:
    if isinstance(i, int):
        return i
    return int(_readable(i))


def cond(pred, true_fn=None, false_fn=None, name=None):
    """``true_fn()`` if ``pred`` holds, else ``false_fn()``; only the
    taken branch runs."""
    return true_fn() if _concrete(pred) else false_fn()


def while_loop(cond_fn: Callable, body_fn: Callable, loop_vars: Sequence,
               is_test=False, name=None):
    """Apply ``body_fn`` to the loop variables while ``cond_fn`` holds;
    returns them as a list."""
    vars_ = list(loop_vars)
    while _concrete(cond_fn(*vars_)):
        out = body_fn(*vars_)
        vars_ = list(out) if isinstance(out, (list, tuple)) else [out]
    return vars_


def case(pred_fn_pairs, default=None, name=None):
    """The function of the first true predicate; with none true,
    ``default()``, or without a default the last pair's function (fluid's
    ``layers.case``)."""
    pairs = list(pred_fn_pairs)
    for pred, fn in pairs:
        if _concrete(pred):
            return fn()
    return default() if default is not None else pairs[-1][1]()


def switch_case(branch_index, branch_fns, default=None, name=None):
    """The branch of ``branch_index`` (``branch_fns`` a list, or a dict
    by index); an index with no branch runs ``default`` (ValueError
    without one)."""
    if isinstance(branch_fns, dict):
        keys = sorted(branch_fns)
        fns = [branch_fns[k] for k in keys]
        index_map = {k: i for i, k in enumerate(keys)}
    else:
        fns = list(branch_fns)
        index_map = None
    bi = _concrete_index(branch_index)
    i = index_map.get(bi) if index_map is not None else (
        bi if 0 <= bi < len(fns) else None)
    if i is None:
        if default is None:
            raise ValueError(f"branch {bi} out of range, no default")
        return default()
    return fns[i]()
