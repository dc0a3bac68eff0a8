"""Sort and search ops (counterpart: paddle_tpu/ops/search.py).

Ties resolve as in the JAX package: ``argmax``/``argmin`` give the first
index, ``argsort`` (also ``descending``, a stable sort of ``-x``),
``sort``, ``topk`` and ``kthvalue`` keep equal elements in index order,
so ``topk`` takes the lowest indices among ties (``lax.top_k``; torch's
``topk`` leaves their order unspecified).  ``mode`` returns **(value,
count)**, the smallest value among the most frequent, as the JAX
package's ``scipy.stats.mode`` does (Paddle returns (value, index)), and
stays on the tensor's device.
"""
from __future__ import annotations

import torch

from ..core import dtype as dtype_mod
from ._util import scalar

__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "kthvalue",
           "mode", "searchsorted", "bucketize"]


def _arg(tfn, x, axis, keepdim, dtype):
    if axis is None:
        out = tfn(x.reshape(-1), 0)
    else:
        out = tfn(x, int(axis), keepdim=keepdim)
    return out.to(dtype_mod.convert_dtype(dtype))


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmax, x, axis, keepdim, dtype)


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    return _arg(torch.argmin, x, axis, keepdim, dtype)


def argsort(x, axis=-1, descending=False, name=None):
    return torch.argsort(-x if descending else x, dim=axis, stable=True)


def sort(x, axis=-1, descending=False, name=None):
    s = torch.sort(x, dim=axis, stable=True).values
    return torch.flip(s, [axis]) if descending else s


def topk(x, k, axis=-1, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest) values along ``axis`` and their
    indices, the lowest index first among equal values."""
    k = int(scalar(k))
    idx = torch.argsort(x, dim=axis, descending=largest,
                        stable=True).narrow(axis, 0, k)
    return torch.take_along_dim(x, idx, axis), idx


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    s, i = torch.sort(x, dim=axis, stable=True)
    vals, idx = s.select(axis, k - 1), i.select(axis, k - 1)
    if keepdim:
        vals, idx = vals.unsqueeze(axis), idx.unsqueeze(axis)
    return vals, idx


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest among equally
    frequent ones) and its count."""
    rows = x.movedim(axis, -1)
    s = torch.sort(rows, dim=-1).values
    starts = torch.ones_like(s, dtype=torch.bool)
    starts[..., 1:] = s[..., 1:] != s[..., :-1]
    run = torch.cumsum(starts.long(), -1) - 1
    run_len = torch.zeros_like(run).scatter_add_(-1, run,
                                                 torch.ones_like(run))
    count = torch.gather(run_len, -1, run)
    # the first position of the longest run: the smallest of the most
    # frequent values, the sort being ascending
    pos = torch.argmax(count, -1, keepdim=True)
    value = torch.gather(s, -1, pos).squeeze(-1)
    count = torch.gather(count, -1, pos).squeeze(-1)
    if keepdim:
        value, count = value.unsqueeze(axis), count.unsqueeze(axis)
    return value, count


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """The insertion index of each value in its row of
    ``sorted_sequence`` (torch's kernel wants one dtype: both are
    promoted, as JAX does)."""
    dtype = torch.promote_types(sorted_sequence.dtype, values.dtype)
    return torch.searchsorted(sorted_sequence.to(dtype), values.to(dtype),
                              out_int32=out_int32, right=right)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)
