"""Shape and layout ops, gathers and scatters (counterpart:
paddle_tpu/ops/manipulation.py).

Each op keeps Paddle's signature, which is not always torch's method of
the same name: ``split(x, 3)`` cuts into 3 equal parts (``num_or_sections``
a count, or sizes with one -1 to infer), ``gather`` takes rows (a
multi-dimensional index flattened first), ``scatter`` overwrites rows or,
with ``overwrite=False``, zeroes the indexed rows and accumulates into
them, ``transpose`` takes a permutation, ``expand`` a shape, ``tile`` the
repeat counts.  ``unique`` returns ``np.unique``'s outputs (sorted
values, first indices, inverse, counts) and ``shape`` an int32 tensor.
Where the JAX package goes through numpy on the host (``masked_select``,
``nonzero``, ``unique``, ``unique_consecutive``) the port stays on the
tensor's device.  ``pad`` keeps Paddle's pair order (the last
``len(pad) // 2`` spatial axes of the data format, a pair an axis).
"""
from __future__ import annotations

import builtins

import torch

from ..core import dtype as dtype_mod
from ._util import ints, scalar

__all__ = ["cast", "reshape", "transpose", "t", "concat", "stack", "split",
           "chunk", "squeeze", "unsqueeze", "flatten", "tile", "expand",
           "broadcast_to", "expand_as", "broadcast_tensors", "flip", "roll",
           "rot90", "gather", "gather_nd", "take_along_axis",
           "put_along_axis", "scatter", "scatter_nd_add", "scatter_nd",
           "index_select", "index_sample", "index_add", "masked_select",
           "masked_fill", "where", "nonzero", "slice", "strided_slice",
           "unbind", "unstack", "unique", "unique_consecutive", "pad",
           "shard_index", "repeat_interleave", "moveaxis", "swapaxes",
           "as_complex", "as_real", "tensordot", "numel", "shape", "crop"]


def _axis_list(axis):
    return ints(axis if isinstance(axis, (list, tuple)) else [axis])


def cast(x, dtype, name=None):
    return x.to(dtype_mod.convert_dtype(dtype))


def reshape(x, shape, name=None):
    return torch.reshape(x, ints(shape))


def transpose(x, perm, name=None):
    return x.permute(ints(perm))


def t(x, name=None):
    return x.permute(list(range(x.dim()))[::-1])


def concat(x, axis=0, name=None):
    return torch.cat(list(x), int(scalar(axis)))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), axis)


def split(x, num_or_sections, axis=0, name=None):
    axis = int(scalar(axis))
    n = x.shape[axis]
    if isinstance(num_or_sections, int):
        if n % num_or_sections:
            raise ValueError(f"split: axis {axis} of size {n} is not "
                             f"divisible into {num_or_sections} sections")
        secs = [n // num_or_sections] * num_or_sections
    else:
        secs = ints(num_or_sections)
        if -1 in secs:
            known = builtins.sum(s for s in secs if s != -1)
            secs = [n - known if s == -1 else s for s in secs]
    return list(torch.split(x, secs, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def squeeze(x, axis=None, name=None):
    if axis is None:
        return torch.squeeze(x)
    sq = [a for a in _axis_list(axis) if x.shape[a] == 1]
    return torch.squeeze(x, sq) if sq else x


def unsqueeze(x, axis, name=None):
    for a in sorted(_axis_list(axis)):
        x = x.unsqueeze(a)
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    return torch.flatten(x, start_axis, stop_axis)


def tile(x, repeat_times, name=None):
    return torch.tile(x, ints(repeat_times))


def expand(x, shape, name=None):
    return x.expand(ints(shape))


def broadcast_to(x, shape, name=None):
    return expand(x, shape)


def expand_as(x, y, name=None):
    return x.expand_as(y)


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, _axis_list(axis))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def gather(x, index, axis=0, name=None):
    """The slices of ``x`` at ``index`` along ``axis``; an index of rank
    > 1 is flattened first, a 0-d index drops the axis."""
    axis = 0 if axis is None else int(scalar(axis))
    if index.dim() == 0:
        return x.select(axis, index)
    return torch.index_select(x, axis, index.reshape(-1))


def gather_nd(x, index, name=None):
    return x[tuple(index.long().unbind(-1))]


def take_along_axis(arr, indices, axis, name=None):
    return torch.take_along_dim(arr, indices.long(), axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    idx = indices.long()
    v = torch.as_tensor(values, device=arr.device).to(arr.dtype).expand(
        idx.shape)
    if reduce == "assign":
        return arr.scatter(axis, idx, v)
    if reduce == "add":
        return arr.scatter_add(axis, idx, v)
    if reduce == "multiply":
        return arr.scatter_reduce(axis, idx, v, "prod")
    raise ValueError(reduce)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows of ``x`` at ``index`` replaced by ``updates`` (duplicate
    indices: one of them wins, unspecified which), or with
    ``overwrite=False`` zeroed and then summed over every update."""
    i = index.reshape(-1).long()
    if overwrite:
        return x.index_put((i,), updates)
    return x.index_fill(0, i, 0).index_put((i,), updates, accumulate=True)


def scatter_nd_add(x, index, updates, name=None):
    return x.index_put(tuple(index.long().unbind(-1)), updates,
                       accumulate=True)


def scatter_nd(index, updates, shape, name=None):
    out = torch.zeros(ints(shape), dtype=updates.dtype,
                      device=updates.device)
    return scatter_nd_add(out, index, updates)


def index_select(x, index, axis=0, name=None):
    return gather(x, index, axis)


def index_sample(x, index, name=None):
    return torch.gather(x, 1, index.long())


def index_add(x, index, axis, value, name=None):
    return x.index_add(axis, index.long(), value)


def masked_select(x, mask, name=None):
    return torch.masked_select(x, mask.bool())


def masked_fill(x, mask, value, name=None):
    return torch.where(mask.bool(), scalar(value), x)


def where(condition, x=None, y=None, name=None):
    if x is None and y is None:
        return nonzero(condition, as_tuple=False)
    if not isinstance(x, torch.Tensor):
        x = scalar(x)
    if not isinstance(y, torch.Tensor):
        y = scalar(y)
    return torch.where(condition.bool(), x, y)


def nonzero(x, as_tuple=False, name=None):
    if as_tuple:
        return tuple(torch.nonzero(x, as_tuple=True))
    return torch.nonzero(x)


def slice(input, axes, starts, ends, name=None):
    idx = [builtins.slice(None)] * input.dim()
    for ax, s, e in zip(ints(axes), ints(starts), ints(ends)):
        idx[ax] = builtins.slice(s, e)
    return input[tuple(idx)]


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing a listed axis at a time; a negative stride takes
    the indices Python's ``slice`` gives (PyTorch slices only forward)."""
    for ax, s, e, st in zip(ints(axes), ints(starts), ints(ends),
                            ints(strides)):
        sl = builtins.slice(s, e, st)
        if st > 0:
            idx = [builtins.slice(None)] * x.dim()
            idx[ax] = sl
            x = x[tuple(idx)]
        else:
            pick = torch.arange(*sl.indices(x.shape[ax]), device=x.device)
            x = x.index_select(ax, pick)
    return x


def unbind(input, axis=0, name=None):
    return list(torch.unbind(input, axis))


def unstack(x, axis=0, num=None, name=None):
    return unbind(x, axis)


def _first_index(inverse, n_unique):
    """The first position of each unique value, from the inverse map."""
    pos = torch.arange(inverse.numel(), device=inverse.device)
    first = torch.full((n_unique,), inverse.numel(), dtype=torch.int64,
                       device=inverse.device)
    return first.scatter_reduce(0, inverse.reshape(-1), pos, "amin")


def unique(x, return_index=False, return_inverse=False,
           return_counts=False, axis=None, name=None):
    """``np.unique``: the sorted unique values (of the flattened tensor,
    or the unique slices along ``axis``) and, as asked, each one's first
    index, the inverse map and the counts, in that order."""
    out, inverse, counts = torch.unique(x, sorted=True, return_inverse=True,
                                        return_counts=True, dim=axis)
    res = [out]
    if return_index:
        res.append(_first_index(inverse, out.shape[0 if axis is None
                                                   else axis]))
    if return_inverse:
        res.append(inverse)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, name=None):
    if axis is None:
        x = x.reshape(-1)
    out, inverse, counts = torch.unique_consecutive(
        x, return_inverse=True, return_counts=True, dim=axis)
    res = [out]
    if return_inverse:
        res.append(inverse)
    if return_counts:
        res.append(counts)
    return res[0] if len(res) == 1 else tuple(res)


def _pad_index(n, lo, hi, mode, device):
    """The source positions of an axis of size ``n`` padded by ``lo`` and
    ``hi`` in numpy's "edge", "wrap" or "reflect" mode."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return i % n
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = i % period
    return torch.where(i >= n, period - i, i)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    pad = ints(pad)
    nd = x.dim()
    if len(pad) == 2 * nd:
        width = [(pad[2 * i], pad[2 * i + 1]) for i in range(nd)]
    else:
        # Paddle's order: pairs for the last len(pad) // 2 spatial axes of
        # the data format
        width = [(0, 0)] * nd
        npairs = len(pad) // 2
        if data_format.startswith("NC") and nd >= 3:
            dims = list(range(2, nd))
        else:
            dims = list(range(1, nd - 1))
        dims = dims[-npairs:] if npairs <= len(dims) else \
            list(range(nd - npairs, nd))
        for k, d in enumerate(dims):
            width[d] = (pad[2 * k], pad[2 * k + 1])
    tmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if tmode == "constant":
        # torch's pad takes the pairs last axis first
        flat = [p for lo_hi in reversed(width) for p in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            x = x.index_select(d, _pad_index(x.shape[d], lo, hi, tmode,
                                             x.device))
    return x


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1,
                name=None):
    size = index_num // nshards
    in_shard = (input // size) == shard_id
    return torch.where(in_shard, input % size, ignore_value)


def repeat_interleave(x, repeats, axis=None, name=None):
    return torch.repeat_interleave(x, repeats, axis)


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis1, axis2, name=None):
    return torch.swapaxes(x, axis1, axis2)


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


def tensordot(x, y, axes=2, name=None):
    return torch.tensordot(x, y, dims=axes)


def numel(x, name=None):
    return torch.tensor(x.numel(), device=x.device)


def shape(input, name=None):
    """The shape as an int32 tensor on the input's device."""
    return torch.tensor(list(input.shape), dtype=torch.int32,
                        device=input.device)


def crop(x, shape=None, offsets=None, name=None):
    shp = ints(shape)
    offs = ints(offsets) if offsets is not None else [0] * len(shp)
    return x[tuple(builtins.slice(o, o + s) for o, s in zip(offs, shp))]
