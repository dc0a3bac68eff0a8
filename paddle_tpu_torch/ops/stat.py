"""Statistics: variance, median, quantiles, histograms, covariance
(counterpart: paddle_tpu/ops/stat.py).

``median`` and ``nanmedian`` average the two middle values of an even
count (``jnp.median``; ``torch.median`` returns the lower one, so it is
not used).  ``histogram`` with ``min == max == 0`` spans the data's
range, puts a value equal to the upper edge in the last bin and drops
values outside the range (``jnp.histogram``).
"""
from __future__ import annotations

import torch

from ._util import axes, floating, keep_dims, moved_last

__all__ = ["var", "std", "median", "nanmedian", "quantile", "nanquantile",
           "histogram", "bincount", "corrcoef", "cov"]




def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(x, dim=axes(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(x, dim=axes(axis, x.dim()),
                     correction=1 if unbiased else 0, keepdim=keepdim)


def median(x, axis=None, keepdim=False, name=None):
    """The mean of the two middle values over ``axis`` (the middle value
    of an odd count), found by selection; NaN where a row holds one."""
    dims = axes(axis, x.dim())
    rows = moved_last(floating(x), dims)
    n = rows.shape[-1]
    lo = torch.kthvalue(rows, (n + 1) // 2, dim=-1).values
    hi = lo if n % 2 else torch.kthvalue(rows, n // 2 + 1, dim=-1).values
    mid = torch.where(torch.isnan(rows).any(-1), torch.nan, (lo + hi) / 2)
    return keep_dims(mid, x, dims, keepdim)


def nanmedian(x, axis=None, keepdim=False, name=None):
    """`median` of the values that are not NaN (NaN where none is)."""
    dims = axes(axis, x.dim())
    rows = moved_last(floating(x), dims)
    s = torch.sort(rows, dim=-1).values  # NaN sorts last
    n = (~torch.isnan(rows)).sum(-1, keepdim=True)
    lo = torch.clamp((n - 1) // 2, min=0)
    hi = torch.clamp(n // 2, max=rows.shape[-1] - 1)
    mid = ((torch.gather(s, -1, lo) + torch.gather(s, -1, hi)) / 2
           ).squeeze(-1)
    mid = torch.where(n.squeeze(-1) == 0, torch.nan, mid)
    return keep_dims(mid, x, dims, keepdim)


def _quantile(tfn, x, q, axis, keepdim):
    """``tfn`` (torch's quantile, which takes f32 and f64 only: half
    precision runs in f32 and is rounded back) over ``axis``."""
    dims = axes(axis, x.dim())
    rows = moved_last(floating(x), dims)
    dtype = rows.dtype
    if dtype not in (torch.float32, torch.float64):
        rows = rows.float()
    qt = torch.as_tensor(q, dtype=rows.dtype, device=rows.device)
    return keep_dims(tfn(rows, qt, dim=-1).to(dtype), x, dims, keepdim)


def quantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim)


def nanquantile(x, q, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim)


def histogram(input, bins=100, min=0, max=0, name=None):
    a = input.reshape(-1)
    if min == 0 and max == 0:
        lo, hi = a.min().item(), a.max().item()
    else:
        lo, hi = min, max
    edges = torch.linspace(float(lo), float(hi), bins + 1,
                           dtype=floating(a).dtype, device=a.device)
    i = torch.searchsorted(edges, a.to(edges.dtype), right=True)
    i = torch.where(a == edges[-1], bins, i)
    # bin 0 is below the range, bin bins + 1 above it
    return torch.bincount(i, minlength=bins + 2)[1:bins + 1]


def bincount(x, weights=None, minlength=0, name=None):
    out = torch.bincount(x, weights, minlength)
    return out if weights is None else out.to(weights.dtype)


def corrcoef(x, rowvar=True, name=None):
    return torch.corrcoef(x if rowvar or x.dim() < 2 else x.T)


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    if x.dim() == 2 and not rowvar:
        x = x.T
    return torch.cov(x, correction=1 if ddof else 0, fweights=fweights,
                     aweights=aweights)
