"""Sequence ops (counterpart: paddle_tpu/ops/sequence.py), the LoD
family over the JAX package's ragged form: a padded ``[B, T, ...]``
batch with a ``[B]`` lengths tensor (`sequence_pad`/`sequence_unpad`
convert from and to the packed rows).

Torch ops on the inputs' device, differentiable in the data inputs by
torch's autograd (lengths, ids and indices are not).  Where the output's
size depends on the data (`sequence_mask` without ``maxlen``,
`sequence_pad`, `sequence_unpad`, `sequence_expand`,
`sequence_expand_as`), the lengths are read on the host, as there.
"""
from __future__ import annotations

import torch

from ._util import dt as _dt

__all__ = [
    "sequence_mask", "sequence_pad", "sequence_unpad", "sequence_pool",
    "sequence_reverse", "sequence_softmax", "sequence_expand",
    "sequence_first_step", "sequence_last_step", "sequence_concat",
    "sequence_expand_as", "sequence_enumerate", "sequence_erase",
    "sequence_reshape", "sequence_scatter", "sequence_slice",
    "sequence_topk_avg_pooling", "sequence_conv",
]


def _ar(n, like):
    return torch.arange(n, device=like.device)


def _bcast(mask, nd):
    """``mask`` [B, T] with ``nd - 2`` trailing unit axes."""
    return mask.reshape(mask.shape + (1,) * (nd - 2))


def sequence_mask(x, maxlen=None, dtype="int64", name=None):
    """Lengths [...] to a mask [..., maxlen] (``maxlen`` the longest
    length when not given)."""
    if maxlen is None:
        maxlen = int(x.max().item())
    out = _ar(maxlen, x)[None, :] < x.reshape(-1, 1)
    return out.reshape(tuple(x.shape) + (maxlen,)).to(_dt(dtype))


def sequence_pad(x, lengths, pad_value=0.0, maxlen=None, name=None):
    """Rows packed as [sum(L), ...] with ``lengths`` [B] to padded
    [B, maxlen, ...]; returns ``(padded, lengths)``."""
    if maxlen is None:
        maxlen = int(lengths.max().item())
    lv = lengths.to(x.device).long()
    starts = torch.cat([lv.new_zeros(1), torch.cumsum(lv, 0)[:-1]])
    pos = _ar(maxlen, x)[None, :]
    idx = (starts[:, None] + pos).clamp(0, x.shape[0] - 1)
    gathered = x[idx]
    valid = _bcast(pos < lv[:, None], x.dim() + 1)
    return torch.where(valid, gathered, pad_value), lengths


def sequence_unpad(x, length, name=None):
    """Padded [B, T, ...] with lengths to the packed [sum(L), ...] (the
    lengths are read on the host; the gather is differentiable)."""
    ln = [int(v) for v in length.reshape(-1).tolist()]
    t = x.shape[1]
    idx = torch.cat([i * t + torch.arange(n) for i, n in enumerate(ln)]) \
        if ln else torch.zeros(0, dtype=torch.long)
    return x.reshape((-1,) + tuple(x.shape[2:]))[idx.to(x.device)]


def sequence_pool(x, lengths, pool_type="sum", name=None):
    """Padded [B, T, ...] pooled over each row's valid steps: ``sum``,
    ``average``/``mean``, ``sqrt``, ``max`` (0 for an empty row),
    ``last``, ``first``."""
    pt = pool_type.lower()
    lv = lengths.to(x.device)
    t = x.shape[1]
    mask = _bcast(_ar(t, x)[None, :] < lv[:, None], x.dim())
    tail = (-1,) + (1,) * (x.dim() - 2)
    if pt == "sum":
        return (x * mask.to(x.dtype)).sum(1)
    if pt in ("average", "mean"):
        return (x * mask.to(x.dtype)).sum(1) / torch.clamp(
            lv.to(x.dtype), min=1).reshape(tail)
    if pt == "sqrt":
        return (x * mask.to(x.dtype)).sum(1) / torch.sqrt(torch.clamp(
            lv.to(x.dtype), min=1)).reshape(tail)
    if pt == "max":
        res = torch.where(mask, x, torch.finfo(x.dtype).min).amax(1)
        return torch.where((lv > 0).reshape(tail), res, 0.0)
    if pt == "last":
        idx = torch.clamp(lv.long() - 1, min=0)
        return x.gather(1, idx.reshape((-1, 1) + (1,) * (x.dim() - 2))
                        .expand((-1, 1) + tuple(x.shape[2:]))).squeeze(1)
    if pt == "first":
        return x[:, 0]
    raise ValueError(f"unknown pool_type {pool_type}")


def sequence_first_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "first")


def sequence_last_step(x, lengths, name=None):
    return sequence_pool(x, lengths, "last")


def _take_steps(x, idx):
    """``x`` [B, T, ...] at step indices ``idx`` [B, T'] a row."""
    idx = idx.reshape(idx.shape + (1,) * (x.dim() - 2)).expand(
        tuple(idx.shape) + tuple(x.shape[2:]))
    return x.gather(1, idx)


def sequence_reverse(x, lengths, name=None):
    """Each row reversed within its length; padding stays."""
    lv = lengths.to(x.device).long()
    pos = _ar(x.shape[1], x)[None, :]
    idx = torch.where(pos < lv[:, None], lv[:, None] - 1 - pos, pos)
    return _take_steps(x, idx)


def sequence_softmax(x, lengths, name=None):
    """Softmax over each row's valid steps; 0 past its length."""
    lv = lengths.to(x.device)
    mask = _bcast(_ar(x.shape[1], x)[None, :] < lv[:, None], x.dim())
    z = torch.where(mask, x, torch.finfo(x.dtype).min)
    return torch.where(mask, torch.softmax(z, dim=1), 0.0)


def sequence_expand(x, repeat_times, name=None):
    """Row i of ``x`` repeated ``repeat_times[i]`` times (counts read on
    the host)."""
    reps = torch.as_tensor(repeat_times.tolist() if isinstance(
        repeat_times, torch.Tensor) else list(repeat_times),
        dtype=torch.long)
    return torch.repeat_interleave(x, reps.to(x.device), dim=0,
                                   output_size=int(reps.sum()))


def sequence_concat(xs, lengths_list, name=None):
    """The i-th rows of every input back to back: inputs [B, Ti, ...]
    with lengths [B]; returns ``([B, sum(Ti), ...], lengths [B])``,
    zero-padded after each row's valid parts."""
    b = xs[0].shape[0]
    feat = tuple(xs[0].shape[2:])
    t_out = sum(x.shape[1] for x in xs)
    out = xs[0].new_zeros((b, t_out) + feat)
    tpos = _ar(t_out, xs[0])
    offset = torch.zeros(b, dtype=torch.long, device=xs[0].device)
    for xv, lv in zip(xs, lengths_list):
        lv = lv.to(xv.device).long()
        src = tpos[None, :] - offset[:, None]
        valid = (src >= 0) & (src < lv[:, None])
        g = _take_steps(xv, src.clamp(0, xv.shape[1] - 1))
        out = torch.where(_bcast(valid, len(feat) + 2), g, out)
        offset = offset + lv
    return out, offset


def sequence_expand_as(x, y_lengths, name=None):
    """Row b of ``x`` (one step) repeated ``y_lengths[b]`` times: padded
    [B, max(y_lengths), ...], zeros past each length."""
    maxlen = int(y_lengths.max().item())
    lv = y_lengths.to(x.device)
    rep = x[:, None].expand((x.shape[0], maxlen) + tuple(x.shape[1:]))
    mask = _ar(maxlen, x)[None, :] < lv[:, None]
    return torch.where(_bcast(mask, rep.dim()), rep, 0.0)


def sequence_enumerate(x, lengths, win_size, pad_value=0, name=None):
    """[B, T] ids to sliding windows [B, T, win_size]; positions past a
    row's length (or past T) hold ``pad_value``."""
    b, t = x.shape
    lv = lengths.to(x.device)
    base = _ar(t, x)[:, None] + _ar(win_size, x)[None, :]
    win = torch.where(base < t, x[:, base.clamp(0, t - 1)], pad_value)
    return torch.where(base[None] < lv[:, None, None], win, pad_value)


def sequence_erase(x, lengths, tokens, name=None):
    """Each row of ids without ``tokens``, compacted to the left;
    returns ``(ids, new_lengths)``."""
    b, t = x.shape
    toks = torch.as_tensor(list(tokens), dtype=x.dtype, device=x.device)
    pos = _ar(t, x)[None, :]
    keep = ~torch.isin(x, toks) & (pos < lengths.to(x.device)[:, None])
    key = torch.where(keep, pos, t + pos)
    packed = x.gather(1, torch.argsort(key, dim=1))
    new_len = keep.sum(1)
    return torch.where(pos < new_len[:, None], packed, 0), new_len.long()


def sequence_reshape(x, lengths, new_dim, name=None):
    """Each row's valid payload re-cut to ``new_dim`` columns; returns
    ``(out, new_lengths)``."""
    b, t, d = x.shape
    t2 = t * d // new_dim
    out = x.reshape(b, t2, new_dim)
    new_len = (lengths.to(x.device).long() * d) // new_dim
    mask = _ar(t2, x)[None, :] < new_len[:, None]
    return torch.where(mask[:, :, None], out, 0.0), new_len


def sequence_scatter(x, index, updates, index_lengths, name=None):
    """``x[b, index[b, j]] += updates[b, j]`` for ``j <
    index_lengths[b]``."""
    b, k = index.shape
    valid = _ar(k, x)[None, :] < index_lengths.to(x.device)[:, None]
    contrib = torch.where(valid[..., None] if updates.dim() == 3 else
                          valid, updates, 0.0).to(x.dtype)
    bidx = _ar(b, x)[:, None].expand(b, k)
    return torch.index_put(x, (bidx, index.to(x.device).long()), contrib,
                           accumulate=True)


def sequence_slice(x, lengths, offset, length, name=None):
    """Row b's steps ``[offset[b], offset[b] + length[b])``, padded to
    T; returns ``(out, length)``."""
    b, t = x.shape[:2]
    pos = _ar(t, x)[None, :]
    src = (pos + offset.to(x.device).long()[:, None]).clamp(0, t - 1)
    ln = length.to(x.device).long()
    g = _take_steps(x, src)
    return torch.where(_bcast(pos < ln[:, None], x.dim()), g, 0.0), ln


def sequence_topk_avg_pooling(x, row_lengths, col_lengths, topks,
                              channel_num=1, name=None):
    """For each (batch, channel, row) the mean of the top k values among
    the valid columns, for every k of ``topks``: x [B, C, R, W] padded to
    [B, R, C * len(topks)]."""
    ks = list(topks)
    b, c, r, w = x.shape
    cl = col_lengths.to(x.device).long()
    colmask = _ar(w, x)[None, :] < cl[:, None]
    masked = torch.where(colmask[:, None, None, :], x, -torch.inf)
    top = torch.topk(masked, min(max(ks), w), dim=-1).values
    finite = torch.where(torch.isfinite(top), top, 0.0)
    slot = _ar(top.shape[-1], x)[None, None, None, :]
    outs = []
    for k in ks:
        kk = torch.clamp(cl, max=k)
        vals = torch.where(slot < kk[:, None, None, None], finite, 0.0)
        outs.append(vals.sum(-1) / torch.clamp(kk, min=1).to(
            x.dtype)[:, None, None])
    out = torch.stack(outs, dim=-1)
    rowmask = _ar(r, x)[None, :] < row_lengths.to(x.device)[:, None]
    out = torch.where(rowmask[:, None, :, None], out, 0.0)
    return out.permute(0, 2, 1, 3).reshape(b, r, -1)


def sequence_conv(x, lengths, weight, bias=None, context_length=3,
                  context_start=None, padding_data=None, name=None):
    """Context-window convolution: each step's window
    ``[t + start, t + start + context_length)`` flattened and projected
    by ``weight`` [context_length * D, M]; context outside the sequence
    is zero, or a row of the trainable ``padding_data``
    [up_pad + down_pad, D]."""
    start = -((context_length - 1) // 2) if context_start is None \
        else context_start
    up_pad = max(0, -start)
    down_pad = max(0, start + context_length - 1)
    b, t, d = x.shape
    lv = lengths.to(x.device).long()
    offs = _ar(context_length, x) + start
    pos = _ar(t, x)[:, None] + offs[None, :]                # [T, ctx]
    valid = (pos >= 0) & (pos < lv[:, None, None])          # [B, T, ctx]
    g = x[:, pos.clamp(0, t - 1), :]                        # [B, T, ctx, D]
    if padding_data is not None and up_pad + down_pad > 0:
        pad_row = torch.where(pos[None] < 0, up_pad + pos[None],
                              up_pad + pos[None] - lv[:, None, None])
        pad_row = pad_row.clamp(0, up_pad + down_pad - 1)
        g = torch.where(valid[..., None], g, padding_data[pad_row])
    else:
        g = torch.where(valid[..., None], g, 0.0)
    out = g.reshape(b, t, context_length * d) @ weight
    if bias is not None:
        out = out + bias
    mask = _ar(t, x)[None, :] < lv[:, None]
    return torch.where(mask[..., None], out, 0.0)
