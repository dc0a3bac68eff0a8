"""Linear-chain CRF (counterpart: paddle_tpu/ops/crf.py).

Padded ``[B, T, N]`` emissions with ``[B]`` lengths, a ``[N + 2, N]``
transition (row 0 the start weights, row 1 the end weights, rows 2 on the
N x N transitions).  The time recursion is a loop of T - 1 batched steps
on the emissions' device, masked past each sequence's end, as the JAX
package's ``lax.scan``; `linear_chain_crf` is differentiable through the
forward algorithm to the emissions and the transition by torch's
autograd.  Emissions are computed in f32.  Viterbi ties go to the lowest
tag index, as ``jnp.argmax``.
"""
from __future__ import annotations

import torch

__all__ = ["linear_chain_crf", "crf_decoding"]


def linear_chain_crf(emission, transition, label, length, name=None):
    """The negative log-likelihood of each sequence's gold path, [B, 1]:
    ``logZ - score`` (minimised to train).  ``label`` [B, T] and
    ``length`` [B] are integers and not differentiated."""
    em = emission.float()
    b, t, n = em.shape
    start, end, w = transition[0], transition[1], transition[2:]
    lab = label.long()
    ln = length.to(em.device).long()
    alpha = start[None, :] + em[:, 0, :]
    for i in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + w[None, :, :], dim=1) \
            + em[:, i, :]
        alpha = torch.where((ln > i)[:, None], nxt, alpha)
    logz = torch.logsumexp(alpha + end[None, :], dim=-1)

    pos = torch.arange(t, device=em.device)[None, :]
    valid = pos < ln[:, None]
    zero = em.new_zeros(())
    em_score = torch.where(valid, em.gather(2, lab[:, :, None])[:, :, 0],
                           zero).sum(-1)
    trans_valid = pos[:, 1:] < ln[:, None]
    trans_score = torch.where(trans_valid, w[lab[:, :-1], lab[:, 1:]],
                              zero).sum(-1)
    last = lab.gather(1, torch.clamp(ln - 1, min=0)[:, None])[:, 0]
    score = em_score + trans_score + start[lab[:, 0]] + end[last]
    return (logz - score)[:, None]


@torch.no_grad()
def crf_decoding(emission, transition, label=None, length=None, name=None):
    """The Viterbi path [B, T] int64 (zeros past each length); with
    ``label``, 1 where the path's tag equals the label (within length),
    else 0."""
    em = emission.float()
    b, t, n = em.shape
    dev = em.device
    start, end, w = transition[0], transition[1], transition[2:]
    ln = length.to(dev).long() if length is not None else \
        torch.full((b,), t, dtype=torch.long, device=dev)
    ident = torch.arange(n, device=dev)[None, :]
    alpha = start[None, :] + em[:, 0, :]
    bps = []
    for i in range(1, t):
        scores = alpha[:, :, None] + w[None, :, :]          # [B, N, N]
        best_prev = torch.argmax(scores, dim=1)             # [B, N]
        nxt = scores.amax(dim=1) + em[:, i, :]
        active = (ln > i)[:, None]
        alpha = torch.where(active, nxt, alpha)
        # inactive steps point back to themselves
        bps.append(torch.where(active, best_prev, ident))
    tag = torch.argmax(alpha + end[None, :], dim=-1)        # [B]
    tags = [tag]
    for bp in reversed(bps):
        tag = bp.gather(1, tag[:, None])[:, 0]
        tags.append(tag)
    path = torch.stack(tags[::-1], dim=1)
    valid = torch.arange(t, device=dev)[None, :] < ln[:, None]
    path = torch.where(valid, path, 0).long()
    if label is not None:
        return torch.where(valid, (label.long() == path).long(), 0)
    return path
