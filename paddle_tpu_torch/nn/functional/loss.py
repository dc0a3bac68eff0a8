"""Loss functionals (counterpart: paddle_tpu/nn/functional/loss.py)."""
from __future__ import annotations

import torch

__all__ = ["cross_entropy"]


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True):
    """Softmax cross entropy against hard integer labels, as the JAX
    package computes it: gather-then-logsumexp.  The max shift runs in
    the logits' dtype (bf16 logits stay bf16), the ``exp`` sum in f32,
    and the picked logit comes from the raw logits in f32, so the
    ``[..., V]`` f32 log-probabilities are never built.  Rows labelled
    ``ignore_index`` count zero, and ``"mean"`` divides by the rows that
    are not ignored.  ``label`` has the logits' shape without ``axis``
    (or with it of size 1).  No AMP cast: the path handles half precision
    itself."""
    if soft_label or not use_softmax or weight is not None:
        raise NotImplementedError(
            "cross_entropy with soft labels, without softmax or with class "
            "weights is not ported yet: it lands with the op long-tail "
            "slice of paddle_tpu_torch (ROADMAP.md Queue 1, item 3)")
    li = label.long()
    if li.dim() == input.dim():
        li = li.squeeze(axis)
    mask = li != ignore_index
    # torch's gather raises on ignore_index; JAX's take ignores it, and the
    # row is masked out either way
    safe = torch.where(mask, li, 0).unsqueeze(axis)
    m = torch.amax(input, dim=axis, keepdim=True)
    lse = torch.log(torch.exp((input - m).float()).sum(dim=axis))
    picked = (torch.gather(input, axis, safe).float()
              - m.float()).squeeze(axis)
    loss = torch.where(mask, lse - picked, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.float().sum(), min=1.0)
    if reduction == "sum":
        return loss.sum()
    return loss
