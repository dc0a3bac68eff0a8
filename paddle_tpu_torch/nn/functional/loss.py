"""Loss functionals (counterpart: paddle_tpu/nn/functional/loss.py).

Each keeps the JAX package's formula and reduction.  ``cross_entropy``:
hard labels through softmax are gather-then-logsumexp in the logits'
dtype with f32 sums and no AMP cast; soft labels (``-sum(label *
log_softmax)``) and ``use_softmax=False`` (the input is probabilities:
a log clamped at 1e-30) are BLACK.  Class weights scale each hard-label
row (of ``cross_entropy`` and ``nll_loss``), and ``"mean"`` then divides
by the summed weights of the rows not ignored; like
``binary_cross_entropy_with_logits``' ``pos_weight`` they are constants,
outside autograd, as in the JAX package.  ``ctc_loss`` takes
unnormalised log-probabilities ``[T, B, C]``, normalises them and runs
``torch.nn.functional.ctc_loss``; its ``"mean"`` divides each loss by
its label length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as TF

from ... import amp

__all__ = ["cross_entropy", "softmax_with_cross_entropy", "mse_loss",
           "square_error_cost", "l1_loss", "smooth_l1_loss", "huber_loss",
           "nll_loss", "binary_cross_entropy",
           "binary_cross_entropy_with_logits", "sigmoid_focal_loss",
           "kl_div", "margin_ranking_loss", "hinge_embedding_loss",
           "cosine_embedding_loss", "triplet_margin_loss", "log_loss",
           "npair_loss", "ctc_loss"]


def _reduce(out, reduction):
    if reduction == "mean":
        return torch.mean(out)
    if reduction == "sum":
        return torch.sum(out)
    return out


def _weighted(loss, li, mask, weight, reduction):
    """Hard-label rows: times their class weight, ignored rows zero;
    ``"mean"`` over the live rows (their summed weights, with weights)."""
    if weight is not None:
        cw = weight.detach()[torch.where(mask, li, 0)]
        loss = loss * cw
        if reduction == "mean":
            return torch.where(mask, loss, 0.0).sum() / torch.clamp(
                torch.where(mask, cw, 0.0).sum(), min=1e-12)
    loss = torch.where(mask, loss, 0.0)
    if reduction == "mean":
        return loss.sum() / torch.clamp(mask.float().sum(), min=1.0)
    return _reduce(loss, reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, name=None):
    """Softmax cross entropy.  Hard integer labels through softmax (the
    training path) as the JAX package computes them: gather-then-
    logsumexp, the max shift in the logits' dtype (bf16 logits stay
    bf16), the ``exp`` sum in f32, the picked logit from the raw logits
    in f32, so the ``[..., V]`` f32 log-probabilities are never built.
    Rows labelled ``ignore_index`` count zero.  ``label`` has the logits'
    shape without ``axis`` (or with it of size 1), or with soft labels
    the logits' shape."""
    if soft_label or not use_softmax:
        input, label = amp.cast_inputs(amp.BLACK, input, label)
        logp = torch.log_softmax(input.float(), axis) if use_softmax else \
            torch.log(torch.clamp(input.float(), min=1e-30))
    if soft_label:
        return _reduce(-torch.sum(label * logp, axis), reduction)
    li = label.long()
    if li.dim() == input.dim():
        li = li.squeeze(axis)
    mask = li != ignore_index
    # torch's gather raises on ignore_index; JAX's take ignores it, and the
    # row is masked out either way
    safe = torch.where(mask, li, 0).unsqueeze(axis)
    if use_softmax:
        m = torch.amax(input, dim=axis, keepdim=True)
        lse = torch.log(torch.exp((input - m).float()).sum(dim=axis))
        picked = (torch.gather(input, axis, safe).float()
                  - m.float()).squeeze(axis)
        loss = lse - picked
    else:
        loss = -torch.gather(logp, axis, safe).squeeze(axis)
    return _weighted(loss, li, mask, weight, reduction)


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1, name=None):
    loss = cross_entropy(logits, label, soft_label=soft_label,
                         ignore_index=ignore_index, reduction="none",
                         axis=axis)
    if return_softmax:
        from .activation import softmax

        return loss, softmax(logits, axis=axis)
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def square_error_cost(input, label, name=None):
    return torch.square(input - label)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = input - label
    loss = torch.where(torch.abs(d) < delta, 0.5 * d * d / delta,
                       torch.abs(d) - 0.5 * delta) * delta
    return _reduce(loss, reduction)


def huber_loss(input, label, delta=1.0, name=None):
    d = input - label
    return torch.where(torch.abs(d) <= delta, 0.5 * d * d,
                       delta * (torch.abs(d) - 0.5 * delta))


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[label]`` along the class axis (1, or 0 for one row)."""
    li = label.long()
    mask = li != ignore_index
    axis = 1 if input.dim() > 1 else 0
    safe = torch.where(mask, li, 0)
    loss = -torch.gather(input, axis, safe.unsqueeze(axis)).squeeze(axis)
    return _weighted(loss, li, mask, weight, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    p = torch.clamp(input, 1e-12, 1 - 1e-12)
    loss = -(label * torch.log(p) + (1 - label) * torch.log(1 - p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    logp, lognp = TF.logsigmoid(logit), TF.logsigmoid(-logit)
    if pos_weight is not None:
        loss = -(pos_weight.detach() * label * logp + (1 - label) * lognp)
    else:
        loss = -(label * logp + (1 - label) * lognp)
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = -(label * TF.logsigmoid(logit) + (1 - label) * TF.logsigmoid(-logit))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return torch.sum(loss) / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    loss = torch.where(label == 1, input,
                       torch.clamp(margin - input, min=0.0))
    return _reduce(loss, reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    cos = torch.sum(input1 * input2, -1) / (
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
    loss = torch.where(label == 1, 1 - cos,
                       torch.clamp(cos - margin, min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-06, swap=False, reduction="mean",
                        name=None):
    def distance(a, b):
        return torch.sum(torch.abs(a - b) ** p, -1) ** (1 / p)

    dn = distance(input, negative)
    if swap:
        dn = torch.minimum(dn, distance(positive, negative))
    return _reduce(torch.clamp(distance(input, positive) - dn + margin,
                               min=0.0), reduction)


def log_loss(input, label, epsilon=0.0001, name=None):
    return -label * torch.log(input + epsilon) - (1 - label) * torch.log(
        1 - input + epsilon)


def npair_loss(anchor, positive, labels, l2_reg=0.002, name=None):
    sim = anchor @ positive.T
    batch = labels.reshape(-1, 1)
    target = (batch == batch.T).float()
    target = target / torch.sum(target, 1, keepdim=True)
    ce = torch.mean(-torch.sum(target * torch.log_softmax(sim, 1), 1))
    reg = l2_reg * (torch.mean(torch.sum(anchor * anchor, 1))
                    + torch.mean(torch.sum(positive * positive, 1))) * 0.25
    return ce + reg


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False, name=None):
    """CTC over ``log_probs`` [T, B, C] (log-softmaxed here first) and
    padded ``labels`` [B, S]; ``norm_by_times`` is taken and not read, as
    in the JAX package."""
    lp = torch.log_softmax(log_probs.float(), -1)
    label_lengths = label_lengths.long()
    loss = TF.ctc_loss(lp, labels.long(), input_lengths.long(),
                       label_lengths, blank=blank, reduction="none")
    if reduction == "mean":
        return torch.mean(loss / torch.clamp(label_lengths, min=1))
    return _reduce(loss, reduction)
