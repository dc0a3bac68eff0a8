"""Loss layers (counterpart: paddle_tpu/nn/layer/loss.py): each calls the
functional of its name with the arguments it was built with."""
from __future__ import annotations

import math

import torch

from .. import functional as F
from .layers import Layer

__all__ = ["CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss",
           "NLLLoss", "BCELoss", "BCEWithLogitsLoss", "KLDivLoss",
           "MarginRankingLoss", "HingeEmbeddingLoss", "CosineEmbeddingLoss",
           "TripletMarginLoss", "CTCLoss", "HSigmoidLoss"]


class _Loss(Layer):
    """``functional.<_fn>(*inputs, **kwargs)`` with the keyword arguments
    the layer was built with."""
    _fn = None

    def __init__(self, **kw):
        super().__init__()
        kw.pop("name", None)
        self._kw = kw

    def forward(self, *inputs):
        return getattr(F, self._fn)(*inputs, **self._kw)


class CrossEntropyLoss(_Loss):
    _fn = "cross_entropy"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 soft_label=False, axis=-1, use_softmax=True, name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction, soft_label=soft_label,
                         axis=axis, use_softmax=use_softmax)


class MSELoss(_Loss):
    _fn = "mse_loss"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class L1Loss(_Loss):
    _fn = "l1_loss"

    def __init__(self, reduction="mean", name=None):
        super().__init__(reduction=reduction)


class SmoothL1Loss(_Loss):
    _fn = "smooth_l1_loss"

    def __init__(self, reduction="mean", delta=1.0, name=None):
        super().__init__(reduction=reduction, delta=delta)


class NLLLoss(_Loss):
    _fn = "nll_loss"

    def __init__(self, weight=None, ignore_index=-100, reduction="mean",
                 name=None):
        super().__init__(weight=weight, ignore_index=ignore_index,
                         reduction=reduction)


class BCELoss(_Loss):
    _fn = "binary_cross_entropy"

    def __init__(self, weight=None, reduction="mean", name=None):
        super().__init__(weight=weight, reduction=reduction)


class BCEWithLogitsLoss(_Loss):
    _fn = "binary_cross_entropy_with_logits"

    def __init__(self, weight=None, reduction="mean", pos_weight=None,
                 name=None):
        super().__init__(weight=weight, reduction=reduction,
                         pos_weight=pos_weight)


class KLDivLoss(_Loss):
    _fn = "kl_div"

    def __init__(self, reduction="mean"):
        super().__init__(reduction=reduction)


class MarginRankingLoss(_Loss):
    _fn = "margin_ranking_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class HingeEmbeddingLoss(_Loss):
    _fn = "hinge_embedding_loss"

    def __init__(self, margin=1.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class CosineEmbeddingLoss(_Loss):
    _fn = "cosine_embedding_loss"

    def __init__(self, margin=0.0, reduction="mean", name=None):
        super().__init__(margin=margin, reduction=reduction)


class TripletMarginLoss(_Loss):
    _fn = "triplet_margin_loss"

    def __init__(self, margin=1.0, p=2.0, epsilon=1e-6, swap=False,
                 reduction="mean", name=None):
        super().__init__(margin=margin, p=p, epsilon=epsilon, swap=swap,
                         reduction=reduction)


class CTCLoss(Layer):
    def __init__(self, blank=0, reduction="mean"):
        super().__init__()
        self.blank = blank
        self.reduction = reduction

    def forward(self, log_probs, labels, input_lengths, label_lengths,
                norm_by_times=False):
        return F.ctc_loss(log_probs, labels, input_lengths, label_lengths,
                          self.blank, self.reduction, norm_by_times)


class HSigmoidLoss(Layer):
    """Hierarchical sigmoid over the default complete binary tree: class
    ``y`` is leaf ``y + num_classes`` of a heap-ordered tree, and the loss
    sums, along its path to the root, the logistic loss of each internal
    node (``weight`` [num_classes - 1, feature_size], ``bias``
    [num_classes - 1]) deciding right (1) or left (0); the mean over the
    batch.  ``path_table``/``path_code`` (custom trees) are taken and not
    read, as in the JAX package."""

    def __init__(self, feature_size, num_classes, weight_attr=None,
                 bias_attr=None, is_custom=False, is_sparse=False,
                 name=None, device=None, dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.code_length = int(math.ceil(math.log2(num_classes)))
        self.weight = self.create_parameter(
            [num_classes - 1, feature_size], attr=weight_attr, dtype=dtype,
            device=device)
        self.bias = self.create_parameter(
            [num_classes - 1], attr=bias_attr, dtype=dtype, is_bias=True,
            device=device)

    def forward(self, input, label, path_table=None, path_code=None):
        code = label.reshape(-1).long() + self.num_classes
        losses = 0.0
        for _ in range(self.code_length):
            parent = code // 2
            bit = (code % 2).to(input.dtype)
            node = torch.clamp(parent - 1, 0, self.num_classes - 2)
            logit = torch.sum(input * self.weight[node], -1) + \
                self.bias[node]
            zero = logit.new_zeros(())
            lo = bit * torch.logaddexp(zero, -logit) + \
                (1 - bit) * torch.logaddexp(zero, logit)
            losses = losses + torch.where(parent >= 1, lo, 0.0)
            code = parent
        return torch.mean(losses)
