"""Sampled and tree-structured classification losses (counterpart:
paddle_tpu/nn/functional/sampling.py).

`nce` draws its negatives on the host with ``np.random.RandomState(seed
or None)``, as the JAX package does, so a nonzero ``seed`` draws the
same negatives in both packages and ``seed=0`` fresh ones each call.
`hsigmoid_loss` walks Paddle's SimpleCode paths (the default complete
binary tree) or a custom ``path_table``/``path_code``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["nce", "hsigmoid_loss", "hierarchical_sigmoid"]


def _log_uniform_probs(n):
    k = np.arange(n, dtype=np.float64)
    return ((np.log(k + 2) - np.log(k + 1)) / np.log(n + 1)).astype(
        np.float32)


def _host(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else \
        np.asarray(t)


def nce(input, label, weight, bias=None, num_total_classes=None,
        num_neg_samples=10, sampler="uniform", custom_dist=None,
        sample_weight=None, seed=0, name=None):
    """Noise-contrastive estimation, ``nce_op.h``'s math: for each sampled
    class ``c`` (the true ones, then ``num_neg_samples`` negatives drawn by
    ``sampler``), ``o = sigmoid(x . w_c + b_c)`` and ``q = P(c) * k``;
    the cost sums ``-log(o / (o + q))`` over true classes and ``-log(q /
    (o + q))`` over negatives.  Returns [B, 1]."""
    n_classes = int(num_total_classes if num_total_classes is not None
                    else weight.shape[0])
    lab = _host(label).reshape(input.shape[0], -1)
    num_true = lab.shape[1]
    k = int(num_neg_samples)
    rng = np.random.RandomState(seed or None)
    if sampler == "uniform":
        probs = np.full(n_classes, 1.0 / n_classes, np.float32)
        negs = rng.randint(0, n_classes, size=(lab.shape[0], k))
    elif sampler in ("log_uniform", "custom_dist"):
        probs = _log_uniform_probs(n_classes) if sampler == "log_uniform" \
            else np.asarray(custom_dist, np.float32)
        negs = rng.choice(n_classes, size=(lab.shape[0], k),
                          p=probs / probs.sum())
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    samples = np.concatenate([lab, negs], axis=1)
    dev = input.device
    q = torch.from_numpy(probs[samples] * k).to(dev)
    idx = torch.from_numpy(samples).long().to(dev)
    logits = torch.einsum("bd,btd->bt", input, weight[idx])
    if bias is not None:
        logits = logits + bias[idx]
    o = torch.sigmoid(logits)
    is_true = torch.arange(samples.shape[1], device=dev)[None, :] < num_true
    cost = torch.where(is_true, -torch.log(o / (o + q)),
                       -torch.log(q / (o + q)))
    return cost.sum(1, keepdim=True)


def _simple_code_table(num_classes):
    """SimpleCode paths of every class: ``c = label + num_classes``, step
    ``j`` uses weight row ``(c >> (j + 1)) - 1`` and bit ``(c >> j) & 1``,
    ``floor(log2(c))`` steps."""
    max_len = int(np.floor(np.log2(2 * num_classes - 1)))
    idx = np.zeros((num_classes, max_len), np.int64)
    bits = np.zeros((num_classes, max_len), np.float32)
    lens = np.zeros(num_classes, np.int64)
    for c in range(num_classes):
        code = c + num_classes
        n = int(np.floor(np.log2(code)))
        lens[c] = n
        for j in range(n):
            idx[c, j] = (code >> (j + 1)) - 1
            bits[c, j] = (code >> j) & 1
    return idx, bits, lens


def hsigmoid_loss(input, label, num_classes, weight, bias=None,
                  path_table=None, path_code=None, is_sparse=False,
                  name=None):
    """Hierarchical sigmoid, ``hierarchical_sigmoid_op.h``'s math: ``z_j =
    clip(x . w[idx_j] + b[idx_j], -40, 40)`` along the label's path (0 off
    it); the loss is ``sum_j softplus(z_j)`` over the whole code length
    minus ``sum_j bit_j z_j``.  Returns [B, 1]."""
    lab = _host(label).reshape(-1)
    if path_table is not None:
        idx = _host(path_table).astype(np.int64)[lab]
        bits = _host(path_code).astype(np.float32)[lab]
        lens = (idx >= 0).sum(axis=1)
        idx = np.maximum(idx, 0)
    else:
        t_idx, t_bits, t_lens = _simple_code_table(int(num_classes))
        code_length = int(np.floor(np.log2(num_classes - 1))) + 1 \
            if num_classes > 1 else 1
        idx = t_idx[lab][:, :code_length]
        bits = t_bits[lab][:, :code_length]
        lens = t_lens[lab]
    dev = input.device
    valid = torch.from_numpy((np.arange(idx.shape[1])[None, :]
                              < lens[:, None]).astype(np.float32)).to(dev)
    idx = torch.from_numpy(idx).to(dev)
    bits = torch.from_numpy(bits).to(dev)
    z = torch.einsum("bd,bjd->bj", input, weight[idx])
    if bias is not None:
        z = z + bias.reshape(-1)[idx]
    z = torch.clamp(z * valid, -40.0, 40.0)
    loss = torch.log1p(torch.exp(z)).sum(1) - (bits * z * valid).sum(1)
    return loss[:, None]


hierarchical_sigmoid = hsigmoid_loss
